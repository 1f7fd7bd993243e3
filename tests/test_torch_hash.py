"""Op 1 (rolling hash) of the port against the JAX package's Pallas hash
kernel in interpret mode and the NumPy oracle.  Integer outputs: the
comparisons are bit-exact (tolerance zero)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.ops.nthash_np import canonical_hashes
from ntjoin_tpu.ops.sketch_pallas import _CHUNKS, _LANE, _SUB, _hash_chunked
from ntjoin_tpu_torch.ops import sketch_cuda as sc


@pytest.mark.parametrize("k", [15, 32])
def test_hash_ref_matches_pallas_kernel(k):
    rng = np.random.default_rng(k)
    rows = 256  # two of the kernel's 128-row grid steps: the carry crosses one
    x = rng.integers(0, 4, size=(rows, _CHUNKS)).astype(np.int8)
    x[0:3, 5] = 4
    x[100:140, 7] = 4
    x[126:130, :64] = 4  # a run across the grid-step seam
    x[:, 9] = 4
    x[200, 11] = 4
    lag = np.full_like(x, 4)
    lag[k:] = x[:-k]
    shape = (rows, _SUB, _LANE)
    lo, hi, val = _hash_chunked(jnp.asarray(x.reshape(shape)), jnp.asarray(lag.reshape(shape)),
                                k, interpret=True)
    sc.reset_counts()
    h, v = sc.hash_chunked_ref(torch.from_numpy(x), k)
    assert torch.equal(h, sc.from_jax_chunks(lo, hi))
    assert np.array_equal(v.numpy(), np.asarray(val).reshape(rows, -1))
    assert sc.COUNTS["hash_plain"] == 1 and sc.COUNTS["hash"] == 0


@pytest.mark.parametrize("k,w", [(21, 16), (32, 100)])
def test_hash_chunked_matches_oracle(k, w):
    """The wrapper on a CPU stream: chunk c, row r >= k-1 is the k-mer ending
    at flat position c*L + r, as ``canonical_hashes`` sees it; the first k-1
    rows of a chunk are warm-up and invalid."""
    rng = np.random.default_rng(w)
    n = 50_000
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    codes[[0, 17, 4000]] = 4
    codes[9000:9300] = 4
    C, L = sc.layout(n, k, w)
    rows = L + w + k - 2
    flat = np.full(C * L + w + k - 2, 4, dtype=np.int8)
    flat[:n] = codes
    sc.reset_counts()
    h, val = sc.hash_chunked(torch.from_numpy(flat), L, C, rows, k)
    assert sc.COUNTS["hash_plain"] == 1 and sc.COUNTS["hash"] == 0
    assert tuple(h.shape) == (rows, C) and h.dtype == torch.int64
    canon, valid = canonical_hashes(flat.view(np.uint8), k)
    start = np.arange(C)[None, :] * L + np.arange(rows)[:, None] - (k - 1)
    live = np.broadcast_to(np.arange(rows)[:, None] >= k - 1, start.shape)
    assert (val.numpy()[~live] == 0).all()
    s = start[live]
    assert np.array_equal(val.numpy()[live].astype(bool), valid[s])
    ok = valid[s]
    assert (h.numpy().view(np.uint64)[live][ok] == canon[s][ok]).all()


def test_wrapper_refuses_other_devices():
    flat = torch.zeros(64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        sc.hash_chunked(flat, 8, 4, 20, 5)
