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
from ntjoin_tpu_torch.utils import timers


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
    with timers.recording(True):
        h, v = sc.hash_chunked_ref(torch.from_numpy(x), k)
        assert torch.equal(h, sc.from_jax_chunks(lo, hi))
        assert np.array_equal(v.numpy(), np.asarray(val).reshape(rows, -1))
        counts = timers.trace_counts()["counters"]
    assert counts["launch:hash_plain"] == 1 and "launch:hash" not in counts


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
    with timers.recording(True):
        h, val = sc.hash_chunked(torch.from_numpy(flat), L, C, rows, k)
        counts = timers.trace_counts()["counters"]
    assert counts["launch:hash_plain"] == 1 and "launch:hash" not in counts
    assert tuple(h.shape) == (rows, C) and h.dtype == torch.int64
    canon, valid = canonical_hashes(flat.view(np.uint8), k)
    start = np.arange(C)[None, :] * L + np.arange(rows)[:, None] - (k - 1)
    live = np.broadcast_to(np.arange(rows)[:, None] >= k - 1, start.shape)
    assert (val.numpy()[~live] == 0).all()
    s = start[live]
    assert np.array_equal(val.numpy()[live].astype(bool), valid[s])
    ok = valid[s]
    assert (h.numpy().view(np.uint64)[live][ok] == canon[s][ok]).all()


_M64 = (1 << 64) - 1


def _srol1(x):
    x = x.astype(np.uint64)
    one, m = np.uint64(1), np.uint64(0xFFFFFFFDFFFFFFFF)
    return ((x << one) & m) | ((x >> np.uint64(63)) << np.uint64(33)) | ((x >> np.uint64(32)) & one)


def _sror1(x):
    x = x.astype(np.uint64)
    one = np.uint64(1)
    keep = np.uint64(_M64 ^ ((1 << 32) | (1 << 63)))
    return (((x >> one) & keep) | ((x & one) << np.uint64(32))
            | ((x & (one << np.uint64(33))) << np.uint64(30)))


def _segmented_walk(x, k, seg):
    """Kernel 1's walk, all chunks of a row at once: every segment of
    ``seg`` rows restarts k - 1 rows early from a zero state, takes the
    outgoing base for invalid during its first k steps, stores from its own
    first row on; the seed terms come from the table of (out, in) pairs."""
    rows, C = x.shape
    t = sc.seed_tables(k).view(np.uint64)
    zero = np.zeros(1, np.uint64)
    t_in, t_out, t_rc_out, t_rc_in = (np.concatenate([row, zero]) for row in t)
    pair_f = t_out[:, None] ^ t_in[None, :]  # [out, in]
    pair_r = t_rc_out[:, None] ^ t_rc_in[None, :]
    code = np.minimum(x.view(np.uint8), 4).astype(np.int64)
    h = np.zeros((rows, C), np.uint64)
    val = np.zeros((rows, C), np.int8)
    for first in range(0, rows, seg):
        start = max(first - (k - 1), 0)
        f = np.zeros(C, np.uint64)
        r = np.zeros(C, np.uint64)
        last_bad = np.full(C, start - 1)
        for i in range(start, min(first + seg, rows)):
            cin = code[i]
            cout = code[i - k] if i - start >= k else np.full(C, 4)
            f = _srol1(f) ^ pair_f[cout, cin]
            r = _sror1(r) ^ pair_r[cout, cin]
            last_bad = np.where(cin == 4, i, last_bad)
            if i >= first:
                h[i] = f + r
                val[i] = i - last_bad >= k
    return h, val


@pytest.mark.parametrize("seg", ["k-1", 7, 40, 257])  # 7: segment starts below k - 1
@pytest.mark.parametrize("k", [15, 32])
def test_segmented_walk_matches_plain_and_oracle(k, seg):
    """The algebra of kernel 1's design (a thread per segment of a chunk,
    each rebuilding the state from k - 1 warm-up rows) against the plain
    version and the NumPy oracle: hashes and valid flags, bit for bit."""
    seg = k - 1 if seg == "k-1" else seg
    rng = np.random.default_rng(100 * k + seg)
    rows, C = 600, 12
    x = rng.integers(0, 4, size=(rows, C)).astype(np.int8)
    s2 = 2 * seg  # first row of the third segment
    x[s2 - 2 : s2 + 3, 1] = 4            # an N run straddling a segment start
    x[max(s2 - k + 3, 0) : max(s2 - k + 5, 2), 2] = 4  # one inside a segment's warm-up
    x[0:3, 3] = 4                        # at the chunk's start
    x[s2 - 1, 4] = -1                    # any code >= 4 (as a byte) is invalid
    x[s2, 5] = 4                         # a segment's first own row
    x[:, 6] = 4
    x[rng.integers(0, rows, size=40), rng.integers(7, C, size=40)] = 4
    h, val = _segmented_walk(x, k, seg)
    h_ref, val_ref = sc.hash_chunked_ref(torch.from_numpy(x), k)
    assert np.array_equal(h, h_ref.numpy().view(np.uint64))
    assert np.array_equal(val, val_ref.numpy())
    for c in range(C):
        canon, valid = canonical_hashes(np.minimum(x[:, c].view(np.uint8), 4), k)
        assert np.array_equal(val[k - 1 :, c].astype(bool), valid)
        assert (val[: k - 1, c] == 0).all()
        assert np.array_equal(h[k - 1 :, c][valid], canon[valid])


def test_wrapper_refuses_other_devices():
    flat = torch.zeros(64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        sc.hash_chunked(flat, 8, 4, 20, 5)
