"""The port's batched Mann-Kendall op (``ops/mannkendall.py``, torch on the
CPU) against the JAX package's ``mk_s_batch`` / ``mann_kendall_batch`` (CPU
backend) and the scalar test, and the batched orientation branch against
the JAX package's and the scalar route.  S is an integer: exact; p and z of
``mann_kendall_batch`` are float32 in the original and float64 in the port,
so they agree within float32 rounding (relative 1e-5), and with the scalar
test's float64 within 1e-12."""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.core import orientation as jax_orientation
from ntjoin_tpu.ops import mannkendall as jax_mk
from ntjoin_tpu_torch.core import orientation
from ntjoin_tpu_torch.ops import mannkendall as mk


def _batch(seed: int, b: int = 40, n: int = 96):
    """Padded rows of mixed length (1, 2 and 3 among them), mostly rising
    with swaps, many ties (values from a small range); padding holds
    garbage."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, 60, size=(b, n)), axis=1)
    swap = rng.random((b, n)) < 0.3
    pos[swap] = rng.integers(0, 60, size=int(swap.sum()))
    pos[::5] = pos[::5, ::-1]
    lengths = rng.integers(1, n + 1, size=b)
    lengths[:4] = [1, 2, 3, n]
    return pos.astype(np.int64), lengths.astype(np.int64)


@pytest.mark.parametrize("seed,block", [(1, None), (2, 7), (3, 1), (4, 5000)])
def test_mk_s_batch_matches_jax(seed, block, monkeypatch):
    pos, lengths = _batch(seed)
    if block is not None:  # rows of i per block, through the byte budget
        monkeypatch.setattr(mk, "BLOCK_BYTES", block * pos.size)
    want = np.asarray(jax_mk.mk_s_batch(jnp.asarray(pos.astype(np.int32)),
                                        jnp.asarray(lengths.astype(np.int32))))
    mk.reset_counts()
    got = mk.mk_s_batch(torch.from_numpy(pos), torch.from_numpy(lengths))
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert mk.COUNTS == {"mk_batches": 1, "mk_runs": pos.shape[0], "device": "cpu"}


def _s_by_insertion(x: list[int]) -> int:
    """S counted another way: for each element, the earlier ones below it
    less those above it."""
    seen: list[int] = []
    s = 0
    for v in x:
        lo, hi = bisect.bisect_left(seen, v), bisect.bisect_right(seen, v)
        s += lo - (len(seen) - hi)
        seen.insert(hi, v)
    return s


def test_mk_s_beyond_the_int32_bound():
    """A run longer than the JAX op's 65,536-element bound: int64 S equals
    the count of concordant less discordant pairs, which passes 2^31."""
    rng = np.random.default_rng(11)
    n = 68_000
    x = np.sort(rng.integers(0, 10**7, size=n))
    swap = rng.random(n) < 0.005
    x[swap] = rng.integers(0, 10**7, size=int(swap.sum()))
    got = int(mk.mk_s_batch(torch.from_numpy(x)[None], torch.tensor([n]))[0])
    assert got == _s_by_insertion(x.tolist()) and got > 2**31 - 1


@pytest.mark.parametrize("seed", [5, 6])
def test_mann_kendall_batch_matches_jax_and_scalar(seed):
    pos, lengths = _batch(seed, b=30, n=70)
    jt, jh, jp, jz = (np.asarray(a) for a in jax_mk.mann_kendall_batch(
        jnp.asarray(pos.astype(np.int32)), jnp.asarray(lengths.astype(np.int32))))
    trend, h, p, z = (a.numpy() for a in mk.mann_kendall_batch(
        torch.from_numpy(pos), torch.from_numpy(lengths)))
    assert trend.tolist() == jt.tolist() and h.tolist() == jh.tolist()
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(z, jz, rtol=1e-5, atol=1e-7)
    for row, n in enumerate(lengths):  # float64 both, summed in another order
        st, sh, sp, sz = orientation.mann_kendall(pos[row, :n].tolist())
        np.testing.assert_allclose([p[row], z[row]], [sp, sz], rtol=1e-12, atol=1e-15)
        assert int(trend[row]) == {"increasing": 1, "decreasing": -1, "no trend": 0}[st]


def _runs(seed: int) -> list[list[int]]:
    """One path's contig runs: single positions, monotonic runs, and
    non-monotonic ones of lengths 2 to ~600 (several padded widths)."""
    rng = np.random.default_rng(seed)
    runs = [[5], [1, 2, 3], [9, 4, 1], [3, 3], [5, 5, 5], [2, 1, 2]]
    for n in list(rng.integers(2, 40, size=25)) + [129, 200, 257, 600]:
        base = np.sort(rng.integers(0, 50_000, size=int(n)))
        swap = rng.random(int(n)) < rng.random() * 0.5
        base[swap] = rng.integers(0, 50_000, size=int(swap.sum()))
        runs.append([int(v) for v in (base if rng.random() < 0.5 else base[::-1])])
    return runs


@pytest.mark.parametrize("seed", [7, 8])
def test_determine_orientations_mkt(seed):
    """Same verdicts as the JAX package's batched branch and as the scalar
    route, every ambiguous run through the op, one batch a padded width."""
    runs = _runs(seed)
    mk.reset_counts()
    got = orientation.determine_orientations(runs, True, 90, "cpu")
    assert got == jax_orientation.determine_orientations(runs, True, 90)
    assert got == [orientation.determine_orientation(r, True, 90) for r in runs]
    ambiguous = [r for r in runs if len(r) > 1 and r != sorted(set(r))
                 and r != sorted(set(r), reverse=True)]
    widths = {orientation._mk_width(len(r)) for r in ambiguous}
    assert len(widths) > 5
    assert mk.COUNTS == {"mk_batches": len(widths), "mk_runs": len(ambiguous), "device": "cpu"}
    assert {"+", "-", "?"} <= set(got)


@pytest.mark.parametrize("n,width", [(1, 8), (8, 8), (9, 9), (17, 18), (100, 104), (128, 128),
                                     (129, 144), (2048, 2048), (100_000, 106_496)])
def test_mk_width(n, width):
    assert orientation._mk_width(n) == width


def test_mk_finish_matches_scalar():
    for r in _runs(9)[6:]:
        s = int(mk.mk_s_batch(torch.tensor([r]), torch.tensor([len(r)]))[0])
        assert orientation._mk_finish(s, r) == orientation.mann_kendall(r)
        assert orientation._mk_finish(s, r) == jax_orientation._mk_finish(s, r)


def test_orientation_without_mkt_runs_no_op():
    runs = _runs(10)
    mk.reset_counts()
    got = orientation.determine_orientations(runs, False, 90, "cpu")
    assert got == jax_orientation.determine_orientations(runs, False, 90)
    assert mk.COUNTS["mk_batches"] == 0
