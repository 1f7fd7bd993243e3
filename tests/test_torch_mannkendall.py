"""The port's batched Mann-Kendall op (``ops/mannkendall.py``, torch on the
CPU) against the JAX package's ``mk_s_batch`` / ``mann_kendall_batch`` (CPU
backend) and the scalar test, and the batched orientation branch against
the JAX package's and the scalar route.  S is an integer: exact; p and z of
``mann_kendall_batch`` are float32 in the original and float64 in the port,
so they agree within float32 rounding (relative 1e-5), and with the scalar
test's float64 within 1e-12."""
import bisect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.core import orientation as jax_orientation
from ntjoin_tpu.ops import mannkendall as jax_mk
from ntjoin_tpu_torch.core import orientation
from ntjoin_tpu_torch.ops import mannkendall as mk
from ntjoin_tpu_torch.ops import sketch_cuda as sc


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


def _padded(runs: list[list[int]], width: int) -> tuple[np.ndarray, np.ndarray]:
    """Rows padded with zeros past their lengths, as ``_mk_batches`` pads."""
    pos = np.zeros((len(runs), width), np.int64)
    for row, r in enumerate(runs):
        pos[row, : len(r)] = r
    return pos, np.array([len(r) for r in runs], np.int64)


def _edge_rows(case: str) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(len(case))
    if case == "short":  # lengths 0, 1 and 2, rising, falling and tied
        return _padded([[], [7], [3, 9], [9, 3], [4, 4], [5, 1, 5]], 8)
    if case == "all_equal":
        return _padded([[6] * n for n in (1, 2, 31, 32, 33, 256, 300)], 300)
    if case == "zero_padding":  # one batch of _mk_batches: values past a length are 0
        runs = [[int(v) for v in rng.integers(1, 40, size=n)] for n in (97, 100, 104, 98)]
        (_, pos, lengths), = orientation._mk_batches(runs)
        return pos, lengths
    # one past a power of two: a lone row in the last tile of a row
    lengths = [33, 65, 129, 257, 513, 1025]
    return _padded([[int(v) for v in rng.integers(0, 500, size=n)] for n in lengths], 1025)


@pytest.mark.parametrize("case", ["short", "all_equal", "zero_padding", "pow2_plus1"])
def test_mk_s_batch_edges_match_jax(case):
    """The rows the S kernel's tiling must meet, through the plain version,
    against the JAX op and a count of the pairs one by one."""
    pos, lengths = _edge_rows(case)
    want = np.asarray(jax_mk.mk_s_batch(jnp.asarray(pos.astype(np.int32)),
                                        jnp.asarray(lengths.astype(np.int32))))
    got = mk.mk_s_batch(torch.from_numpy(pos), torch.from_numpy(lengths))
    assert got.tolist() == want.tolist()
    assert got.tolist() == [_s_by_insertion(pos[row, :n].tolist())
                            for row, n in enumerate(lengths)]
    if case in ("short", "all_equal"):
        assert got[lengths < 2].tolist() == [0] * int((lengths < 2).sum())
    if case == "all_equal":
        assert got.tolist() == [0] * len(lengths)


def test_mk_s_one_past_the_int32_bound():
    """65,537 elements, one past the JAX op's bound and a power of two: the
    plain version against the pairs counted one by one."""
    rng = np.random.default_rng(12)
    n = 65_537
    x = rng.integers(0, 10**6, size=n)
    x[: n // 2] = np.sort(x[: n // 2])
    pos, lengths = _padded([x.tolist()], n)
    got = mk.mk_s_batch(torch.from_numpy(pos), torch.from_numpy(lengths))
    assert got.tolist() == [_s_by_insertion(x.tolist())]


@pytest.mark.parametrize("positions,lengths,what", [
    (np.zeros((2, 8), np.int32), np.array([8, 8]), "int64 positions"),
    (np.zeros(8, np.int64), np.array([8]), "int64 positions"),
    (np.zeros((2, 8), np.int64), np.array([8, 8], np.int32), "int64 lengths"),
    (np.zeros((2, 8), np.int64), np.array([8, 8, 8]), "int64 lengths"),
    (np.zeros((2, 8), np.int64), np.array([8, 9]), "lengths in"),
    (np.zeros((2, 8), np.int64), np.array([-1, 3]), "lengths in"),
])
def test_mk_s_batch_refuses(positions, lengths, what):
    with pytest.raises(ValueError, match=what):
        mk.mk_s_batch(torch.from_numpy(positions), torch.from_numpy(lengths))


def test_mk_s_batch_cpu_takes_the_plain_version():
    pos, lengths = _edge_rows("short")
    sc.reset_counts()
    mk.mk_s_batch(torch.from_numpy(pos), torch.from_numpy(lengths))
    assert sc.COUNTS["mk_s_plain"] == 1 and sc.COUNTS["mk_s"] == 0


def _tile_pair(p: int) -> tuple[int, int]:
    """(ti, t), ti <= t, of p = t (t + 1) / 2 + ti by the S kernel's own
    arithmetic: the root in float64, then corrected.  Pass 2 takes the tile
    pair (ti, t + 1)."""
    t = int((math.sqrt(8.0 * p + 1.0) - 1.0) * 0.5)
    while t * (t + 1) // 2 > p:
        t -= 1
    while (t + 1) * (t + 2) // 2 <= p:
        t += 1
    return p - t * (t + 1) // 2, t


@pytest.mark.parametrize("width", [8, 32, 33, 100, 128, 129, 257, 1000, 4100,
                                   2047, 2048, 2049, 6145])
def test_mk_tiles_cover_every_pair_once(width):
    """Pass 1's items hold each (row, tile) once, pass 2's tile pairs are
    each ti < tj once, in order, and the pairs inside the tiles (merged in
    pass 1) and across them (pass 2) hold exactly n (n - 1) / 2 pairs for
    every length n up to the width."""
    b = 3
    tile, rows, sort_blocks, pairs, cross_blocks = mk.mk_launch(b, width)
    nt = -(-width // tile)
    assert tile == mk.mk_tile(width) == min(2048, max(32, 1 << (width - 1).bit_length()))
    assert rows == (2048 // tile if nt == 1 else 1)
    items = [(item // nt * rows + g, item % nt) for item in range(sort_blocks)
             for g in range(rows)]
    assert sorted(it for it in items if it[0] < b) == [(r, t) for r in range(b)
                                                        for t in range(nt)]
    assert sort_blocks == -(-b // rows) * nt and cross_blocks == b * pairs
    cross = [(ti, t + 1) for ti, t in map(_tile_pair, range(pairs))]
    assert cross == [(i, j) for j in range(1, nt) for i in range(j)]  # in order, each once
    for n in sorted({0, 1, 2, tile - 1, tile, tile + 1, width - 1, width}):
        if not 0 <= n <= width:
            continue
        m = [min(max(n - t * tile, 0), tile) for t in range(nt)]
        covered = sum(v * (v - 1) // 2 for v in m) + sum(m[i] * m[j] for i, j in cross)
        assert covered == n * (n - 1) // 2, n


@pytest.mark.parametrize("p", [0, 1, 2, 3, 5, 10**6, 2**40 + 12_345, 2**45 - 1])
def test_mk_tile_pair_far_out(p):
    """The float64 root lands on the exact pair beyond what a row of 2^31
    values at tiles of 2,048 reaches (p < 2^39)."""
    ti, tj = _tile_pair(p)
    assert 0 <= ti <= tj and tj * (tj + 1) // 2 + ti == p
    assert tj == (math.isqrt(8 * p + 1) - 1) // 2


def test_mk_launch_caps_the_grid():
    tile, rows, sort_blocks, pairs, cross_blocks = mk.mk_launch(2, 10_000_000)
    assert (tile, rows, sort_blocks) == (2048, 1, 2 * 4883)
    assert pairs == 4883 * 4882 // 2 and cross_blocks == mk.MK_MAX_BLOCKS
    assert mk.mk_launch(10**8, 32) == (32, 64, mk.MK_MAX_BLOCKS, 0, 0)
    assert mk.mk_launch(5, 1) == (32, 64, 1, 0, 0)


# -- the S kernel by its own steps ------------------------------------------------


def _search(buf: np.ndarray, lo0: np.ndarray, n: np.ndarray, y: np.ndarray,
            upper: bool, top: int) -> tuple[np.ndarray, int]:
    """The kernel's searches, stepped together as its ``probe`` steps them:
    the values of buf[lo0, lo0 + n) below y (at most y with ``upper``), built
    bit by bit from ``top``, a power of two at least every n.  Returns the
    counts and the steps of the searches over non-empty runs."""
    assert np.all(n <= top)
    lo = np.zeros_like(n)
    step, steps = top, 0
    while step > 0:
        ok = lo + step <= n
        v = buf[np.where(ok, lo0 + lo + step - 1, 0)]
        lo = lo + np.where(ok & ((v <= y) if upper else (v < y)), step, 0)
        steps += int((n > 0).sum())
        step >>= 1
    return lo, steps


def _merge_tile(vals: np.ndarray, tile: int) -> tuple[np.ndarray, int, int]:
    """Pass 1 on one tile's m valid values: log2(tile) merge levels, a left
    value x placed at a + lower_bound(right, x), a right value y at b +
    upper_bound(left, y), the count adding each right value's upper bound
    and taking each left value's lower bound; then less the tile's tied
    pairs, i - lower_bound(tile, y) for the value y at sorted place i.
    Asserts that each level's placement is a permutation.  Returns (sorted
    values, S inside the tile, steps)."""
    m = len(vals)
    buf, s, steps = vals.copy(), 0, 0
    i = np.arange(m)
    r = 1
    while r < tile:
        a = i & ~(2 * r - 1)
        mid, end = np.minimum(a + r, m), np.minimum(a + 2 * r, m)
        left, right = i < mid, i >= mid
        assert np.array_equal(right, (i & r) != 0)  # the kernel's test
        to = np.empty(m, np.int64)
        lb, st0 = _search(buf, mid[left], (end - mid)[left], buf[left], False, r)
        to[left] = i[left] + lb
        ub, st1 = _search(buf, a[right], (mid - a)[right], buf[right], True, r)
        s += int(ub.sum()) - int(lb.sum())
        to[right] = a[right] + (i[right] - mid[right]) + ub
        assert np.array_equal(np.sort(to), i), f"level {r}: not a permutation"
        buf = buf[np.argsort(to)]  # dst[to] = src
        steps += st0 + st1
        r *= 2
    assert np.all(buf[:-1] <= buf[1:])
    lb, st = _search(buf, np.zeros_like(i), np.full_like(i, m), buf, False, tile)
    return buf, s - int((i - lb).sum()), steps + st


def _kernel_s(pos: np.ndarray, lengths: np.ndarray, tile: int) -> tuple[list[int], int]:
    """S of each row by the kernel's two passes at tiles of ``tile`` values,
    reading only the values before each length: the tiles merged (pass 1),
    then each value of a later sorted tile tj searching each earlier full
    tile ti (pass 2).  Returns (S of each row, steps of all searches)."""
    out, steps = [], 0
    for row, n in enumerate(lengths):
        tiles, s = [], 0
        for start in range(0, int(n), tile):
            srt, c, st = _merge_tile(pos[row, start:min(start + tile, n)], tile)
            tiles.append(srt)
            s, steps = s + c, steps + st
        for tj in range(1, len(tiles)):
            y = tiles[tj]
            for ti in range(tj):
                assert len(tiles[ti]) == tile  # the earlier tile is full
                lo0, full = np.zeros_like(y), np.full_like(y, tile)
                lb, st0 = _search(tiles[ti], lo0, full, y, False, tile)
                ub, st1 = _search(tiles[ti], lo0, full, y, True, tile)
                s, steps = s + int((lb + ub - tile).sum()), steps + st0 + st1
        out.append(s)
    return out, steps


def _kernel_rows(case: str, tile: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded rows for the kernel's steps; padding is garbage."""
    rng = np.random.default_rng(sum(map(ord, case)) + tile)
    width = {"short": 8, "T-1": tile - 1, "T": tile, "T+1": tile + 1}.get(case, 2 * tile + 1)
    b = 6
    pos = rng.integers(-(2**30), 2**30, size=(b, width))
    lengths = rng.integers(0, width + 1, size=b)
    lengths[:3] = [width, width - 1, min(tile + 1, width)]
    if case == "short":
        lengths[:] = [0, 1, 2, 2, 1, 0]
        pos[2:4, :2] = [[3, 9], [9, 3]]
    elif case == "ties":
        pos = rng.integers(0, 4, size=(b, width))
    elif case == "all_equal":
        pos[:] = 7
        lengths[3:] = [0, 1, 2]
    elif case == "huge":  # values at +-2^62, the padding any int64
        pos = rng.choice([-(2**62), -(2**62) + 1, 0, 2**62 - 1, 2**62], size=(b, width))
        for row, n in enumerate(lengths):
            pos[row, n:] = rng.integers(-(2**63), 2**63 - 1, size=width - n)
    return pos.astype(np.int64), lengths.astype(np.int64)


@pytest.mark.parametrize("tile", [8, 2048])
@pytest.mark.parametrize("case", ["short", "ties", "all_equal", "T-1", "T", "T+1", "2T+1",
                                  "huge"])
def test_mk_s_by_the_kernels_steps(case, tile):
    """The kernel's two passes, emulated at a small tile and at its own,
    equal the plain version and (where int32 holds the values) the JAX op;
    lengths 0 and 1 give 0, all-equal rows 0."""
    pos, lengths = _kernel_rows(case, tile)
    got, steps = _kernel_s(pos, lengths, tile)
    assert got == mk.mk_s_batch_ref(torch.from_numpy(pos), torch.from_numpy(lengths)).tolist()
    if case != "huge":
        want = jax_mk.mk_s_batch(jnp.asarray(pos.astype(np.int32)),
                                 jnp.asarray(lengths.astype(np.int32)))
        assert got == np.asarray(want).tolist()
    assert [s for s, n in zip(got, lengths) if n < 2] == [0] * int((lengths < 2).sum())
    if case == "all_equal":
        assert got == [0] * len(got)
    if tile == mk.mk_tile(pos.shape[1]):
        assert steps == mk.mk_steps(lengths, pos.shape[1])


def test_mk_s_by_the_kernels_steps_decreasing():
    """A strictly decreasing row whose |S| passes 2^31, at the kernel's tile
    (33 tiles, 528 tile pairs): S = -n (n - 1) / 2, as the plain version
    gives (the JAX op's int32 S cannot hold it)."""
    n = 66_000
    pos = np.arange(n, 0, -1, dtype=np.int64)[None] * 3
    got, steps = _kernel_s(pos, np.array([n]), mk.MK_TILE)
    assert got == [-(n * (n - 1) // 2)] and got[0] < -(2**31)
    assert got == mk.mk_s_batch_ref(torch.from_numpy(pos), torch.tensor([n])).tolist()
    assert steps == mk.mk_steps(np.array([n]), n)


@pytest.mark.parametrize("width", [8, 33, 100, 700, 2049, 5000])
def test_mk_steps_match_the_emulation(width):
    """``mk_steps``, the search steps the chip smoke's bound counts, equals
    the steps of the kernel's passes at its own tile, whose S equals the
    plain version's."""
    rng = np.random.default_rng(width)
    pos = rng.integers(0, 50, size=(5, width)).astype(np.int64)
    lengths = rng.integers(0, width + 1, size=5).astype(np.int64)
    lengths[0] = width
    got, steps = _kernel_s(pos, lengths, mk.mk_tile(width))
    assert got == mk.mk_s_batch_ref(torch.from_numpy(pos), torch.from_numpy(lengths)).tolist()
    assert steps == mk.mk_steps(lengths, width)


@pytest.mark.parametrize("positions,lengths,what", [
    (np.zeros((2, 8), np.int32), np.array([8, 8]), "int64 positions"),
    (np.zeros(8, np.int64), np.array([8]), "int64 positions"),
    (np.zeros((2, 8), np.int64), np.array([8, 8], np.int32), "int64 lengths"),
    (np.zeros((2, 8), np.int64), np.array([8, 8, 8]), "int64 lengths"),
    (np.zeros((2, 8), np.int64), np.array([8, 9]), "lengths in"),
    (np.zeros((2, 8), np.int64), np.array([-1, 3]), "lengths in"),
])
def test_mk_s_batch_host_refuses(positions, lengths, what):
    """The host-checked route refuses what the public op refuses."""
    with pytest.raises(ValueError, match=what):
        mk.mk_s_batch_host(torch.from_numpy(positions), lengths)


def test_mk_s_route_reads_no_lengths_back(monkeypatch):
    """``_mk_s`` checks its lengths in numpy: with ``torch.aminmax`` gone it
    still gives the public op's S, and the public op still checks on the
    tensors' device."""
    runs = [r for r in _runs(13) if len(r) > 1]
    want = [int(mk.mk_s_batch(torch.tensor([r]), torch.tensor([len(r)]))[0]) for r in runs]

    def gone(*_a, **_k):
        raise AssertionError("torch.aminmax called")

    monkeypatch.setattr(torch, "aminmax", gone)
    assert orientation._mk_s(runs, torch.device("cpu")) == want
    pos, lengths = _edge_rows("short")
    with pytest.raises(AssertionError, match="aminmax"):
        mk.mk_s_batch(torch.from_numpy(pos), torch.from_numpy(lengths))
