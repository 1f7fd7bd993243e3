"""Batched Mann-Kendall trend test as torch ops: the counterpart of
``ntjoin_tpu/ops/mannkendall.py``.

With ``mkt`` the orientation of a contig run whose minimizer positions are
not monotonic is the Mann-Kendall original test's verdict (reference
``ntjoin_assemble.py:37-40`` via pymannkendall).  ``core.orientation.
determine_orientations`` sends every such run of a path through
``mk_s_batch_host`` on the scaffolder's device and finishes each on the host
in float64 (``_mk_finish``), so that p and z are those of the scalar test.

The S statistic, a sum of +-1 over the n(n-1)/2 ordered pairs of a run, is
accumulated in int64: exact for any run a genome gives.  The JAX package's
int32 cast of the positions and its 65,536-element bound (its
``MAX_EXACT_LEN``) are limits of the TPU, which this port lifts.  S is
counted as 2 G - P + E: G the pairs i < j with x_i < x_j, P all pairs, E the
tied pairs.  Padding past a row's length holds the largest int64, so each
valid element counts every pad after it in G (subtracted exactly) and pads
tie only with pads; G then needs one comparison and one sum a pair, no mask
outside the diagonal blocks, and E and the tie correction come from one sort
of each row.  Pairs are blocked over i, as in the original, with the block
sized from B and L so that a live (B, block, L) boolean tensor stays within
``BLOCK_BYTES``: that is the plain version, ``mk_s_batch_ref``.

On a CUDA tensor ``mk_s_batch`` launches a kernel (``csrc/mannkendall.cu``)
that counts S during a merge sort of each row: tiles of up to ``MK_TILE``
values sorted in shared memory, each element counting the values of its
sibling run below and above it, then the pairs across a row's sorted tiles
(O(n log^2 n) steps, no boolean tensor); its launches count in
``launch:mk_s``, the plain version's calls in ``launch:mk_s_plain``, and
every batch in ``mk:batches@<device type>`` and its runs in
``mk:runs@<device type>`` (``utils/timers.py``).  ``core.orientation._mk_s``
checks the lengths it built on the host and calls ``mk_s_batch_host``,
which reads nothing back from the card; it queues each batch's upload
without a wait and reads every batch's S back at once.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.utils import timers

# Bytes of one live (B, block, L) boolean comparison tensor.
BLOCK_BYTES = 1 << 26
_PAD = torch.iinfo(torch.int64).max


def _prepare(positions: torch.Tensor, lengths: torch.Tensor):
    """(int64 rows with the largest int64 past each length, int64 lengths,
    the rows sorted, each sorted element's tie-group size and its offset in
    the group, the mask of valid sorted elements)."""
    pos = positions.to(torch.int64)
    lengths = lengths.to(device=pos.device, dtype=torch.int64)
    idx = torch.arange(pos.shape[1], device=pos.device).expand_as(pos)
    valid = idx < lengths[:, None]
    pos = pos.masked_fill(~valid, _PAD)
    srt = pos.sort(dim=1).values  # valid values first: a position is never the pad
    new = torch.ones_like(valid)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    end = torch.ones_like(valid)
    end[:, :-1] = new[:, 1:]
    first = torch.where(new, idx, 0).cummax(dim=1).values
    last = torch.where(end, idx, pos.shape[1]).flip(1).cummin(dim=1).values.flip(1)
    return pos, lengths, last - first + 1, idx - first, valid


def mk_s_batch_ref(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the S kernel: exact Mann-Kendall S of each padded
    row of ``mk_s_batch``'s arguments, by blocked boolean comparisons."""
    timers.count("launch:mk_s_plain")
    pos, lengths, _, offset, valid = _prepare(positions, lengths)
    b, n = pos.shape
    step = max(1, min(n, BLOCK_BYTES // max(b * n, 1)))
    greater = torch.zeros(b, dtype=torch.int64, device=pos.device)
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        xi = pos[:, i0:i1, None]
        greater += (pos[:, None, i1:] > xi).sum(dim=(1, 2))
        upper = torch.ones((i1 - i0, i1 - i0), dtype=torch.bool, device=pos.device).triu(1)
        greater += ((pos[:, None, i0:i1] > xi) & upper).sum(dim=(1, 2))
    greater -= lengths * (n - lengths)  # each valid element before every pad
    tied = torch.where(valid, offset, 0).sum(dim=1)
    return 2 * greater - lengths * (lengths - 1) // 2 + tied


# The S kernel (``csrc/mannkendall.cu``): tiles of up to ``MK_TILE`` values
# (two int64 buffers of it fill 32 KB of static shared memory) and at least
# ``MK_MIN_TILE`` (a warp's lanes lie in one row); past ``MK_MAX_BLOCKS``
# each thread block walks items a grid apart.
MK_TILE = 2048
MK_MIN_TILE = 32
MK_MAX_BLOCKS = 1 << 20


def mk_tile(width: int) -> int:
    """Values of the S kernel's tiles on rows of ``width``: the least power
    of two that holds a row, within [MK_MIN_TILE, MK_TILE]."""
    return min(MK_TILE, max(MK_MIN_TILE, 1 << (max(width, 1) - 1).bit_length()))


def mk_launch(b: int, width: int) -> tuple[int, int, int, int, int]:
    """(tile, rows a block, pass 1 thread blocks, tile pairs a row, pass 2
    thread blocks) of the S kernel on a (b, width) batch.  Pass 1 takes a
    (block of rows, tile) item a block: rows of one tile share a block,
    ``MK_TILE // tile`` at a time.  A row of nt > 1 tiles (then tile ==
    ``MK_TILE``) has nt (nt - 1) / 2 pairs ti < tj for pass 2, numbered p = tj
    (tj - 1) / 2 + ti, a (row, pair) item a block; none where nt == 1."""
    tile = mk_tile(width)
    nt = -(-width // tile)
    rows = MK_TILE // tile if nt == 1 else 1
    pairs = nt * (nt - 1) // 2
    return (tile, rows, min(MK_MAX_BLOCKS, -(-b // rows) * nt), pairs,
            min(MK_MAX_BLOCKS, b * pairs))


def mk_steps(lengths: np.ndarray, width: int) -> int:
    """Binary-search steps the S kernel takes on rows of these lengths padded
    to ``width``.  At merge level r (runs of r values) each value with a
    non-empty sibling run searches it once in bit_length(r) steps; each
    value of a tile then searches the sorted tile once, in bit_length(tile)
    steps, for its ties.  In pass 2 each value of tile tj searches each
    earlier, full, tile twice, in bit_length(tile) steps."""
    n = np.asarray(lengths, np.int64)
    tile = mk_tile(width)
    full, last = n // tile, n % tile
    steps = n * tile.bit_length()  # the ties
    r = 1
    while r < tile:
        for m, count in ((tile, full), (last, 1)):
            pairs, rem = m // (2 * r), m % (2 * r)
            right = np.maximum(rem - r, 0)  # the last pair's right run
            paired = np.where(right > 0, r + right, 0)  # its values with a sibling
            steps += count * (pairs * 2 * r + paired) * r.bit_length()
        r *= 2
    full_pairs = full * (full - 1) // 2  # pass 2: the full tiles, then the last
    steps += 2 * tile.bit_length() * (tile * full_pairs + last * full)
    return int(steps.sum())


def _check_positions(positions: torch.Tensor) -> None:
    if positions.dtype != torch.int64 or positions.dim() != 2:
        raise ValueError(f"mk_s_batch: want int64 positions (B, W), got {positions.dtype} "
                         f"{tuple(positions.shape)}")


def _check_range(lo: int, hi: int, width: int) -> None:
    if lo < 0 or hi > width:
        raise ValueError(f"mk_s_batch: lengths in [{lo}, {hi}], want [0, {width}]")


def _check_batch(positions: torch.Tensor, lengths: torch.Tensor) -> None:
    _check_positions(positions)
    if lengths.dtype != torch.int64 or tuple(lengths.shape) != positions.shape[:1]:
        raise ValueError(f"mk_s_batch: want int64 lengths ({positions.shape[0]},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != positions.device:
        raise ValueError(f"lengths on {lengths.device}, positions on {positions.device}")
    if lengths.numel():
        lo, hi = (int(v) for v in torch.aminmax(lengths))  # a sync on the card
        _check_range(lo, hi, positions.shape[1])


def mk_s_batch(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Exact Mann-Kendall S of each padded row: positions (B, W) int64,
    valid before ``lengths`` (B,) int64 (each in [0, W]); values past a
    row's length are ignored.  Returns int64 (B,) on the tensors' device:
    the S kernel for CUDA tensors, ``mk_s_batch_ref`` for CPU ones."""
    _check_batch(positions, lengths)
    return _mk_s_checked(positions, lengths)


def mk_s_batch_host(positions: torch.Tensor, lengths: np.ndarray) -> torch.Tensor:
    """``mk_s_batch`` with the lengths as an int64 numpy array, checked on
    the host: nothing is read back from the card before the kernel."""
    _check_positions(positions)
    if lengths.dtype != np.int64 or lengths.shape != positions.shape[:1]:
        raise ValueError(f"mk_s_batch: want int64 lengths ({positions.shape[0]},), got "
                         f"{lengths.dtype} {lengths.shape}")
    if lengths.size:
        _check_range(int(lengths.min()), int(lengths.max()), positions.shape[1])
    # queued without waiting for the card: the CUDA runtime stages pageable
    # memory before the copy call returns
    return _mk_s_checked(positions,
                         torch.from_numpy(lengths).to(positions.device, non_blocking=True))


def _mk_s_checked(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """S of checked arguments on their device."""
    at = "@" + positions.device.type
    timers.count("mk:batches" + at)
    timers.count("mk:runs" + at, positions.shape[0])
    if not sc._on_cuda(positions):
        return mk_s_batch_ref(positions, lengths)
    return _mk_s_kernel(positions.contiguous(), lengths.contiguous())


def _mk_s_kernel(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The S kernel on checked contiguous CUDA tensors: one call into the
    library launches pass 1 and, where a row has several tiles, pass 2 (each
    counted in ``mk_s``); the sorted tiles' scratch lives only here."""
    b, width = positions.shape
    if b == 0 or width < 2:
        return torch.zeros(b, dtype=torch.int64, device=positions.device)
    s = torch.empty(b, dtype=torch.int64, device=positions.device)  # the kernel writes S
    tile, _, sort_blocks, pairs, cross_blocks = mk_launch(b, width)
    srt = torch.empty_like(positions) if pairs else None
    with torch.cuda.device(positions.device):
        err = sc._lib().nj_mk_s(positions.data_ptr(), b, width, lengths.data_ptr(), tile,
                                sort_blocks, cross_blocks,
                                None if srt is None else srt.data_ptr(), s.data_ptr(),
                                sc._stream(positions))
    sc._raise_on(err, "mk_s")
    timers.count("launch:mk_s", 2 if pairs else 1)
    return s


def mann_kendall_batch(positions: torch.Tensor, lengths: torch.Tensor, alpha: float = 0.05):
    """MK original test of each padded row on the tensors' device: S exact
    (``mk_s_batch``), tie counts integer, variance, z and two-sided p in
    float64.  Returns (trend, h, p, z), each (B,): trend +1 (increasing), -1
    (decreasing) or 0 (no trend).  The scaffolder needs only S
    (``core/orientation.py`` finishes the test on the host, as the JAX
    package's ``_mk_finish`` does); this is the counterpart of
    ``ntjoin_tpu.ops.mannkendall.mann_kendall_batch``, kept so that the
    port offers the JAX package's API."""
    s = mk_s_batch(positions, lengths).to(torch.float64)
    _, lengths, size, _, valid = _prepare(positions, lengths)
    t = size.to(torch.float64)
    # the sum over tie groups of t(t-1)(2t+5) is the sum over their
    # elements of (t-1)(2t+5)
    tie = torch.where(valid, (t - 1) * (2 * t + 5), 0.0).sum(dim=1)
    n = lengths.to(torch.float64)
    sd = torch.sqrt(torch.clamp((n * (n - 1) * (2 * n + 5) - tie) / 18.0, min=1e-30))
    z = torch.where(s > 0, (s - 1) / sd, torch.where(s < 0, (s + 1) / sd, 0.0))
    p = torch.special.erfc(z.abs() / 2 ** 0.5)
    h = (p < alpha) & (z != 0)
    trend = torch.where(h & (z > 0), 1, torch.where(h & (z < 0), -1, 0))
    return trend, h, p, z
