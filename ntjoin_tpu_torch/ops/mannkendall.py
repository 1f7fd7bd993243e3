"""Batched Mann-Kendall trend test as torch ops: the counterpart of
``ntjoin_tpu/ops/mannkendall.py``.

With ``mkt`` the orientation of a contig run whose minimizer positions are
not monotonic is the Mann-Kendall original test's verdict (reference
``ntjoin_assemble.py:37-40`` via pymannkendall).  ``core.orientation.
determine_orientations`` sends every such run of a path through
``mk_s_batch`` on the scaffolder's device and finishes each on the host in
float64 (``_mk_finish``), so that p and z are those of the scalar test.

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
that counts the pairs in registers, tile pair by tile pair, with no boolean
tensor and no sort; its launches count in ``sketch_cuda.COUNTS["mk_s"]``,
the plain version's calls in ``["mk_s_plain"]``.
"""
from __future__ import annotations

import torch

from ntjoin_tpu_torch.ops import sketch_cuda as sc

# Bytes of one live (B, block, L) boolean comparison tensor.
BLOCK_BYTES = 1 << 26
_PAD = torch.iinfo(torch.int64).max

# Batches the op ran, runs they held, and the device type of the last batch
# (``reset_counts`` zeroes them).
COUNTS: dict = {}


def reset_counts() -> None:
    COUNTS.clear()
    COUNTS.update(mk_batches=0, mk_runs=0, device=None)


reset_counts()


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
    sc.add_count("mk_s_plain")
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


# Thread blocks of the S kernel: 256 threads; past ``MK_MAX_BLOCKS`` each
# block walks items a grid apart.
MK_THREADS = 256
MK_MAX_BLOCKS = 1 << 20


def mk_launch(b: int, width: int) -> tuple[int, int, int]:
    """(tile, tile pairs a row, thread blocks) of the S kernel on a (b,
    width) batch: a tile is 256 values, or the least of 32, 64, 128 that
    holds a whole row; a row of nt tiles has nt (nt + 1) / 2 pairs ti <= tj,
    numbered p = tj (tj + 1) / 2 + ti; a block takes ``MK_THREADS // tile``
    (row, pair) items."""
    tile = next((t for t in (32, 64, 128) if width <= t), 256)
    nt = -(-width // tile)
    pairs = nt * (nt + 1) // 2
    return tile, pairs, min(MK_MAX_BLOCKS, -(-b * pairs // (MK_THREADS // tile)))


def _check_batch(positions: torch.Tensor, lengths: torch.Tensor) -> None:
    if positions.dtype != torch.int64 or positions.dim() != 2:
        raise ValueError(f"mk_s_batch: want int64 positions (B, W), got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    if lengths.dtype != torch.int64 or tuple(lengths.shape) != positions.shape[:1]:
        raise ValueError(f"mk_s_batch: want int64 lengths ({positions.shape[0]},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != positions.device:
        raise ValueError(f"lengths on {lengths.device}, positions on {positions.device}")
    if lengths.numel():
        lo, hi = (int(v) for v in torch.aminmax(lengths))
        if lo < 0 or hi > positions.shape[1]:
            raise ValueError(f"mk_s_batch: lengths in [{lo}, {hi}], want [0, "
                             f"{positions.shape[1]}]")


def mk_s_batch(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Exact Mann-Kendall S of each padded row: positions (B, W) int64,
    valid before ``lengths`` (B,) int64 (each in [0, W]); values past a
    row's length are ignored.  Returns int64 (B,) on the tensors' device:
    the S kernel for CUDA tensors, ``mk_s_batch_ref`` for CPU ones."""
    _check_batch(positions, lengths)
    COUNTS["mk_batches"] += 1
    COUNTS["mk_runs"] += positions.shape[0]
    COUNTS["device"] = positions.device.type
    if not sc._on_cuda(positions):
        return mk_s_batch_ref(positions, lengths)
    return _mk_s_kernel(positions.contiguous(), lengths.contiguous())


def _mk_s_kernel(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The S kernel on checked contiguous CUDA tensors."""
    b, width = positions.shape
    s = torch.zeros(b, dtype=torch.int64, device=positions.device)
    if b == 0 or width < 2:
        return s
    tile, _, blocks = mk_launch(b, width)
    with torch.cuda.device(positions.device):
        err = sc._lib().nj_mk_s(positions.data_ptr(), b, width, lengths.data_ptr(), tile,
                                blocks, s.data_ptr(), sc._stream(positions))
    sc._launched(err, "mk_s")
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
