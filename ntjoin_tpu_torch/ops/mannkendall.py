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
``BLOCK_BYTES``.
"""
from __future__ import annotations

import torch

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


def mk_s_batch(positions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Exact Mann-Kendall S of each padded row: positions (B, L) integers,
    valid before ``lengths`` (B,); values past a row's length are ignored.
    Returns int64 (B,) on the tensors' device."""
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
    COUNTS["mk_batches"] += 1
    COUNTS["mk_runs"] += b
    COUNTS["device"] = pos.device.type
    return 2 * greater - lengths * (lengths - 1) // 2 + tied


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
