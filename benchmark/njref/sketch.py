"""The plain reference's minimizer sketch, in plain torch ops.

The semantics are btllib ``indexlr``'s as ``nthash_np`` states them: the
canonical ntHash2 of every k-mer, k-mers with a base other than ACGT
skipped, the leftmost least canonical hash of every w consecutive valid
k-mers, consecutive windows with the same choice emitted once, the emitted
value ``nte(canonical, k, 1)``.  It computes them another way: each k-mer's
hash as the XOR of its k rotated base seeds, and each window's least by a
table of minima over spans of 1, 2, 4, ... k-mers.  Every record of a block
is sketched at once; a window that crosses two records is dropped.

``hash_bits=32`` is the control: the canonical hash cut to its low 32 bits
before the windows pick and before the emitted value is derived.
"""
from __future__ import annotations

import numpy as np
import torch

from njref.constants import CODE_INVALID, MULTI_SEED, MULTI_SHIFT, SEEDS, srol_n

BLOCK_BASES = 1 << 28  # bases a block of records, so that the tables fit a card
_SIGN = -(1 << 63)


def _s64(x: int) -> int:
    """A 64-bit unsigned value as the int64 with its bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def _tables(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, 5) int64: row j holds srol^(k-1-j)(seed[c]) for the forward
    strand and srol^j(seed[3-c]) for the reverse; code 4 gives 0."""
    fwd = [[_s64(srol_n(SEEDS[c], k - 1 - j)) for c in range(4)] + [0] for j in range(k)]
    rev = [[_s64(srol_n(SEEDS[3 - c], j)) for c in range(4)] + [0] for j in range(k)]
    return (torch.tensor(fwd, dtype=torch.int64, device=device),
            torch.tensor(rev, dtype=torch.int64, device=device))


def _derive(base: torch.Tensor, k: int) -> torch.Tensor:
    """``nte(base, k, 1)`` on int64 bits: a product mod 2^64 and a logical
    shift."""
    t = base * _s64(1 ^ (k * MULTI_SEED))
    return t ^ ((t >> MULTI_SHIFT) & ((1 << (64 - MULTI_SHIFT)) - 1))


def _window_argmin(key: torch.Tensor, w: int) -> torch.Tensor:
    """Index of the leftmost least ``key`` of each window of w (signed
    order), for every window start in [0, len - w]."""
    n = key.shape[0]
    val, idx = key, torch.arange(n, device=key.device)
    span = 1
    while span * 2 <= w:
        lv, li, rv, ri = val[:-span], idx[:-span], val[span:], idx[span:]
        right = rv < lv  # a tie keeps the left, whose index is lower
        val, idx = torch.where(right, rv, lv), torch.where(right, ri, li)
        span *= 2
    m = n - w + 1
    lv, li = val[:m], idx[:m]
    rv, ri = val[w - span:w - span + m], idx[w - span:w - span + m]
    right = (rv < lv) | ((rv == lv) & (ri < li))
    return torch.where(right, ri, li)


def _sketch_block(records: list[bytes], k: int, w: int, device, hash_bits: int):
    """(record index, position, emitted hash as int64) of every minimizer of
    these records, in record and position order."""
    lut = np.full(256, CODE_INVALID, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = lut[b + 32] = i
    lengths = np.array([len(r) for r in records], dtype=np.int64)
    starts = np.zeros(len(records), dtype=np.int64)
    np.cumsum(lengths[:-1] + 1, out=starts[1:])
    # one N between records, so that no k-mer spans two of them
    codes = lut[np.frombuffer(b"N".join(records), dtype=np.uint8)]
    n = codes.shape[0]
    empty = torch.empty(0, dtype=torch.int64)
    if n < k:
        return empty, empty, empty
    c = torch.from_numpy(codes).to(device).long()
    nk = n - k + 1
    bad = torch.zeros(n + 1, dtype=torch.int32, device=device)
    bad[1:] = torch.cumsum((c >= CODE_INVALID).int(), 0)
    vpos = torch.nonzero(bad[k:] == bad[:nk]).squeeze(1)
    if vpos.shape[0] < w:
        return empty, empty, empty
    tf, tr = _tables(k, device)
    fwd = torch.zeros(vpos.shape[0], dtype=torch.int64, device=device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        cj = c[vpos + j]
        fwd ^= tf[j][cj]
        rev ^= tr[j][cj]
    del c
    canon = fwd + rev  # mod 2^64
    del fwd, rev
    if hash_bits == 32:
        canon = canon & 0xFFFFFFFF
    rec = torch.searchsorted(torch.from_numpy(starts).to(device), vpos, right=True) - 1
    arg = _window_argmin(canon ^ _SIGN, w)
    inside = rec[: arg.shape[0]] == rec[w - 1:]
    arg, wrec = arg[inside], rec[: inside.shape[0]][inside]
    if arg.shape[0] == 0:
        return empty, empty, empty
    keep = torch.ones_like(arg, dtype=torch.bool)
    keep[1:] = (arg[1:] != arg[:-1]) | (wrec[1:] != wrec[:-1])
    sel = arg[keep]
    r = rec[sel]
    pos = vpos[sel] - torch.from_numpy(starts).to(device)[r]
    return r.cpu(), pos.cpu(), _derive(canon[sel], k).cpu()


def sketch_records(records: list[bytes], k: int, w: int, device="cpu",
                   hash_bits: int = 64) -> list[tuple[np.ndarray, np.ndarray]]:
    """(positions int64, hashes uint64) of each record's minimizers."""
    out: list[tuple[np.ndarray, np.ndarray]] = []
    i = 0
    while i < len(records):
        j, size = i, 0
        while j < len(records) and (j == i or size + len(records[j]) <= BLOCK_BASES):
            size += len(records[j]) + 1
            j += 1
        r, pos, h = _sketch_block(records[i:j], k, w, device, hash_bits)
        r, pos, h = r.numpy(), pos.numpy(), h.numpy().view(np.uint64)
        cuts = np.searchsorted(r, np.arange(1, j - i))
        out += list(zip(np.split(pos, cuts), np.split(h, cuts)))
        i = j
    return out
