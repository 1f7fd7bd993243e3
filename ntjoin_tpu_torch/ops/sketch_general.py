"""The general device sketch of records with N runs: the counterpart of
``ntjoin_tpu/ops/sketch_pallas.py`` ``_sketch_fused_general`` (:1433) with
``multi=True``.

A record's windows slide over its valid k-mers, across its N runs
(``ops.nthash_np.sketch_codes``).  So the batch is compacted to the stream
of its valid k-mers on the device and the window kernels run on that
stream:

1. Hash (``sketch_cuda.hash_chunked``) the batch's codes in the chunk layout
   ``layout(n, k, w)`` with k - 1 rows of lead-in and no window halo: the
   canonical hash and valid flag of every k-mer.
2-3. Compaction (``stream_batch``): keep the valid k-mers and one dead
   slot between records, the k-mer that starts on the last separator base
   before each record after the first, which is never valid; lay the kept
   k-mers out by rank (the stream) in ``layout(S, 1, w)`` chunks (pitched,
   L + w - 1 rows, no lead-in, so ``off`` is 0), hashes ``hs`` and valid
   flags ``vs``; and keep what maps a rank back to its genomic position
   (``StreamIndex``: the hash layout's flags and the first rank of each
   tile of ``STREAM_TILE`` rows of a column).  The stream's valid flags are
   1 except at the dead slots, so no valid window crosses a record and each
   record's first window follows an invalid one: the flag kernel gives
   exactly the JAX masks ``wvalid`` / ``wfirst`` (:1619-1642, :1681-1694),
   bit0 a window inside one record, bit1 its first window.  On the card this
   is the compaction kernel (``csrc/stream.cu``): a count pass over the
   tiles of the hash layout's columns, a scan of the counts and one sync for
   S, then a pass that gathers the stream in rank order and one that writes
   the chunks.
4. ``sketch_cuda.window_stream``: flags, window/emission (tiles or the
   device-memory route by w), compaction, the exact kernel for overflowed
   chunks.  Then ``decode_ranks`` maps the emitted ranks to their positions:
   on the card the compaction kernel's fourth pass.  So a batch makes four
   launches counted in ``sketch_cuda.COUNTS["stream"]``: count, gather,
   chunks, decode (none for a batch that emits nothing).

The plain version (a CPU tensor, or ``plain``) takes the positions of every
rank by ``torch.nonzero`` (``valid_positions``), gathers the hashes by
``torch.take`` through a strided view (``gather_stream``), copies the flat
stream into chunks (``stream_valid``, ``stream_chunks``), finds each
tile's first rank by ``searchsorted`` of the positions and decodes by
``valid_positions(...)[ranks]``; ``tile_counts_ref`` is the count pass's.

The TPU design re-chunks through per-segment inverse maps and a static
segment bound (``cap_seg``, ``_seg_cap`` :1718) because a TPU scatter costs
a fixed ~80 ms; on a GPU a kept k-mer is written at its rank directly and
there is no segment count to check.  Each intermediate is freed as soon as
the next step has what it needs, so that the peak stays under
``sketch_records.GENERAL_BYTES_PER_BASE``.  Every step runs on the records'
device; on a CPU tensor, or with ``plain``, the ops' plain versions serve.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ntjoin_tpu_torch.ops import sketch_cuda as sc

# Rows of a tile, a column's unit of the compaction kernel (csrc/stream.cu):
# the kept rows of a tile are one 32-bit mask.
STREAM_TILE = 32


class StreamIndex(NamedTuple):
    """What maps a stream rank back to its genomic position: the hash
    layout's valid flags ``val`` ((k - 1 + L, C), k - 1 rows of lead-in), the
    records' ``starts``, and ``firsts``, int64 (C*T + 1,) with T =
    ``stream_tiles(L)``: the rank of the first kept position of each tile,
    entry c*T + t for rows [t, t + 1) * ``STREAM_TILE`` of column c, then S."""
    val: torch.Tensor
    firsts: torch.Tensor
    L: int
    n: int
    k: int
    starts: torch.Tensor

    @property
    def S(self) -> int:
        """The stream's length (a sync on the card)."""
        return int(self.firsts[-1])


def sketch_general_torch(flat: torch.Tensor, n: int, starts: torch.Tensor, k: int, w: int,
                         slot_cap: int | None = None,
                         plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Sketch the records of the int8 stream ``flat`` (its first n bases the
    data, records joined by at least one and at least k - 1 invalid bases
    and starting at the ascending int64 offsets ``starts`` on flat's device;
    length >= C*L + k - 1 for ``layout(n, k, w)``), windows sliding over
    each record's valid k-mers.

    Returns (positions in flat, canonical hashes) of every emission, int64,
    ascending.  ``slot_cap`` and ``plain`` as for ``sketch_fused_torch``."""
    hs, vs, Ls, index = stream_batch(flat, n, starts, k, w, plain)
    ranks, canon = sc.window_stream(hs, vs, Ls, w, 0, slot_cap, plain)
    del hs, vs
    return decode_ranks(index, ranks, plain), canon


def stream_batch(flat: torch.Tensor, n: int, starts: torch.Tensor, k: int, w: int,
                 plain: bool = False) -> tuple[torch.Tensor, torch.Tensor, int, StreamIndex]:
    """Steps 1-3 on ``sketch_general_torch``'s arguments: the stream's
    hashes ``hs`` (int64) and valid flags ``vs`` (int8) as ``pitched``
    (Ls + w - 1, Cs) chunks of ``layout(S, 1, w)``, chunk c's row r the
    stream's element c*Ls + r (all-ones / 0 past S), Ls, and the
    ``StreamIndex`` that ``decode_ranks`` reads.  The compaction kernel for
    a CUDA tensor, its plain version (``valid_positions``,
    ``gather_stream``, ``stream_valid``, ``stream_chunks``, and the first
    ranks by ``searchsorted``) for a CPU one or with ``plain``; each frees
    what it no longer needs."""
    if flat.dtype != torch.int8 or flat.dim() != 1:
        raise ValueError(f"stream_batch: want an int8 stream, got {flat.dtype} "
                         f"{tuple(flat.shape)}")
    if (starts.dtype != torch.int64 or starts.dim() != 1 or starts.numel() < 1
            or not starts.is_contiguous()):
        raise ValueError(f"stream_batch: want contiguous int64 record starts (R,), R >= 1, "
                         f"got {starts.dtype} {tuple(starts.shape)}")
    if starts.device != flat.device:
        raise ValueError(f"starts on {starts.device}, stream on {flat.device}")
    h, val, L = hash_batch(flat, n, k, w, plain)
    if plain or not sc._on_cuda(flat):
        # the plain version of the compaction kernel
        sc.add_count("stream_plain")
        pos = valid_positions(val, L, n, starts, k)
        hflat, Ls = gather_stream(h, pos, L, k, w)
        del h
        size = hflat.shape[0]
        hs = stream_chunks(hflat, Ls, w)
        del hflat
        vs = stream_chunks(stream_valid(pos, starts, size), Ls, w)
        # each tile's first rank: the kept positions before its first row
        rows = torch.arange(0, L, STREAM_TILE, device=pos.device)
        first = (torch.arange(val.shape[1], device=pos.device)[:, None] * L + rows).flatten()
        firsts = torch.cat([torch.searchsorted(pos, first), pos.new_tensor([pos.shape[0]])])
        return hs, vs, Ls, StreamIndex(val, firsts, L, n, k, starts)
    firsts, S = first_ranks(_count(val, L, n, starts, k))
    hflat, vflat = _gather(h, val, L, n, starts, k, firsts, S)
    del h  # every kept hash is in hflat
    hs, vs, Ls = _chunks(hflat, vflat, w)
    return hs, vs, Ls, StreamIndex(val, firsts, L, n, k, starts)


def decode_ranks(index: StreamIndex, ranks: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The genomic positions (int64) of the stream ranks ``ranks`` (int64,
    each below S): the compaction kernel's decode pass for a CUDA tensor,
    ``valid_positions(...)[ranks]`` for a CPU one or with ``plain``."""
    if ranks.dtype != torch.int64 or ranks.dim() != 1:
        raise ValueError(f"decode_ranks: want int64 ranks (E,), got {ranks.dtype} "
                         f"{tuple(ranks.shape)}")
    if ranks.device != index.val.device:
        raise ValueError(f"ranks on {ranks.device}, stream index on {index.val.device}")
    if plain or not sc._on_cuda(ranks):
        return valid_positions(index.val, index.L, index.n, index.starts, index.k)[ranks]
    return _decode(index, ranks)


def hash_batch(flat: torch.Tensor, n: int, k: int, w: int,
               plain: bool = False) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Step 1: (hashes, valid flags, L) of the k-mers of ``flat`` in
    ``layout(n, k, w)`` chunks of L, k - 1 rows of lead-in (the owned k-mer
    starting at c*L + j sits at row k - 1 + j of column c)."""
    C, L = sc.layout(n, k, w)
    if plain:
        h, val = sc.hash_chunked_ref(sc._chunk_view(flat, L, C, L + k - 1), k)
    else:
        h, val = sc.hash_chunked(flat, L, C, L + k - 1, k)
    return h, val, L


def valid_positions(val: torch.Tensor, L: int, n: int, starts: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Step 2: the genomic position of every stream rank, int64 ascending:
    the valid k-mers of ``hash_batch``'s flags and a dead slot before every
    record after the first."""
    keep = torch.empty(val.shape[1] * L, dtype=torch.int8, device=val.device)
    keep.view(-1, L).copy_(val[k - 1 : k - 1 + L].t())  # genomic order: c*L + j
    keep = keep[: n - k + 1]
    keep[starts[1:] - 1] = 1
    return torch.nonzero(keep).flatten()


def gather_stream(h: torch.Tensor, pos: torch.Tensor, L: int, k: int,
                  w: int) -> tuple[torch.Tensor, int]:
    """Step 2: the hashes of the stream ranks, flat and padded with all-ones
    to ``layout(S, 1, w)`` chunks of Ls plus the last chunk's halo; and Ls."""
    S = pos.shape[0]
    Cs, Ls = sc.layout(S, 1, w)
    pitch = h.stride(0)
    # element [c, j] is h[k - 1 + j, c], the k-mer at genomic position c*L + j
    by_pos = h.as_strided((h.shape[1], L), (1, pitch), h.storage_offset() + (k - 1) * pitch)
    hflat = torch.empty(Cs * Ls + w - 1, dtype=torch.int64, device=h.device)
    hflat[S:] = -1
    torch.take(by_pos, pos, out=hflat[:S])
    return hflat, Ls


def stream_valid(pos: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """Step 2: the stream's valid flags, flat like ``gather_stream``'s
    hashes: 1 for a valid k-mer, 0 for a dead slot and the padding."""
    vflat = torch.zeros(size, dtype=torch.int8, device=pos.device)
    vflat[: pos.shape[0]] = 1
    vflat[torch.searchsorted(pos, starts[1:] - 1)] = 0
    return vflat


def stream_chunks(x: torch.Tensor, Ls: int, w: int) -> torch.Tensor:
    """Step 3: a flat stream of ``gather_stream``'s length as a pitched
    (Ls + w - 1, Cs) array, chunk c's row r the stream's element c*Ls + r."""
    Cs = (x.shape[0] - w + 1) // Ls
    rows = Ls + w - 1
    out = sc.pitched(rows, Cs, x.dtype, x.device)
    out.copy_(sc._chunk_view(x, Ls, Cs, rows))
    return out


def stream_tiles(L: int, rows: int = STREAM_TILE) -> int:
    """Tiles of ``rows`` rows in a column of L rows."""
    return -(-L // rows)


def tile_counts_ref(val: torch.Tensor, L: int, n: int, starts: torch.Tensor, k: int,
                    rows: int = STREAM_TILE) -> torch.Tensor:
    """Plain version of the count pass: int64 (C*T + 1,), T =
    ``stream_tiles(L, rows)``: 0, then at 1 + c*T + t the kept positions
    (``valid_positions``) among rows [t, t + 1) * ``rows`` of column c.  The
    kernel's tiles are ``STREAM_TILE`` rows."""
    C, T = val.shape[1], stream_tiles(L, rows)
    keep = torch.zeros(C * L, dtype=torch.int64, device=val.device)
    keep.view(C, L).copy_(val[k - 1 : k - 1 + L].t())
    keep[n - k + 1 :] = 0
    keep[starts[1:] - 1] = 1
    counts = torch.zeros(C * T + 1, dtype=torch.int64, device=val.device)
    cols = counts[1:].view(C, T)
    cols[:, : L // rows] = keep.view(C, L)[:, : L // rows * rows].view(C, -1, rows).sum(2)
    if L % rows:
        cols[:, -1] = keep.view(C, L)[:, L // rows * rows :].sum(1)
    return counts


def first_ranks(counts: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(``StreamIndex.firsts``: the prefix sum of the count pass's
    ``counts``, so each tile's first rank and then S; S).  Reading S is the
    compaction's one sync."""
    firsts = counts.cumsum(0)
    return firsts, int(firsts[-1])


def _layout_args(val: torch.Tensor, L: int, n: int, starts: torch.Tensor, k: int) -> tuple:
    """The compaction kernel's view of the hash layout: flags and their
    pitch (16-byte rows: the kernel loads 16 flags at once), lead-in rows,
    L, C, k-mer starts, record starts."""
    if not sc._on_cuda(val):
        raise ValueError("the compaction kernel's passes take CUDA tensors (stream_batch "
                         "and decode_ranks take the plain version for CPU ones)")
    sc._check_rows(val, torch.int8, tuple(val.shape), "compaction val")
    _check_aligned(val, 16, "compaction val")
    return (val.data_ptr(), val.stride(0), k - 1, L, val.shape[1], n - k + 1,
            starts.data_ptr(), starts.shape[0])


def _check_aligned(t: torch.Tensor, nbytes: int, name: str) -> None:
    """Rows that start on ``nbytes`` boundaries, as ``sc.pitched`` makes them."""
    step = t.element_size()
    if t.data_ptr() % nbytes or (t.stride(0) * step) % nbytes:
        raise ValueError(f"{name}: want rows on {nbytes}-byte boundaries, got address "
                         f"{t.data_ptr()} and a pitch of {t.stride(0) * step} bytes")


def _count(val: torch.Tensor, L: int, n: int, starts: torch.Tensor, k: int) -> torch.Tensor:
    """The count pass on the card: ``tile_counts_ref``'s counts."""
    args = _layout_args(val, L, n, starts, k)
    counts = torch.empty(val.shape[1] * stream_tiles(L) + 1, dtype=torch.int64,
                         device=val.device)
    with torch.cuda.device(val.device):
        err = sc._lib().nj_stream_count(*args, counts.data_ptr(), sc._stream(val))
    sc._launched(err, "stream")
    return counts


def _gather(h: torch.Tensor, val: torch.Tensor, L: int, n: int, starts: torch.Tensor, k: int,
            firsts: torch.Tensor, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather pass on the card: the stream's hashes and valid flags in
    rank order, int64 and int8 (S,)."""
    args = _layout_args(val, L, n, starts, k)
    sc._check_rows(h, torch.int64, tuple(val.shape), "compaction h")
    _check_aligned(h, 16, "compaction h")
    sc._check(firsts, torch.int64, (val.shape[1] * stream_tiles(L) + 1,), "compaction firsts")
    hflat = torch.empty(S, dtype=torch.int64, device=h.device)
    vflat = torch.empty(S, dtype=torch.int8, device=h.device)
    with torch.cuda.device(h.device):
        err = sc._lib().nj_stream_gather(h.data_ptr(), h.stride(0), *args, firsts.data_ptr(),
                                         hflat.data_ptr(), vflat.data_ptr(), sc._stream(h))
    sc._launched(err, "stream")
    return hflat, vflat


def _chunks(hflat: torch.Tensor, vflat: torch.Tensor,
            w: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The chunks pass on the card: (hs, vs, Ls) of ``stream_batch`` from
    the stream in rank order."""
    S = hflat.shape[0]
    Cs, Ls = sc.layout(S, 1, w)
    hs = sc.pitched(Ls + w - 1, Cs, torch.int64, hflat.device)
    vs = sc.pitched(Ls + w - 1, Cs, torch.int8, hflat.device)
    with torch.cuda.device(hflat.device):
        err = sc._lib().nj_stream_chunks(hflat.data_ptr(), vflat.data_ptr(), S, Ls, Cs, w,
                                         hs.data_ptr(), hs.stride(0), vs.data_ptr(),
                                         vs.stride(0), sc._stream(hflat))
    sc._launched(err, "stream")
    return hs, vs, Ls


def _decode(index: StreamIndex, ranks: torch.Tensor) -> torch.Tensor:
    """The decode pass on the card: ``decode_ranks``'s positions."""
    val, L = index.val, index.L
    args = _layout_args(val, L, index.n, index.starts, index.k)
    sc._check(index.firsts, torch.int64, (val.shape[1] * stream_tiles(L) + 1,),
              "compaction firsts")
    sc._check(ranks, torch.int64, (ranks.shape[0],), "decode ranks")
    pos = torch.empty_like(ranks)
    if ranks.shape[0] == 0:
        return pos
    with torch.cuda.device(val.device):
        err = sc._lib().nj_stream_decode(*args, index.firsts.data_ptr(), ranks.data_ptr(),
                                         ranks.shape[0], pos.data_ptr(), sc._stream(val))
    sc._launched(err, "stream")
    return pos
