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
2. Keep the valid k-mers and one dead slot between records: the k-mer that
   starts on the last separator base before each record after the first,
   which is never valid.  ``torch.nonzero`` of that mask gives the genomic
   position of every stream rank in order (``valid_positions``), and
   ``torch.take`` of the hashes through a strided view in genomic order
   gathers the stream's hashes (``gather_stream``).  The stream's valid
   flags are 1 except at the dead slots (``stream_valid``), so no valid
   window crosses a record and each record's first window follows an
   invalid one: the flag kernel gives exactly the JAX masks ``wvalid`` /
   ``wfirst`` (:1619-1642, :1681-1694), bit0 a window inside one record,
   bit1 its first window.
3. The stream laid out in ``layout(S, 1, w)`` chunks (``stream_chunks``:
   pitched, L + w - 1 rows, no lead-in, so ``off`` is 0).
4. ``sketch_cuda.window_stream``: flags, window/emission (tiles or the
   device-memory route by w), compaction, the exact kernel for overflowed
   chunks; the emitted ranks decode to positions by one gather.

The TPU design re-chunks through per-segment inverse maps and a static
segment bound (``cap_seg``, ``_seg_cap`` :1718) because a TPU scatter costs
a fixed ~80 ms; on a GPU a gather is an ordinary pass, so the stream is
built by rank directly and there is no segment count to check.  Each
intermediate is freed as soon as the next step has what it needs, so that
the peak stays under ``sketch_records.GENERAL_BYTES_PER_BASE``.  Every step
runs on the records' device; on a CPU tensor, or with ``plain``, the ops'
plain versions serve.
"""
from __future__ import annotations

import torch

from ntjoin_tpu_torch.ops import sketch_cuda as sc


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
    h, val, L = hash_batch(flat, n, k, w, plain)
    pos = valid_positions(val, L, n, starts, k)
    del val
    hflat, Ls = gather_stream(h, pos, L, k, w)
    del h
    size = hflat.shape[0]
    hs = stream_chunks(hflat, Ls, w)
    del hflat
    vs = stream_chunks(stream_valid(pos, starts, size), Ls, w)
    ranks, canon = sc.window_stream(hs, vs, Ls, w, 0, slot_cap, plain)
    return pos[ranks], canon


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
