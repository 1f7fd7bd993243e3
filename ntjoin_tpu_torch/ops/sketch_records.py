"""Minimizer sketches of many records on an NVIDIA GPU: the counterpart of
``ntjoin_tpu/ops/sketch_pallas.py`` ``sketch_records_pallas``.

Each record takes one of two device paths, packed with others of its path
into batches of about ``BATCH_BASES`` bases:

* a record with no invalid base, the fused sketch
  (``sketch_cuda.sketch_fused_torch``) of the batch's joined stream;
* a record with N runs, the general path (``ops/sketch_general.py``), whose
  windows slide over the valid k-mers across the runs; counted in
  ``COUNTS["general_records"]`` and ``["general_batches"]``.

A record longer than ``record_bound`` for its path is sketched whole on the
host, decided from its length (and, where the two paths' bounds differ,
its path) before any launch and counted in ``COUNTS["host_records"]`` and
``["host_records_size"]``.

The records come from a source (``io.native.FastaSource`` for a FASTA
file), which encodes each one straight into its batch's host buffer: no
call holds more than one batch of codes at a time.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ntjoin_tpu_torch.constants import CODE_INVALID
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops import u64
from ntjoin_tpu_torch.ops.nthash_np import Sketch, sketch_codes
from ntjoin_tpu_torch.ops.sketch_general import sketch_general_torch
from ntjoin_tpu_torch.utils import timers

# Host-clock seconds of ``sketch_records_torch`` by stage, accumulated over
# calls (the counterpart of ``sketch_pallas._STAGES``): plan (bounds, and
# the probe of each record's path), pack (host records, and each record's
# encode into its batch buffer), device (upload through the sync on the
# result) and split (per-record split).  Callers clear it.  Each interval
# is a span of ``utils/timers`` (``sketch:<fa>/plan`` and so on, where
# spans are on), and its seconds are the span's own.
STAGES: dict[str, float] = {}

# Per-batch bases: at most ``GENERAL_BYTES_PER_BASE`` a base on the card, so
# 2^28 bases stay under 8 GB.  A larger record gets a batch of its own.
BATCH_BASES = 1 << 28
# Longest record the device takes: the kernels' int32 window indices (the
# JAX package's bound, sketch_pallas.py:2295) and, on a card, three quarters
# of its memory at its path's bytes a base (see record_bound).
MAX_RECORD_BASES = (1 << 31) - (1 << 22)
# Peak device memory of a batch in bytes a base, by path: the most that
# max_memory_allocated rose over a sketch, over its bases (chip_smoke.py
# phase D, one record of 2,143,289,344 bases, on an NVIDIA H100 80GB HBM3 at
# 700 W): fused 11.44 (13.49 on a 50.8 Mbp batch of phase 5), rounded up;
# general 20.13 (20.91 on phase A's 100 Mbp) since its compaction is a
# kernel (25.05 before, then 26), plus the margin 26 gave that, 0.95,
# rounded up.
FUSED_BYTES_PER_BASE = 14
GENERAL_BYTES_PER_BASE = 22


@contextlib.contextmanager
def _stage(name: str):
    """The block as the span ``name``; its seconds added to ``STAGES[name]``."""
    with timers.timed(name) as span:
        yield
    with sc.COUNT_LOCK:
        STAGES[name] = STAGES.get(name, 0.0) + span.s


def record_bound(device: torch.device, general: bool = False) -> int:
    """Bases of the longest record ``sketch_records_torch`` puts on
    ``device`` by the general path (``general``) or the fused one:
    ``MAX_RECORD_BASES``, and on a card no more than three quarters of its
    memory holds at that path's bytes a base."""
    if device.type != "cuda":
        return MAX_RECORD_BASES
    total = torch.cuda.get_device_properties(device).total_memory
    per = GENERAL_BYTES_PER_BASE if general else FUSED_BYTES_PER_BASE
    return min(MAX_RECORD_BASES, 3 * total // 4 // per)


def _host_sketch(codes: np.ndarray, k: int, w: int) -> Sketch:
    if native.available():
        return native.sketch_codes_native(codes, k, w)
    return sketch_codes(codes, k, w)


_EMPTY = Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))


def stream_len(total: int, k: int, w: int) -> int:
    """Bases of the int8 stream ``sketch_fused_torch`` wants for ``total``
    data bases: the chunk layout's C * L k-mer starts and a halo."""
    C, L = sc.layout(total, k, w)
    return C * L + w + k - 2


def join_offsets(lens: np.ndarray, k: int) -> tuple[np.ndarray, int]:
    """Offsets of records of ``lens`` bases joined by max(k - 1, 1) invalid
    bases, and the stream's data bases (each record and its separator)."""
    ends = np.cumsum(np.asarray(lens, dtype=np.int64) + max(k - 1, 1))
    return np.concatenate([[0], ends[:-1]]).astype(np.int64), int(ends[-1])


def pack_batch(batch: list[np.ndarray], k: int,
               w: int) -> tuple[torch.Tensor, int, np.ndarray]:
    """The records joined by max(k - 1, 1) invalid bases into one int8
    stream in host memory, padded with invalid bases to ``stream_len``:
    (stream, its data bases, the records' offsets in it)."""
    offsets, total = join_offsets([c.shape[0] for c in batch], k)
    host = torch.full((stream_len(total, k, w),), CODE_INVALID, dtype=torch.int8)
    hv = host.numpy()
    for o, c in zip(offsets, batch):
        hv[o : o + c.shape[0]] = c
    return host, total, offsets


def _fused(flat, n, starts, k, w, slot_cap, plain):
    return sc.sketch_fused_torch(flat, n, k, w, slot_cap, plain)


def _sketch_batch(host: torch.Tensor, total: int, offsets: np.ndarray, k: int, w: int,
                  device: torch.device, sketch, slot_cap: int | None,
                  plain: bool) -> list[Sketch]:
    """Sketch the joined stream ``host`` (``total`` data bases, records at
    ``offsets``) on the device by ``sketch(flat, n, starts, k, w, slot_cap,
    plain)`` and split the emissions per record."""
    if total - k + 1 < w:
        return [_EMPTY] * len(offsets)
    with _stage("device"):
        flat = host.to(device, non_blocking=True)
        starts = torch.from_numpy(offsets).to(device)
        pos, canon = sketch(flat, total, starts, k, w, slot_cap, plain)
        pos_np = pos.cpu().numpy()
        hashes = u64.as_u64(u64.derive_hash(canon, k))
    with _stage("split"):
        # emissions ascend and records are disjoint ascending ranges
        bounds = np.append(np.searchsorted(pos_np, offsets), pos_np.shape[0])
        return [
            Sketch(positions=pos_np[a:b] - o, hashes=hashes[a:b]) if b > a else _EMPTY
            for o, a, b in zip(offsets, bounds[:-1], bounds[1:])
        ]


def _batches(entries: list[tuple[int, int]], k: int, limit: int) -> list[list]:
    """Entries (index, bases) packed in order into batches of about
    ``limit`` bases (separators included); a longer entry gets a batch of
    its own."""
    batches: list[list[tuple[int, int]]] = []
    acc = 0
    for ent in entries:
        sz = int(ent[1]) + k - 1
        if not batches or acc + sz > limit:
            batches.append([])
            acc = 0
        batches[-1].append(ent)
        acc += sz
    return batches


class CodesList:
    """A list of base-code arrays as a record source: ``lengths``,
    ``codes_into``, ``codes`` and ``clean``, as ``io.native.FastaSource``
    gives them."""

    def __init__(self, arrays):
        self._arrays = [np.asarray(c) for c in arrays]
        self.lengths = np.array([c.shape[0] for c in self._arrays], dtype=np.int64)

    def __len__(self) -> int:
        return len(self._arrays)

    def codes_into(self, i: int, out: np.ndarray) -> None:
        out[:] = self._arrays[i]

    def codes(self, i: int) -> np.ndarray:
        return self._arrays[i]

    def clean(self, i: int, scratch: np.ndarray | None = None) -> bool:
        return not bool((self._arrays[i] >= CODE_INVALID).any())


class Subset:
    """Records ``idx`` of a source, as a source of their own."""

    def __init__(self, source, idx):
        self.source = source
        self.idx = [int(i) for i in idx]
        self.lengths = np.asarray(source.lengths, dtype=np.int64)[self.idx]

    def __len__(self) -> int:
        return len(self.idx)

    def codes_into(self, j: int, out: np.ndarray) -> None:
        self.source.codes_into(self.idx[j], out)

    def codes(self, j: int) -> np.ndarray:
        return self.source.codes(self.idx[j])

    def clean(self, j: int, scratch: np.ndarray | None = None) -> bool:
        return self.source.clean(self.idx[j], scratch)


def as_source(records):
    """``records`` where it is a source (it has ``codes_into``), else a
    ``CodesList`` of the arrays."""
    return records if hasattr(records, "codes_into") else CodesList(records)


_PAGE = 4096


def host_buffer(size: int, pin: bool) -> torch.Tensor:
    """``size`` invalid bases in page-aligned host memory; with ``pin``,
    page-locked for the upload by ``cudaHostRegister``: torch's pinned
    allocator would round a batch of 2^28 bases up to a block of 2^29 and
    keep it cached after the call."""
    raw = np.empty(size + _PAGE, dtype=np.int8)
    start = -raw.ctypes.data % _PAGE
    buf = torch.from_numpy(raw[start : start + size])
    buf.fill_(CODE_INVALID)
    if pin:
        rc = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), size, 0))
        if rc:
            raise RuntimeError(f"cudaHostRegister of {size} bytes failed: cudaError {rc}")
    return buf


def unpin(buf: torch.Tensor) -> None:
    """Undo ``host_buffer``'s page-locking, before the buffer is freed."""
    rc = int(torch.cuda.cudart().cudaHostUnregister(buf.data_ptr()))
    if rc:
        raise RuntimeError(f"cudaHostUnregister failed: cudaError {rc}")


def _plan(src, lengths: np.ndarray, bound: dict):
    """Each record's path, by ``src.clean`` read ``PROBE_BASES`` at a
    time: ({general: [(index, bases)]} of the device records, the indices
    of the host records).  A record longer than its path's bound takes the
    host; the general path's bound is never the larger (more bytes a
    base), so a record longer than the fused bound is not probed."""
    paths: dict[bool, list[tuple[int, int]]] = {False: [], True: []}
    hosts: list[int] = []
    scratch = np.empty(min(int(lengths.max(initial=0)), native.PROBE_BASES), dtype=np.uint8)
    sc.max_count("codes_held_max", scratch.shape[0])
    for i, n in enumerate(lengths.tolist()):
        general = n > bound[False] or not src.clean(i, scratch)
        if n > bound[general]:
            hosts.append(i)
        else:
            paths[general].append((i, n))
    return paths, hosts


def _run_path(src, batches: list, general: bool, k: int, w: int, device: torch.device,
              slot_cap, plain: bool, out: list) -> None:
    """The batches of one path, each record encoded by ``src.codes_into``
    at its offset in one host buffer (pinned on a card) as large as the
    path's largest stream, reused batch after batch."""
    sep = max(k - 1, 1)
    sketch = sketch_general_torch if general else _fused
    joined = [join_offsets([n for _, n in b], k) for b in batches]
    size = max(stream_len(total, k, w) for _, total in joined)
    pin = device.type == "cuda"
    with timers.span("buffer"):
        buf = host_buffer(size, pin)
    sc.max_count("codes_held_max", size)
    view = buf.numpy()
    try:
        for b, (offsets, total) in zip(batches, joined):
            with _stage("pack"):
                for (i, n), o in zip(b, offsets.tolist()):
                    src.codes_into(i, view[o : o + n])
                    view[o + n : o + n + sep] = CODE_INVALID
                end = stream_len(total, k, w)
                view[total:end] = CODE_INVALID
            sc.add_count("general_batches", general)
            got = _sketch_batch(buf[:end], total, offsets, k, w, device, sketch, slot_cap, plain)
            for (i, _), sk in zip(b, got):
                out[i] = sk
    finally:
        if pin:
            with timers.span("buffer"):
                unpin(buf)


def sketch_records_torch(records, k: int, w: int, device: str | torch.device = "cuda", *,
                         slot_cap: int | None = None, plain: bool = False) -> list[Sketch]:
    """Minimizer sketches of many records, bit-identical to
    ``ops.nthash_np.sketch_codes`` on each: N-free records by the fused
    path, records with N runs by the general path, each path in batches of
    its own (``_batches``); a record longer than its path's
    ``record_bound(device)`` whole on the host.  ``slot_cap`` and ``plain``
    pass to ``sketch_fused_torch`` and ``sketch_general_torch``.

    ``records`` is a source (``io.native.FastaSource``, ``Subset``) or a
    list of code arrays.  The call reads each record's path first
    (``clean``), then sketches the host records one at a time, then each
    path's batches, each record encoded straight into the path's batch
    buffer.  It holds one of the probe's block, one batch buffer or one host
    record's codes at a time: the largest of them is raised into
    ``COUNTS["codes_held_max"]``."""
    with _stage("plan"):
        src = as_source(records)
        device = torch.device(device)
        lengths = np.asarray(src.lengths, dtype=np.int64)
        bound = {general: record_bound(device, general) for general in (False, True)}
        out: list[Sketch] = [_EMPTY] * len(lengths)
        paths, hosts = _plan(src, lengths, bound)
        sc.add_count("general_records", len(paths[True]))
    with _stage("pack"):
        for i in hosts:
            sc.max_count("codes_held_max", int(lengths[i]))
            out[i] = _host_sketch(src.codes(i), k, w)
            sc.add_count("host_records")
            sc.add_count("host_records_size")
    for general, entries in paths.items():
        batches = _batches(entries, k, min(BATCH_BASES, bound[general]))
        if batches:
            _run_path(src, batches, general, k, w, device, slot_cap, plain, out)
    return out


def sketch_codes_torch(codes: np.ndarray, k: int, w: int,
                       device: str | torch.device = "cuda", **kw) -> Sketch:
    """Sketch of one record: ``sketch_records_torch([codes])[0]``."""
    return sketch_records_torch([codes], k, w, device, **kw)[0]
