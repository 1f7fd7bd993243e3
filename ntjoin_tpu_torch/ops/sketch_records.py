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
host, decided from its length before any launch and counted in
``COUNTS["host_records"]`` and ``["host_records_size"]``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ntjoin_tpu_torch.constants import CODE_INVALID
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops import u64
from ntjoin_tpu_torch.ops.nthash_np import Sketch, sketch_codes
from ntjoin_tpu_torch.ops.sketch_general import sketch_general_torch

# Host-clock seconds of ``sketch_records_torch`` by stage, accumulated over
# calls (the counterpart of ``sketch_pallas._STAGES``): plan (routes and
# batching), pack (pinned buffer), device (upload through the sync on the
# result) and split (per-record split).  Callers clear it.
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


def _stage(name: str, t0: float) -> float:
    """Add the seconds since t0 to ``STAGES[name]``; returns the clock."""
    t = time.monotonic()
    with sc.COUNT_LOCK:
        STAGES[name] = STAGES.get(name, 0.0) + (t - t0)
    return t


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


def pack_batch(batch: list[np.ndarray], k: int, w: int,
               pin: bool = False) -> tuple[torch.Tensor, int, np.ndarray]:
    """The records joined by max(k - 1, 1) invalid bases into one int8
    stream in host memory (pinned with ``pin``), padded with invalid bases
    to the length ``sketch_fused_torch`` wants: (stream, its data bases, the
    records' offsets in it)."""
    sep = max(k - 1, 1)
    lens = np.array([c.shape[0] for c in batch], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens + sep)[:-1]]).astype(np.int64)
    total = int(offsets[-1] + lens[-1] + sep)
    C, L = sc.layout(total, k, w)
    host = torch.full((C * L + w + k - 2,), CODE_INVALID, dtype=torch.int8, pin_memory=pin)
    hv = host.numpy()
    for o, c in zip(offsets, batch):
        hv[o : o + c.shape[0]] = c
    return host, total, offsets


def _fused(flat, n, starts, k, w, slot_cap, plain):
    return sc.sketch_fused_torch(flat, n, k, w, slot_cap, plain)


def _sketch_batch(batch: list[np.ndarray], k: int, w: int, device: torch.device, sketch,
                  slot_cap: int | None, plain: bool) -> list[Sketch]:
    """Join the records (``pack_batch``), sketch the stream on the device by
    ``sketch(flat, n, starts, k, w, slot_cap, plain)`` and split the
    emissions per record."""
    t0 = time.monotonic()
    host, total, offsets = pack_batch(batch, k, w, pin=device.type == "cuda")
    if total - k + 1 < w:
        return [_EMPTY] * len(batch)
    t0 = _stage("pack", t0)
    flat = host.to(device, non_blocking=True)
    starts = torch.from_numpy(offsets).to(device)
    pos, canon = sketch(flat, total, starts, k, w, slot_cap, plain)
    pos_np = pos.cpu().numpy()
    hashes = u64.as_u64(u64.derive_hash(canon, k))
    t0 = _stage("device", t0)
    # emissions ascend and records are disjoint ascending ranges
    bounds = np.append(np.searchsorted(pos_np, offsets), pos_np.shape[0])
    out = [
        Sketch(positions=pos_np[a:b] - o, hashes=hashes[a:b]) if b > a else _EMPTY
        for o, a, b in zip(offsets, bounds[:-1], bounds[1:])
    ]
    _stage("split", t0)
    return out


def _batches(entries: list[tuple[int, np.ndarray]], k: int, limit: int) -> list[list]:
    """Entries packed in order into batches of about ``limit`` bases
    (separators included); a longer entry gets a batch of its own."""
    batches: list[list[tuple[int, np.ndarray]]] = []
    acc = 0
    for ent in entries:
        sz = int(ent[1].shape[0]) + k - 1
        if not batches or acc + sz > limit:
            batches.append([])
            acc = 0
        batches[-1].append(ent)
        acc += sz
    return batches


def sketch_records_torch(codes_list: list[np.ndarray], k: int, w: int,
                         device: str | torch.device = "cuda", *,
                         slot_cap: int | None = None, plain: bool = False) -> list[Sketch]:
    """Minimizer sketches of many records, bit-identical to
    ``ops.nthash_np.sketch_codes`` on each: N-free records by the fused
    path, records with N runs by the general path, each path in batches of
    its own; a record longer than its path's ``record_bound(device)`` whole
    on the host.  ``slot_cap`` and ``plain`` pass to ``sketch_fused_torch``
    and ``sketch_general_torch``."""
    t0 = time.monotonic()
    device = torch.device(device)
    bound = {general: record_bound(device, general) for general in (False, True)}
    out: list[Sketch] = [_EMPTY] * len(codes_list)
    paths: dict[bool, list[tuple[int, np.ndarray]]] = {False: [], True: []}
    for i, c in enumerate(codes_list):
        c = np.asarray(c)
        general = bool((c >= CODE_INVALID).any())
        if c.shape[0] > bound[general]:
            out[i] = _host_sketch(c, k, w)
            sc.add_count("host_records")
            sc.add_count("host_records_size")
            continue
        paths[general].append((i, c))
    sc.add_count("general_records", len(paths[True]))
    _stage("plan", t0)
    for general, entries in paths.items():
        sketch = sketch_general_torch if general else _fused
        for b in _batches(entries, k, min(BATCH_BASES, bound[general])):
            sc.add_count("general_batches", general)
            got = _sketch_batch([c for _, c in b], k, w, device, sketch, slot_cap, plain)
            for (i, _), sk in zip(b, got):
                out[i] = sk
    return out


def sketch_codes_torch(codes: np.ndarray, k: int, w: int,
                       device: str | torch.device = "cuda", **kw) -> Sketch:
    """Sketch of one record: ``sketch_records_torch([codes])[0]``."""
    return sketch_records_torch([codes], k, w, device, **kw)[0]
