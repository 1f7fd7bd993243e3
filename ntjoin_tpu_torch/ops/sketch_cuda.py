"""Minimizer sketch on an NVIDIA GPU: four CUDA kernels and their plain
PyTorch versions.  Port of ``ntjoin_tpu/ops/sketch_pallas.py``.

Pipeline of one batch (``sketch_fused_torch``):

1. Layout.  Records are joined on the host with k-1 (at least one) invalid
   separator bases into one int8 stream, padded with invalid bases, and copied to the device.
   The stream is cut into C chunks of L k-mer starts; chunk c reads
   ``flat[c*L + r]`` for rows r in [0, L + w + k - 2), so each chunk owns its
   windows whole (the halo of w + k - 2 rows overlaps the next chunk).
2. Hash (kernel 1, ``csrc/hash.cu``): end-indexed canonical ntHash2 and a
   k-mer valid flag, (rows, C).
3. Flags (``csrc/flags.cu``): a window is valid when all w k-mers are; the
   first valid window after an invalid one is forced to emit (a record's
   first window).  Three launches: a 32-bit mask of the invalid rows of each
   32-row tile of a column (the valid flags read once), a max-scan of the
   tiles' last invalid rows down each column, and a walk in which a thread
   owns 16 columns and a segment of windows (``flag_launch``) and carries
   the last invalid row from the tile before it.
4. Window/emission (kernel 2, ``csrc/window_emit.cu``): per-chunk lists of
   emitted (position, canonical hash), bounded by a capacity, plus the true
   per-chunk counts.  Two routes, chosen from w alone (``emit_tile``): tiles
   of 8, 4, 2 or 1 chunks staged in shared memory, the widest that fits
   (w <= 1,014, 2,090, 4,242 and 8,362; the one-chunk tiles of the last band
   spread a chunk's rows over a whole thread block), or, where 3w rows of one
   chunk do not fit there, the device-memory route
   (``csrc/window_emit_gmem.cu``): a thread block per tile of up to 8 chunks
   whose threads split each segment's rows and read them from device memory,
   L2 serving the repeats.
5. Compaction (torch): exclusive cumsum of the counts and one gather.
6. For the chunks whose list overflowed, the exact window op (kernel 3,
   ``csrc/window.cu``: a thread block per chunk and block of w windows, the
   same split of the rows) gives every window's argmin; their emission mask is
   compacted with ``torch.nonzero`` and merged into the stream.

Emissions come out in stream order; a chunk's first window repeats the
previous chunk's last argmin at most once, and that duplicate is dropped.
Steps 3-6 (``window_stream``) also serve the general path of records with
N runs (``ops/sketch_general.py``), on the stream of their valid k-mers.
``ops/sketch_records.py`` joins records into batches and picks the path.

Hashes are int64 tensors holding the uint64 bits (see ``u64``).  Each kernel
wrapper runs the plain version for a CPU tensor and launches its kernel for a
CUDA tensor; the kernels are built with nvcc on first use into ``_build/``.
On the card the (rows, C) hash and flag arrays are views of buffers whose
row pitch is C rounded up to ``PITCH`` columns (``pitched``), so that rows
start on 128-byte boundaries and kernel 2 can stage them by 16-byte
asynchronous copies; the plain versions see the same (rows, C) views.
"""
from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
import time

import numpy as np
import torch

from ntjoin_tpu_torch.constants import CODE_INVALID, SEEDS, SROL_PERIOD
from ntjoin_tpu_torch.ops import u64

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
LIB_PATH = os.path.join(_PKG, "_build", "libntjoin_cuda.so")

# Kernel launches by op, calls of each op's plain version, records the host
# sketcher took whole (``host_records``; of them, those too long for the
# device, ``host_records_size``), records and batches of the general path
# (``ops/sketch_records.py``), and runs of the exact window path.  Plain
# counters so that a run can show which code served it; ``reset_counts``
# zeroes them.  The sketch runs ``hash``, ``flags`` (``FLAG_LAUNCHES`` an
# op: summary, scan, walk), one of the two window/emission routes and
# ``window``, and the general path also
# ``stream``, its compaction (``ops/sketch_general.py``, four launches a
# batch: count, gather, chunks, decode); the copy (``ops/membw.py``) serves
# the profiler, ``mk_s`` the Mann-Kendall S of ``mkt=True``
# (``ops/mannkendall.py``).  ``codes_held_max`` is no count but the most
# code bytes a ``sketch_records_torch`` call held at once (its batch
# buffer, probe block or host record, one at a time), raised by
# ``max_count``.
# ``add_count`` adds under a lock: a mesh of several devices sketches from a
# thread a device (``parallel/mesh.py``).
KERNELS = ("hash", "flags", "window_emit", "window_emit_gmem", "window", "copy", "stream",
           "mk_s")
# each has one plain version
_OPS = ("hash", "flags", "window_emit", "window", "copy", "stream", "mk_s")
COUNTS: dict[str, int] = {}
COUNT_LOCK = threading.Lock()


def add_count(name: str, n: int = 1) -> None:
    with COUNT_LOCK:
        COUNTS[name] += n


def max_count(name: str, value: int) -> None:
    """Raise ``COUNTS[name]`` to ``value`` where it is lower."""
    with COUNT_LOCK:
        COUNTS[name] = max(COUNTS[name], value)


def reset_counts() -> None:
    COUNTS.clear()
    for name in KERNELS:
        COUNTS[name] = 0
    for name in _OPS:
        COUNTS[name + "_plain"] = 0
    COUNTS["host_records"] = 0
    COUNTS["host_records_size"] = 0
    COUNTS["general_records"] = 0
    COUNTS["general_batches"] = 0
    COUNTS["exact_runs"] = 0
    COUNTS["codes_held_max"] = 0


reset_counts()

# Chunks: at least 4 halos of windows per chunk (halo work under 25%), and no
# more chunks than the card can use threads for.
_MAX_CHUNKS = 1 << 16


# -- seed tables and the JAX package's chunk layout ----------------------------


def seed_tables(k: int) -> np.ndarray:
    """(4, 4) int64 tables indexed by base code, rows (seed_in, seed_out,
    seed_rc_out_rot, seed_rc_in): the same pre-rotated terms as
    ``sketch_pallas._tables``, so both recurrences are
    ``state = rot1(state) ^ m``."""
    seed = _seeds()
    rc = seed.flip(0)  # seed of the complement base 3 - c
    return torch.stack([
        seed, u64.srol_n(seed, k), u64.srol_n(rc, SROL_PERIOD - 1), u64.srol_n(rc, k - 1),
    ]).numpy()


def _seeds() -> torch.Tensor:
    """The four base seeds (A, C, G, T) as int64."""
    return torch.tensor([u64.s64(v) for v in SEEDS], dtype=torch.int64)


def from_jax_chunks(lo, hi) -> torch.Tensor:
    """JAX uint32 lo/hi planes (rows, SUB, LANE) -> int64 (rows, SUB*LANE)."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    x = (lo | (hi << np.uint64(32))).view(np.int64)
    return torch.from_numpy(x.reshape(x.shape[0], -1).copy())


def to_jax_chunks(x: torch.Tensor, lane: int = 128):
    """Inverse of ``from_jax_chunks``: int64 (rows, C) -> uint32 lo, hi of
    shape (rows, C // lane, lane)."""
    u = u64.as_u64(x).reshape(x.shape[0], -1, lane)
    return (u & np.uint64(0xFFFFFFFF)).astype(np.uint32), (u >> np.uint64(32)).astype(np.uint32)


# -- building and loading the kernels ------------------------------------------

_LIB = None
_TABLES: dict[tuple[int, torch.device], torch.Tensor] = {}


def build() -> tuple[float, str]:
    """Compile ``csrc/*.cu`` with nvcc into ``LIB_PATH`` unless the library is
    newer than every source: one nvcc per source, all started together, then
    one link.  Returns (seconds spent, nvcc's report)."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    deps = srcs + glob.glob(os.path.join(_CSRC, "*.cuh"))
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
        os.path.getmtime(p) for p in deps
    ):
        return 0.0, ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit found")
    out_dir = os.path.dirname(LIB_PATH)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a"]
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.basename(p)}.{tag}.o") for p in srcs]
    t0 = time.monotonic()
    procs = [
        subprocess.Popen(
            [*nvcc, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC", "-c", "-o", o, p],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p, o in zip(srcs, objs)
    ]
    logs = [proc.communicate()[1] for proc in procs]  # waits for every compiler
    try:
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
        tmp = f"{LIB_PATH}.{tag}"
        res = subprocess.run([*nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return time.monotonic() - t0, "".join(logs)


def _lib():
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        sigs = {
            "nj_hash": [p, i64, i64, i64, i32, p, p, i64, p, i64, p],
            "nj_window_emit": [p, i64, p, i64, i64, i64, i32, i64, i64, i32, p, p, p, p],
            "nj_window_emit_gmem": [p, i64, p, i64, i64, i64, i32, i64, i64, i32, i32, p, p,
                                    p, p],
            "nj_window": [p, i64, i64, i32, i64, p, i64, i32, i32, p, p],
            "nj_flags": [p, i64, i64, i64, i32, p, i64, p, i64, p],
            "nj_flags_summary": [p, i64, i64, i64, p, i64, p],
            "nj_flags_scan": [p, i64, i64, p, p],
            "nj_flags_walk": [p, p, i64, i64, i64, i32, p, i64, p],
            "nj_copy": [p, p, i64, p],
            "nj_stream_count": [p, i64, i64, i64, i64, i64, p, i64, p, p],
            "nj_stream_gather": [p, i64, p, i64, i64, i64, i64, i64, p, i64, p, p, p, p],
            "nj_stream_chunks": [p, p, i64, i64, i64, i32, p, i64, p, i64, p],
            "nj_stream_decode": [p, i64, i64, i64, i64, i64, p, i64, p, p, i64, p, p],
            "nj_mk_s": [p, i64, i64, p, i32, i64, i64, p, p, p],
            "nj_noop": [p],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def _launched(err: int, name: str) -> None:
    _raise_on(err, name)
    add_count(name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape}, got "
            f"{'' if t.is_contiguous() else 'non-contiguous '}{t.dtype} {tuple(t.shape)}"
        )


def _check_rows(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """A (rows, C) array whose rows may be pitched: unit column stride."""
    if (t.dtype != dtype or tuple(t.shape) != shape or t.stride(1) != 1
            or t.stride(0) < shape[1]):
        raise ValueError(f"{name}: want {dtype} {shape} with unit column stride, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# -- layout ---------------------------------------------------------------------


def layout(n: int, k: int, w: int) -> tuple[int, int]:
    """(C, L) for a stream of n bases: L k-mer starts per chunk, with at
    least 4 halos (w + k - 2 rows) per chunk where the input allows."""
    nk = max(n - k + 1, 1)
    c = max(1, min(_MAX_CHUNKS, nk // (4 * max(w + k - 2, 1))))
    return c, -(-nk // c)


def _slot_cap(L: int, w: int) -> int:
    """Per-chunk emission capacity: about 4 emissions per w windows at the
    densest for non-repeat sequence (~2 on average), plus forced record
    starts."""
    return 4 * -(-L // w) + 16


# Row pitch of the device arrays, in columns: 128 bytes of int64 hashes.
PITCH = 16


def pitched(rows: int, C: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Uninitialised (rows, C) view of a buffer whose row pitch is C rounded
    up to ``PITCH`` columns."""
    return torch.empty((rows, -(-C // PITCH) * PITCH), dtype=dtype, device=device)[:, :C]


def _chunk_view(flat: torch.Tensor, L: int, C: int, rows: int) -> torch.Tensor:
    """(rows, C) view of the stream: column c, row r is flat[c*L + r]."""
    return flat.as_strided((rows, C), (1, L))


# -- op 1: hash -----------------------------------------------------------------


def hash_chunked_ref(codes_rc: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 1: int8 codes (rows, C) -> end-indexed
    canonical hash (int64) and k-mer valid flag (int8), both (rows, C).

    Closed form instead of the recurrence: with invalid bases seeded 0, the
    rolling state at row r is the xor over the k bases ending at r of
    ``srol^(k-1-t)(seed[b])`` (forward) and ``srol^t(seed[3-b])`` (reverse),
    t the base's offset in the k-mer; rows before 0 contribute nothing.
    """
    add_count("hash_plain")
    rows, C = codes_rc.shape
    dev = codes_rc.device
    code = codes_rc.to(torch.uint8).long().clamp_(max=CODE_INVALID)
    pad = torch.full((k - 1, C), CODE_INVALID, dtype=torch.long, device=dev)
    cp = torch.cat([pad, code])  # cp[r + t] = base at offset t of the k-mer ending at r
    zero = torch.zeros(1, dtype=torch.int64)  # the seed of an invalid base
    seed = torch.cat([_seeds(), zero])
    rc = torch.cat([_seeds().flip(0), zero])
    fwd = torch.zeros((rows, C), dtype=torch.int64, device=dev)
    rev = torch.zeros_like(fwd)
    for t in range(k):
        b = cp[t : t + rows]
        fwd ^= u64.srol_n(seed, k - 1 - t).to(dev)[b]
        rev ^= u64.srol_n(rc, t).to(dev)[b]
    bad = torch.cat([torch.ones((k - 1, C), dtype=torch.int32, device=dev),
                     (code == CODE_INVALID).to(torch.int32)])
    cs = torch.cat([torch.zeros((1, C), dtype=torch.int32, device=dev),
                    bad.cumsum(0, dtype=torch.int32)])
    val = (cs[k : k + rows] == cs[:rows]).to(torch.int8)
    return fwd + rev, val


def hash_chunked(flat: torch.Tensor, L: int, C: int, rows: int,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Op 1 on the int8 stream ``flat`` (length >= (C-1)*L + rows): kernel
    1 for a CUDA tensor, ``hash_chunked_ref`` of the chunk view for a CPU
    one.  On the card both outputs are ``pitched``."""
    if flat.dim() != 1 or flat.shape[0] < (C - 1) * L + rows:
        raise ValueError(f"stream of {tuple(flat.shape)} too short for C={C} L={L} rows={rows}")
    if not _on_cuda(flat):
        return hash_chunked_ref(_chunk_view(flat, L, C, rows), k)
    _check(flat, torch.int8, (flat.shape[0],), "hash_chunked flat")
    dev = flat.device
    key = (k, dev)
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(seed_tables(k)).to(dev)
    h = pitched(rows, C, torch.int64, dev)
    val = pitched(rows, C, torch.int8, dev)
    with torch.cuda.device(dev):
        err = _lib().nj_hash(flat.data_ptr(), L, C, rows, k, _TABLES[key].data_ptr(),
                             h.data_ptr(), h.stride(0), val.data_ptr(), val.stride(0),
                             _stream(flat))
    _launched(err, "hash")
    return h, val


# -- window ops -------------------------------------------------------------------


def _argmin_core(h: torch.Tensor, L: int, w: int, off: int,
                 chunks: torch.Tensor) -> torch.Tensor:
    """Leftmost (unsigned hash, position) argmin of every window of the
    listed chunks, by log-step doubling: level m holds the lexmin of
    [i, i + 2^m); lexmin is idempotent, so two overlapping power-of-two spans
    cover w."""
    n_el = L + w - 1
    key = h[off : off + n_el][:, chunks]
    pos = torch.arange(n_el, dtype=torch.int64, device=h.device)[:, None] + chunks * L
    span = 1
    while 2 * span <= w:
        n = key.shape[0] - span
        a_k, b_k, a_p, b_p = key[:n], key[span : span + n], pos[:n], pos[span : span + n]
        take_b = u64.ult(b_k, a_k) | ((b_k == a_k) & (b_p < a_p))
        key = torch.where(take_b, b_k, a_k)
        pos = torch.where(take_b, b_p, a_p)
        span *= 2
    a_k, a_p = key[:L], pos[:L]
    b_k, b_p = key[w - span : w - span + L], pos[w - span : w - span + L]
    take_b = u64.ult(b_k, a_k) | ((b_k == a_k) & (b_p < a_p))
    return torch.where(take_b, b_p, a_p)


def _emit_mask(am: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Window emits: valid, and forced or its argmin moved."""
    prev = torch.cat([torch.full_like(am[:1], -1), am[:-1]])
    return ((flags & 1) != 0) & (((flags & 2) != 0) | (am != prev))


def _hash_at(h: torch.Tensor, pos: torch.Tensor, chunk: torch.Tensor, L: int,
             off: int) -> torch.Tensor:
    return h[pos - chunk * L + off, chunk]


def _all_chunks(h: torch.Tensor) -> torch.Tensor:
    return torch.arange(h.shape[1], dtype=torch.int64, device=h.device)


def window_argmin_ref(h: torch.Tensor, L: int, w: int, off: int,
                      chunks: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel 3: (L, len(chunks)) int64 stream position
    c*L + s of the leftmost minimal hash of every window of each listed
    chunk c (elements at rows off + s); all chunks by default."""
    add_count("window_plain")
    return _argmin_core(h, L, w, off, _all_chunks(h) if chunks is None else chunks)


def window_emit_ref(h: torch.Tensor, flags: torch.Tensor, L: int, w: int, off: int,
                    cap: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 2: per-chunk emission lists (pos, hash), each
    (cap, C) and padded with -1 / 0, and the true per-chunk counts (C,)."""
    add_count("window_emit_plain")
    C = h.shape[1]
    am = _argmin_core(h, L, w, off, _all_chunks(h))
    emit = _emit_mask(am, flags)
    count = emit.sum(0)
    rank = emit.cumsum(0) - 1
    row, chunk = torch.nonzero(emit & (rank < cap), as_tuple=True)
    pos = torch.full((cap, C), -1, dtype=torch.int64, device=h.device)
    hsh = torch.zeros((cap, C), dtype=torch.int64, device=h.device)
    slot = rank[row, chunk]
    p = am[row, chunk]
    pos[slot, chunk] = p
    hsh[slot, chunk] = _hash_at(h, p, chunk, L, off)
    return pos, hsh, count


# Longest window of the window ops: the kernels that read their rows from
# device memory keep 24 bytes of shared memory for every 4,096 rows of a
# one-chunk tile's segment (``sub_bytes`` in csrc/vanherk.cuh).
MAX_WINDOW = 1 << 25


def _check_window_args(h: torch.Tensor, L: int, w: int, off: int) -> None:
    if h.dim() != 2 or h.shape[0] < off + L + w - 1:
        raise ValueError(f"hash rows {tuple(h.shape)} < off + L + w - 1 = {off + L + w - 1}")
    if L + w >= 1 << 31:
        raise ValueError(f"chunk length L={L} too long for int32 window indices")
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"window w={w} outside [1, {MAX_WINDOW}]")


# Shared memory a block may ask for on an H100 (227 KB).
_SMEM_MAX = 232_448


def emit_groups(tile: int) -> int:
    """Row groups (working threads) per chunk of a tile of ``tile`` chunks
    (``kGroupsOf`` in csrc/window_emit.cu): a one-chunk tile spreads its
    chunk's rows over four times as many threads."""
    return 256 if tile == 1 else 64


def emit_tile(w: int) -> int:
    """Chunks per thread block of kernel 2's shared-memory route for window
    w: the widest of 8, 4, 2, 1 whose three w-row segments, per-window
    argmins and flags fit in a block's shared memory (the layout of
    ``tile_smem_bytes`` in csrc/window_emit.cu), or 0 where none does and
    the device-memory route serves."""
    for tile in (8, 4, 2, 1):
        g = emit_groups(tile) * tile
        if 27 * w * tile + 26 * g + 8 * tile <= _SMEM_MAX:
            return tile
    return 0


# The kernels that read their rows from device memory (kernel 3 and kernel
# 2's device-memory route; csrc/vanherk.cuh, namespace split): a thread holds
# ``SPLIT_ROWS`` rows of a segment in registers, a thread block has at most
# ``SPLIT_MAX_THREADS`` threads, and a tile is a power of two of chunks up
# to 32.
SPLIT_ROWS = 8
SPLIT_MAX_THREADS = 512
# Kernel 2's device-memory route walks a chunk's blocks of windows in order,
# pass after pass: smaller thread blocks, more of them an SM, overlap one
# block's scans with another's loads (measured: PERF.md).  Threads a block
# for a tile of several chunks, and for a tile of one.
_GMEM_THREADS = (128, 256)
# Dynamic shared memory a split kernel may take for its sub-tile minima (24
# bytes a pass and chunk), beside its static arrays.
_SPLIT_SUB_MAX = 200_000


def split_threads(w: int, tile: int, most: int = SPLIT_MAX_THREADS) -> int:
    """Threads of a block that splits the w rows of a segment of ``tile``
    chunks: one per ``SPLIT_ROWS`` rows and chunk, in whole warps, at most
    ``most`` (longer segments take several passes)."""
    return min(most, -(-(-(-w // SPLIT_ROWS) * tile) // 32) * 32)


def _split_launch(w: int, n_chunks: int, tiles: tuple, fill: int,
                  most: tuple[int, int]) -> tuple[int, int]:
    """(tile, threads) of a split kernel over ``n_chunks`` neighbouring
    chunks: the widest of ``tiles`` that leaves at least ``fill`` thread
    blocks and whose passes' minima fit in shared memory, with at most
    ``most[0]`` threads; else one chunk a thread block with at most
    ``most[1]``, or as many as it takes to fit."""
    for tile in tiles:
        threads = split_threads(w, tile, most[0])
        passes = -(-w // (threads // tile * SPLIT_ROWS))
        if -(-n_chunks // tile) >= fill and 24 * passes * tile <= _SPLIT_SUB_MAX:
            return tile, threads
    fits = 24 * -(-w // (most[1] * SPLIT_ROWS)) <= _SPLIT_SUB_MAX
    return 1, split_threads(w, 1, most[1] if fits else SPLIT_MAX_THREADS)


def gmem_launch(C: int, w: int, dev: torch.device) -> tuple[int, int]:
    """(chunks, threads) per thread block of kernel 2's device-memory route:
    the hashes of neighbouring chunks share a row's sectors, so the widest
    of 8, 4, 2, 1 that still gives every SM two thread blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _split_launch(w, C, (8, 4, 2), 2 * sms, _GMEM_THREADS)


def argmin_launch(C: int, w: int, dev: torch.device) -> tuple[int, int]:
    """(chunks, threads) per thread block of kernel 3 over all chunks: 32
    neighbouring chunks make a row's reads and writes whole 256-byte runs, so
    the widest of 32, 16, 8, 4 that still gives every other SM a thread
    block."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    most = (SPLIT_MAX_THREADS, SPLIT_MAX_THREADS)
    return _split_launch(w, C, (32, 16, 8, 4), sms // 2, most)


# The flag kernel (``csrc/flags.cu``), three launches an op: its walk gives a
# thread 16 columns (a 16-byte store of a flag row) and ``FLAG_ROWS``
# windows, ``FLAG_THREADS`` a block, the kernel's kWalkRows and
# kWalkThreads: 32 windows, one tile's ends, and 128 threads were the
# fastest at every shape measured on an H100 (8-256 windows, 128-512
# threads; ``split_bench variant DIR flagrows=N flagthreads=N``).
FLAG_TILE = 32
FLAG_COLS = 16
FLAG_THREADS = 128
FLAG_ROWS = 32
FLAG_LAUNCHES = 3


def flag_scratch(C: int, L: int, w: int) -> tuple[int, int]:
    """(tiles, pitch) of the flag kernel's masks and P: a row a 32-row tile
    of the L + w - 1 elements, C rounded up to 128 columns."""
    return -(-(L + w - 1) // FLAG_TILE), -(-C // 128) * 128


def _flag_segs(L: int, w: int, rows: int) -> tuple[int, int]:
    """(first element, count) of the walk's segments (``flag_segments``)."""
    base = (w - 1) // FLAG_TILE * FLAG_TILE
    return base, -(-(L + w - 1 - base) // rows)


def flag_segments(L: int, w: int, rows: int) -> np.ndarray:
    """(segments, 2) [j0, j1) windows of the flag kernel's walk threads: the
    elements where windows end (w - 1 .. L + w - 2) cut into runs of
    ``rows`` from the start of the tile of w - 1, so that a run of 32 reads
    the masks of one tile."""
    base, n = _flag_segs(L, w, rows)
    s0 = base + rows * np.arange(n, dtype=np.int64)
    return np.stack([np.maximum(s0, w - 1), np.minimum(s0 + rows, L + w - 1)], 1) - (w - 1)


def flag_launch(C: int, L: int, w: int) -> tuple[int, int]:
    """(rows, blocks) of the flag kernel's walk: a thread owns 16
    neighbouring columns and a segment of up to ``FLAG_ROWS`` windows
    (``flag_segments``).  The thread count follows the windows times the
    columns, never w alone: a thread reads no halo."""
    groups = -(-C // FLAG_COLS)
    return FLAG_ROWS, -(-groups * _flag_segs(L, w, FLAG_ROWS)[1] // FLAG_THREADS)


def _emit_outputs(cap: int, C: int, dev: torch.device):
    return (torch.empty((cap, C), dtype=torch.int64, device=dev),
            torch.empty((cap, C), dtype=torch.int64, device=dev),
            torch.empty((C,), dtype=torch.int64, device=dev))


def _window_emit_tile(h, flags, L: int, w: int, off: int, cap: int, tile: int):
    """Kernel 2's shared-memory route on checked CUDA tensors."""
    for name, t in (("hash", h), ("flag", flags)):
        if t.stride(0) % PITCH or t.data_ptr() % 16:
            raise ValueError(f"window_emit: {name} rows need a pitch that is a multiple of "
                             f"{PITCH} columns (see pitched), got stride {t.stride(0)}")
    C = h.shape[1]
    pos, hsh, count = _emit_outputs(cap, C, h.device)
    with torch.cuda.device(h.device):
        err = _lib().nj_window_emit(
            h.data_ptr(), h.stride(0), flags.data_ptr(), flags.stride(0), L, C, w, off, cap,
            tile, pos.data_ptr(), hsh.data_ptr(), count.data_ptr(), _stream(h),
        )
    _launched(err, "window_emit")
    return pos, hsh, count


def _window_emit_gmem(h, flags, L: int, w: int, off: int, cap: int):
    """Kernel 2's device-memory route on checked CUDA tensors."""
    C = h.shape[1]
    tile, threads = gmem_launch(C, w, h.device)
    pos, hsh, count = _emit_outputs(cap, C, h.device)
    with torch.cuda.device(h.device):
        err = _lib().nj_window_emit_gmem(
            h.data_ptr(), h.stride(0), flags.data_ptr(), flags.stride(0), L, C, w, off, cap,
            tile, threads, pos.data_ptr(), hsh.data_ptr(), count.data_ptr(),
            _stream(h),
        )
    _launched(err, "window_emit_gmem")
    return pos, hsh, count


def window_emit(h: torch.Tensor, flags: torch.Tensor, L: int, w: int, off: int,
                cap: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Op 2: kernel 2 for CUDA tensors (its shared-memory route where
    ``emit_tile(w)`` is not 0, counted as ``window_emit``; else its
    device-memory route, counted as ``window_emit_gmem``),
    ``window_emit_ref`` for CPU ones.  The shared-memory route wants ``h``
    as ``pitched`` makes it."""
    _check_window_args(h, L, w, off)
    if not _on_cuda(h):
        return window_emit_ref(h, flags, L, w, off, cap)
    _check_rows(h, torch.int64, tuple(h.shape), "window_emit h")
    _check_rows(flags, torch.int8, (L, h.shape[1]), "window_emit flags")
    if flags.device != h.device:
        raise ValueError(f"flags on {flags.device}, hashes on {h.device}")
    tile = emit_tile(w)
    if tile:
        return _window_emit_tile(h, flags, L, w, off, cap, tile)
    return _window_emit_gmem(h, flags, L, w, off, cap)


def window_argmin(h: torch.Tensor, L: int, w: int, off: int,
                  chunks: torch.Tensor | None = None) -> torch.Tensor:
    """Op 3 over the listed chunks (all by default): kernel 3 for CUDA
    tensors, ``window_argmin_ref`` for CPU ones.  A list is taken as
    scattered: one chunk, and one of its blocks of w windows, a thread block.
    All chunks go up to 32 to a thread block, which reads and writes whole
    runs of a row and walks the chunks' blocks of windows in order."""
    _check_window_args(h, L, w, off)
    if not _on_cuda(h):
        return window_argmin_ref(h, L, w, off, chunks)
    _check_rows(h, torch.int64, tuple(h.shape), "window_argmin h")
    dev = h.device
    if chunks is None:
        n_sel, listed = h.shape[1], None
        tile, threads = argmin_launch(n_sel, w, dev)
    else:
        n_sel, listed, tile, threads = chunks.shape[0], chunks.data_ptr(), 1, split_threads(w, 1)
        _check(chunks, torch.int64, (n_sel,), "window_argmin chunks")
        if chunks.device != dev:
            raise ValueError(f"chunks on {chunks.device}, hashes on {dev}")
    am = torch.empty((L, n_sel), dtype=torch.int64, device=dev)
    if n_sel == 0:
        return am
    with torch.cuda.device(dev):
        err = _lib().nj_window(h.data_ptr(), L, h.stride(0), w, off, listed, n_sel, tile,
                               threads, am.data_ptr(), _stream(h))
    _launched(err, "window")
    return am


# -- the fused batch sketch ---------------------------------------------------------


def _padded(t: torch.Tensor) -> torch.Tensor:
    """The whole buffer behind a ``pitched`` view, pad columns included (they
    hold whatever the allocation held); any other tensor as it is."""
    rows, C = t.shape
    pitch = t.stride(0)
    if (t.stride(1) == 1 and pitch > C and pitch % PITCH == 0 and t.storage_offset() == 0
            and t.untyped_storage().nbytes() >= rows * pitch * t.element_size()):
        return t.as_strided((rows, pitch), (pitch, 1))
    return t


def window_flags_ref(val: torch.Tensor, L: int, w: int, off: int) -> torch.Tensor:
    """Plain version of the flag kernel.  (L, C) int8: bit0 = all w k-mers of
    the window valid, bit1 = first valid window after an invalid one (a
    record's first window); val (rows, C) int8 holds 1 for a valid k-mer, the
    window's first at row off + j.  For a ``pitched`` val the pass runs over
    the whole buffer, so the flags come out pitched alike."""
    add_count("flags_plain")
    n_cols = val.shape[1]
    val = _padded(val)
    C = val.shape[1]
    v = val[off : off + L + w - 1].to(torch.int32)
    cs = torch.cat([torch.zeros((1, C), dtype=torch.int32, device=val.device),
                    v.cumsum(0, dtype=torch.int32)])
    valid = (cs[w : w + L] - cs[:L]) == w
    first = valid.clone()
    first[1:] &= ~valid[:-1]
    return (valid.to(torch.int8) | (first.to(torch.int8) << 1))[:, :n_cols]


def flag_summary_ref(val: torch.Tensor, L: int, w: int, off: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flag kernel's first two passes over the
    L + w - 1 elements of each column (element e at row off + e), both
    (tiles, C) int32 with a row a 32-row tile: the masks, bit r set where
    element 32t + r is invalid (0 in val; none past the elements), and P,
    the last invalid element of tiles 0 .. t (-1: none)."""
    n_el = L + w - 1
    C = val.shape[1]
    T = flag_scratch(C, L, w)[0]
    dev = val.device
    bad = torch.zeros((T * FLAG_TILE, C), dtype=torch.bool, device=dev)
    bad[:n_el] = val[off : off + n_el] == 0
    bad = bad.view(T, FLAG_TILE, C)
    r = torch.arange(FLAG_TILE, device=dev).view(1, FLAG_TILE, 1)
    bits = (bad.to(torch.int64) << r).sum(1)
    masks = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)
    tile = torch.arange(T, dtype=torch.int32, device=dev).view(T, 1, 1)
    at = r.to(torch.int32) + FLAG_TILE * tile
    last = torch.where(bad, at, -1).amax(1)
    return masks, torch.cummax(last, 0).values


def _check_flag_val(val: torch.Tensor) -> None:
    """The flag kernel's 16-byte loads: val rows ``pitched``, 16-byte aligned."""
    _check_rows(val, torch.int8, tuple(val.shape), "window_flags val")
    if val.stride(0) % PITCH or val.data_ptr() % 16:
        raise ValueError(f"window_flags: val rows need a pitch that is a multiple of {PITCH} "
                         f"columns and a 16-byte aligned start (see pitched), got stride "
                         f"{val.stride(0)}, address {val.data_ptr()} % 16 = "
                         f"{val.data_ptr() % 16}")


def _flag_masks(val: torch.Tensor, L: int, w: int, off: int) -> torch.Tensor:
    """The flag kernel's summary pass on a checked CUDA val: the masks,
    (tiles, pitch) int32."""
    C, dev = val.shape[1], val.device
    T, m_pitch = flag_scratch(C, L, w)
    masks = torch.empty((T, m_pitch), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().nj_flags_summary(val.data_ptr() + off * val.stride(0), val.stride(0),
                                      L + w - 1, C, masks.data_ptr(), m_pitch, _stream(val))
    _launched(err, "flags")
    return masks


def _flag_scan(masks: torch.Tensor) -> torch.Tensor:
    """The flag kernel's scan pass: P from the masks."""
    P = torch.empty_like(masks)
    with torch.cuda.device(masks.device):
        err = _lib().nj_flags_scan(masks.data_ptr(), masks.shape[1], masks.shape[0],
                                   P.data_ptr(), _stream(masks))
    _launched(err, "flags")
    return P


def _flag_walk(masks: torch.Tensor, P: torch.Tensor, C: int, L: int, w: int) -> torch.Tensor:
    """The flag kernel's walk alone (for its time; ``window_flags`` launches
    the three passes through one call): the flags, ``pitched``."""
    dev = masks.device
    flags = pitched(L, C, torch.int8, dev)
    with torch.cuda.device(dev):
        err = _lib().nj_flags_walk(masks.data_ptr(), P.data_ptr(), masks.shape[1], L, C, w,
                                   flags.data_ptr(), flags.stride(0), _stream(masks))
    _launched(err, "flags")
    return flags


def _check_flag_args(val: torch.Tensor, L: int, w: int, off: int) -> None:
    if val.dim() != 2 or val.shape[0] < off + L + w - 1:
        raise ValueError(f"valid rows {tuple(val.shape)} < off + L + w - 1 = {off + L + w - 1}")
    if w < 1 or L + w >= 1 << 31:
        raise ValueError(f"window w={w}, chunk length L={L}: want w >= 1 and L + w < 2^31")


def flag_summary(val: torch.Tensor, L: int, w: int, off: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The masks and P of ``flag_summary_ref``, (tiles, C): the flag kernel's
    summary and scan passes for a CUDA tensor (each launch counted in
    ``flags``), the plain version for a CPU one."""
    _check_flag_args(val, L, w, off)
    if not _on_cuda(val):
        return flag_summary_ref(val, L, w, off)
    _check_flag_val(val)
    masks = _flag_masks(val, L, w, off)
    C = val.shape[1]
    return masks[:, :C], _flag_scan(masks)[:, :C]


def window_flags(val: torch.Tensor, L: int, w: int, off: int) -> torch.Tensor:
    """The window flags of ``window_flags_ref``: the flag kernel for a CUDA
    tensor (the flags come out ``pitched``; its ``FLAG_LAUNCHES`` launches,
    made by one call into the library, each count in ``flags``), the plain
    version for a CPU one."""
    _check_flag_args(val, L, w, off)
    if not _on_cuda(val):
        return window_flags_ref(val, L, w, off)
    _check_flag_val(val)
    C, dev = val.shape[1], val.device
    flags = pitched(L, C, torch.int8, dev)
    if L == 0:
        return flags
    T, m_pitch = flag_scratch(C, L, w)
    scratch = torch.empty((2, T, m_pitch), dtype=torch.int32, device=dev)  # masks, P
    with torch.cuda.device(dev):
        err = _lib().nj_flags(val.data_ptr() + off * val.stride(0), val.stride(0), L, C, w,
                              scratch.data_ptr(), m_pitch, flags.data_ptr(), flags.stride(0),
                              _stream(val))
    _raise_on(err, "flags")
    add_count("flags", FLAG_LAUNCHES)  # the three passes, launched by the one call
    return flags


def _compact_lists(pos: torch.Tensor, hsh: torch.Tensor, count: torch.Tensor, total: int):
    """Per-chunk lists -> one stream in (chunk, slot) order."""
    C = pos.shape[1]
    incl = count.cumsum(0)
    q = torch.arange(total, dtype=torch.int64, device=pos.device)
    chunk = torch.searchsorted(incl, q, right=True)
    src = (q - (incl - count)[chunk]) * C + chunk
    return pos.reshape(-1)[src], hsh.reshape(-1)[src]


def _compact_exact(am: torch.Tensor, flags: torch.Tensor, h: torch.Tensor,
                   chunks: torch.Tensor, L: int, off: int):
    """Every window's argmin of the listed chunks -> their emissions in
    (chunk, window) order."""
    i, j = torch.nonzero(_emit_mask(am, flags[:, chunks]).t(), as_tuple=True)
    pos = am[j, i]
    return pos, _hash_at(h, pos, chunks[i], L, off)


def sketch_fused_torch(flat: torch.Tensor, n: int, k: int, w: int,
                       slot_cap: int | None = None, plain: bool = False,
                       stop_after: str | None = None) -> tuple[torch.Tensor, ...]:
    """Sketch the stream ``flat`` (int8 codes on the device, its first n
    bases the data, invalid bases after, length >= C*L + w + k - 2 for
    ``layout(n, k, w)``).

    Returns (positions, canonical hashes) of every emission, int64, in
    stream order with chunk-seam duplicates dropped (``window_stream``).
    ``slot_cap`` overrides the per-chunk emission capacity; ``plain`` runs
    the plain versions of the ops even on a CUDA device.

    ``stop_after`` cuts the pipeline short for the profiler, as
    ``sketch_pallas._sketch_fused``'s hook does: ``"hash"`` returns op 1's
    (hashes, valid flags), ``"window"`` op 2's (positions, hashes, counts)
    before compaction.
    """
    if stop_after not in (None, "hash", "window"):
        raise ValueError(f"stop_after={stop_after!r}: want None, 'hash' or 'window'")
    C, L = layout(n, k, w)
    rows = L + w + k - 2
    if plain:
        h, val = hash_chunked_ref(_chunk_view(flat, L, C, rows), k)
    else:
        h, val = hash_chunked(flat, L, C, rows, k)
    if stop_after == "hash":
        return h, val
    return window_stream(h, val, L, w, k - 1, slot_cap, plain, lists=stop_after == "window")


def window_stream(h: torch.Tensor, val: torch.Tensor, L: int, w: int, off: int,
                  slot_cap: int | None = None, plain: bool = False,
                  lists: bool = False) -> tuple[torch.Tensor, ...]:
    """The window half of a sketch, from a chunked (rows, C) layout of
    hashes and k-mer valid flags whose element s of chunk c sits at row
    off + s (rows >= off + L + w - 1): the flag op, the window/emission op,
    compaction, and the exact op for the chunks whose list overflowed,
    counted in ``COUNTS["exact_runs"]`` once per call.  Returns the
    (stream positions c*L + s, canonical hashes) of every emission, int64,
    in stream order with chunk-seam duplicates dropped; with ``lists`` the
    window/emission op's (positions, hashes, counts) before compaction."""
    flags = (window_flags_ref if plain else window_flags)(val, L, w, off)
    cap = _slot_cap(L, w) if slot_cap is None else slot_cap
    spos, shsh, count = (window_emit_ref if plain else window_emit)(h, flags, L, w, off, cap)
    if lists:
        return spos, shsh, count
    over = count > cap
    count = count.masked_fill(over, 0)
    n_over, total = torch.stack([over.sum(), count.sum()]).tolist()
    pos, canon = _compact_lists(spos, shsh, count, total)
    if n_over:
        # exact path for the overflowed chunks, merged back in stream order
        add_count("exact_runs")
        chunks = torch.nonzero(over).flatten()
        am = (window_argmin_ref if plain else window_argmin)(h, L, w, off, chunks)
        xpos, xcanon = _compact_exact(am, flags, h, chunks, L, off)
        pos, order = torch.sort(torch.cat([pos, xpos]), stable=True)
        canon = torch.cat([canon, xcanon])[order]
    keep = torch.ones_like(pos, dtype=torch.bool)
    keep[1:] = pos[1:] != pos[:-1]
    return pos[keep], canon[keep]
