"""Smoke run of the PyTorch port (ntjoin_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the repository root

Phases, each printing its own lines; a failure in any of them ends the run
with a non-zero exit and no result line:

1. card     the CUDA device, and its name and power limit from nvidia-smi
2. build    nvcc builds the kernels from ntjoin_tpu_torch/csrc (one compiler
            per source, side by side) and g++ the host library from
            native/ntjoin_native.cpp, both into ntjoin_tpu_torch/_build
3. kernels  each sketch kernel against its plain PyTorch version on the
            card, on 2^27 seeded bases (k=32, w=1000) with N runs, a poly-C
            and an AC microsatellite stretch; outputs bit-equal; CUDA-event
            times; the window/emission kernel's shared-memory route beside
            the device-memory route on the same inputs; the exact window
            kernel over all chunks and over the overflowed ones, beside
            the card's time for one empty launch; the same stream at w=5000
            (few long chunks): the hash kernel, the one-chunk tiles beside
            the device-memory route, the exact kernel; at w=10000, beyond
            what a one-chunk tile holds, the device-memory route and the
            exact kernel; the flag kernel at all three, timed as launched
            and queued, each of its three passes queued beside the op, the
            bytes they move and the bound,
            and at w=1000 its summary (masks and P) bit-equal to
            flag_summary_ref; and on 2^24 bases
            the flag kernel and the shared-memory route at w=10 and w=100
            (short windows, empty row groups), w=2000 and w=4000 (tiles of
            4 and 2 chunks), w=4243 and the longest window that fits (tiles
            of 1), the exact kernel at w=10 and 4243, and the device-memory
            route at the first window it serves and at w=20000 (with the
            exact kernel and the flag kernel's times), its time beside the
            one-chunk tiles' one window below
4. copy     the copy kernel against the plain version and against
            ``copy_`` into a kept buffer on the profiler's 546 MB array of
            32-bit words; bit-equal; plain, kernel and ``copy_`` timed in
            turns, five rounds; GB/s
5. sketch   sketch_records_torch on records with and without N runs (the
            fused and the general path) against the host oracle, one forced
            overflow through kernel 3, batches at w=5000 through the
            one-chunk tiles and at w=10000 through the device-memory route;
            every device batch through the flag kernel's three passes
6. prof     `python -m ntjoin_tpu_torch.kernel_prof` at 2^27 bases, every
            stage: each must print its JSON line, forwarded here; its
            launch counts are the copy kernel's main path
7. graph    the device shared index, graph build, components and path
            passes on three synthetic sketches of ~2,000,000 minimizers each
            (a 1 Gbp genome at w=1000) against the host SharedIndex,
            build_graph, components and find_paths: every array equal
8. e2e      `python -m ntjoin_tpu_torch.cli assemble backend=cuda` (device
            index) on a ~100 Mbp synthetic genome (two references, a
            2,000-contig target) against the same command with
            `backend=native index_backend=host` (the port's C++ sketcher and
            NumPy graph layers, which share no kernel and no torch op with
            the path under test): every artifact byte-equal, every graph op
            counted on the GPU; each run's stages with their resident set
            at start and end and the highest read while open (the `.time`
            files); the card run's `codes_held_max`, which may not exceed
            one batch's buffer, and its sketch stages after the first, each
            of which may grow its resident set by no more than the reader's
            byte a base, the larger of twice the longest record and the
            codes held, and half a byte a base
A. general  100 Mbp as 20 seeded draft scaffolds of 5 Mbp (the genome of
            phase 8 with an N run of 50-500 bp every 2-8 kbp), through the
            general path (ops/sketch_general.py) at w=1000 and 5000 against
            the host sketcher record by record, every record counted in
            general_records, none on the host; at w=1000 the run's own
            overflowed chunks must take the exact kernel, and that run's
            launches are the general path's in the kernels line; the path's
            kernels against their plain versions on the same batch (the
            compaction kernel's tile counts and first ranks, its hs, vs and
            Ls, and the positions it decodes for every rank and for the
            emitted ones; the exact kernel over the chunks that overflowed);
            CUDA-event times of hash, compaction (its passes and the
            decode, and its plain version), flags, window/emission and the
            call, the plain compaction by torch op (torch.profiler), peak
            bytes a base; a slot_cap=2 run as one more equality check
B. mk       the Mann-Kendall S (ops/mannkendall.py) of 4,096 runs of 2-2,048
            positions and two of 100,000: the S kernel bit-equal to its
            plain version on the card, and the op on the card to the CPU,
            the verdicts against the host scalar test; bit-equal also on a
            run of 2^19 (both timed), an equal and a strictly decreasing
            run of 100,000 and a batch of lengths 0, 1 and more; the
            kernel's time back to back and queued beside the plain
            version's, the public op's, the scaffolder's route's (lengths
            checked on the host), the CPU's and the scalar test's; the
            launches of its two passes; its bound (the bytes it must move,
            and the search steps of ops/mannkendall.mk_steps) beside the
            runs' pairs and the bytes of its own scratch of sorted tiles
C. draft    phase 8 again with an N-dense draft target (~5 Mbp scaffolds, a
            gap every 2-8 kbp, misjoined blocks) and mkt=True: 13 artifacts
            byte-equal, the target on the general path, the op on the card;
            its launches of the S kernel are that kernel's main path; the
            stages' resident set, `codes_held_max` and the sketch stages'
            growth as in phase 8
D. bound    one record as long as record_bound allows on this card for each
            path (N-free: fused; an N run of 1-20 bp every 2-8 kbp: general)
            against the host sketcher, its peak device memory within the
            path's bytes a base (sketch_records.FUSED_BYTES_PER_BASE,
            GENERAL_BYTES_PER_BASE)
E. mesh     parallel/mesh.py sketch_records_sharded over [cuda:0]*4 and
            [cuda:0]*3 on one N-free record of 248,956,422 bases (human
            chromosome 1's length, phase 8's generator) and on phase A's
            draft scaffolds with a 3,000-base N run across a seam of each
            tiling: equal to the single-device sketch and the host sketcher,
            every tile through the card's kernels; the walls of both;
            distributed_unique_count against np.unique; dryrun_multichip(8)
F. dist     run inside phase 8's work directory: `assemble backend=cuda
            n_procs=2 local_devices=2` as two processes on the one card
            (gloo), every artifact byte-equal to phase 8's card run in a
            directory of its own; each process's counters (kernels on the
            card, bytes sent by exchange, the verdict's time on the card);
            the hash-bucket verdict over the three assemblies' streams
            bit-equal to the replicated one on the card

Every count checked is a counter of ntjoin_tpu_torch/utils/timers.py: read
from the port's `trace_counts` line where it runs in a process of its own,
and from `timers.COUNTERS` after a `timers.recording(True)` block here.

The last three lines are the kernels' JSON record (with the general path's
launches and times from phase A's run where a kernel runs on it, and the
launches of phases E and F), the card's name and power limit, and
{"ok": true, "device": {...}}.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import filecmp
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ntjoin_tpu_torch import kernel_prof, split_bench
from ntjoin_tpu_torch.core import orientation
from ntjoin_tpu_torch.core.assembly import AssemblySketch, SharedIndex
from ntjoin_tpu_torch.dryrun import dryrun_multichip
from ntjoin_tpu_torch.graph.mingraph import build_graph
from ntjoin_tpu_torch.graph.paths import find_paths
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.ops import device_index as di
from ntjoin_tpu_torch.ops import mannkendall as mk
from ntjoin_tpu_torch.ops import membw
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops import sketch_general as sg
from ntjoin_tpu_torch.ops import sketch_records as sr
from ntjoin_tpu_torch.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.parallel import mesh as pm
from ntjoin_tpu_torch.parallel import pipeline as pp
from ntjoin_tpu_torch.utils import timers

REPO = os.path.dirname(os.path.abspath(__file__))
K, W = 32, 1000
W_LONG = 5000  # a window that only a one-chunk tile of the shared-memory route holds
W_GMEM = 10_000  # a window no tile holds: the device-memory route's
# The card's published peaks, for the bounds: device memory, and float32
# outside the tensor cores standing in for the integer rate (the data sheet
# gives none).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
SOURCES = {
    "hash": ("ntjoin_tpu_torch/csrc/hash.cu", "ntjoin_tpu/ops/sketch_pallas.py:107"),
    "window_emit": ("ntjoin_tpu_torch/csrc/window_emit.cu",
                    "ntjoin_tpu/ops/sketch_pallas.py:540"),
    "window_emit_gmem": ("ntjoin_tpu_torch/csrc/window_emit_gmem.cu",
                         "ntjoin_tpu/ops/sketch_pallas.py:540"),
    "window": ("ntjoin_tpu_torch/csrc/window.cu", "ntjoin_tpu/ops/sketch_pallas.py:305"),
    "copy": ("ntjoin_tpu_torch/csrc/copy.cu", "scripts/kernel_prof.py:190 and :380"),
    "flags": ("ntjoin_tpu_torch/csrc/flags.cu",
              "ntjoin_tpu/ops/sketch_pallas.py:1299 (XLA code there, no TPU kernel)"),
    "stream": ("ntjoin_tpu_torch/csrc/stream.cu",
               "ntjoin_tpu/ops/sketch_pallas.py:1562, :1584, :1605 (XLA code there, no TPU "
               "kernel)"),
    "mk_s": ("ntjoin_tpu_torch/csrc/mannkendall.cu",
             "ntjoin_tpu/ops/mannkendall.py:25 (XLA code there, no TPU kernel)"),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


GRAPH_OPS = ("shared_filter", "edge_tally", "cc", "escalate", "rank")


def counters(c: dict | None = None) -> collections.Counter:
    """The counters ``c``, by default those of the last
    ``timers.recording(True)`` block; 0 for a name not counted."""
    return collections.Counter(timers.COUNTERS if c is None else c)


def _plain_calls(c: collections.Counter) -> int:
    """Calls of the ops' plain versions among the counters ``c``."""
    return sum(n for name, n in c.items() if name.startswith("launch:") and name.endswith("_plain"))


def card() -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"== card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    say(line)
    return line


def build() -> None:
    secs, log = sc.build()
    say(f"== build: {secs:.2f} s -> {os.path.relpath(sc.LIB_PATH, REPO)}")
    for ln in log.splitlines():
        if "Compiling entry" in ln or "Used" in ln:
            say("   " + ln.strip())
    t0 = time.monotonic()
    if native.available():
        say(f"   host library: {time.monotonic() - t0:.2f} s -> "
            f"{os.path.relpath(native.LIB_PATH, REPO)}")
    elif shutil.which("g++"):
        fail("g++ is here but the host library is unavailable")
    else:
        say("   host library: no g++ on this machine; the NumPy sketcher is the oracle")


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak rate, whichever is longer."""
    by, op = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return {"bound_ms": max(by, op), "bound_by": "bytes" if by >= op else "operations",
            "bound_bytes": int(nbytes)}


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _time_queued_ms(fn, reps: int) -> float:
    """Device time of a launch too short for the host to keep up with: the
    launches are queued behind a kernel that spins for some milliseconds, so
    that they run back to back."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _compare(name: str, got, want) -> float:
    """Bit-equality of each output pair; returns the max abs difference."""
    err = 0.0
    for g, r in zip(got, want):
        if g.shape != r.shape:
            fail(f"{name}: shape {tuple(g.shape)} != plain {tuple(r.shape)}")
        if g.numel():
            err = max(err, float((g.double() - r.double()).abs().max()))
        if not torch.equal(g, r):
            fail(f"{name}: kernel differs from its plain version "
                 f"({int((g != r).sum())} elements)")
    return err


def _repeat_codes(rng, codes: np.ndarray, n_ns: int, span: tuple[int, int]) -> None:
    """Paint N runs, a poly-C and an AC microsatellite stretch into codes."""
    n = codes.shape[0]
    for s in rng.integers(0, n - 6000, size=n_ns):
        codes[s : s + int(rng.integers(span[0], span[1]))] = 4
    s = n // 3
    codes[s : s + 5000] = 1
    s = 2 * n // 3
    codes[s : s + 5000 : 2] = 0
    codes[s + 1 : s + 5001 : 2] = 1


def _cell(codes: np.ndarray, w: int):
    """The chunked stream of ``codes`` at window w on the card:
    (flat, C, L, rows, off)."""
    n = codes.shape[0]
    C, L = sc.layout(n, K, w)
    flat_np = np.full(C * L + w + K - 2, 4, dtype=np.int8)
    flat_np[:n] = codes
    return torch.from_numpy(flat_np).cuda(), C, L, L + w + K - 2, K - 1


def _emit_bound(L: int, C: int, w: int, cap: int) -> dict:
    """Window/emission: the hashes its windows cover and the flags in, the
    lists and counts out; three 64-bit compares per element (suffix, prefix,
    combine) and one per window (emission)."""
    return bound(8 * (L + w - 1) * C + L * C + 16 * cap * C + 8 * C,
                 3 * (L + w - 1) * C + L * C)


def _flags(val: torch.Tensor, L: int, w: int, off: int, what: str) -> tuple:
    """The flag kernel's flags, held bit-equal to the plain version's over
    the (L, C) view (the pad columns' content is free); and the error."""
    flags = sc.window_flags(val, L, w, off)
    if flags.stride(0) % sc.PITCH or flags.data_ptr() % 16 or flags.stride(0) < val.shape[1]:
        fail(f"flags ({what}) are not pitched: stride {flags.stride(0)}")
    return flags, _compare(f"flags ({what})", (flags,), (sc.window_flags_ref(val, L, w, off),))


def _flag_traffic(val: torch.Tensor, L: int, w: int) -> int:
    """Bytes the flag kernel's three passes move: val read once; the masks
    written, read by the scan; P written; for each walk thread, a 16-column
    row of the masks of each tile its windows end in and of P of the tile
    before; the flags written."""
    C = val.shape[1]
    T, m_pitch = sc.flag_scratch(C, L, w)
    ends = sc.flag_segments(L, w, sc.FLAG_ROWS) + w - 1
    first, last = ends[:, 0] // 32, (ends[:, 1] - 1) // 32
    walk_rows = int((last - first + 1).sum() + (first > 0).sum())  # masks, and P before
    return ((L + w - 1) * val.stride(0) + 3 * 4 * T * m_pitch
            + 4 * sc.FLAG_COLS * -(-C // sc.FLAG_COLS) * walk_rows
            + L * -(-C // sc.PITCH) * sc.PITCH)


def _flag_times(val: torch.Tensor, L: int, w: int, off: int) -> dict:
    """Kernel and plain times of the flag op as its callers launch it
    (``ms``), the op queued behind a spinning kernel (``queued_ms``, device
    time alone) and its three passes (the summary, the scan, the walk)
    queued alike; its bound: the k-mer flags its windows cover in, the window
    flags out; ``traffic_bytes`` what the passes move."""
    C = val.shape[1]
    flags = sc.window_flags(val, L, w, off)
    masks = sc._flag_masks(val, L, w, off)
    P = sc._flag_scan(masks)
    return {"ms": _time_ms(lambda: sc.window_flags(val, L, w, off), 10),
            "queued_ms": _time_queued_ms(lambda: sc.window_flags(val, L, w, off), 10),
            "plain_ms": _time_ms(lambda: sc.window_flags_ref(val, L, w, off), 2),
            "library_ms": None,
            "summary_ms": _time_queued_ms(lambda: sc._flag_masks(val, L, w, off), 10),
            "scan_ms": _time_queued_ms(lambda: sc._flag_scan(masks), 10),
            "walk_ms": _time_queued_ms(lambda: sc._flag_walk(masks, P, C, L, w), 10),
            "traffic_bytes": _flag_traffic(val, L, w),
            **bound((L + w - 1 + L) * flags.stride(0), 3 * (L + w - 1) * C)}


def _flag_line(t: dict, what: str) -> str:
    return (f"   flags at {what}: bit-equal; kernel {t['ms']:.4f} ms, queued "
            f"{t['queued_ms']:.4f} (summary {t['summary_ms']:.4f}, scan {t['scan_ms']:.4f}, "
            f"walk {t['walk_ms']:.4f}; "
            f"{t['traffic_bytes']} bytes moved), plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_bytes']} bytes), "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound")


def _argmin_bound(L: int, n_sel: int, w: int) -> dict:
    """Exact window op: the hashes of the listed chunks' windows and the list
    in, every window's argmin out; three 64-bit compares per element."""
    return bound(8 * (L + w - 1) * n_sel + 8 * n_sel + 8 * L * n_sel, 3 * (L + w - 1) * n_sel)


def _exact_all(h: torch.Tensor, L: int, w: int, off: int, reps: int = 3) -> str:
    """Kernel 3 over every chunk against the plain version; a line of times."""
    C = h.shape[1]
    _compare(f"window (all chunks, w={w})", (sc.window_argmin(h, L, w, off),),
             (sc.window_argmin_ref(h, L, w, off),))
    ms = _time_ms(lambda: sc.window_argmin(h, L, w, off), reps)
    plain_ms = _time_ms(lambda: sc.window_argmin_ref(h, L, w, off), 1)
    b = _argmin_bound(L, C, w)
    tile, threads = sc.argmin_launch(C, w, h.device)
    return (f"   window over all {C} chunks at w={w}: bit-equal; {-(-C // tile)} thread blocks of "
            f"{threads} threads ({tile} chunks each, {-(-L // w)} blocks of windows in turn); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
            f"({b['bound_bytes']} bytes)")


def _gmem_launch(C: int, w: int) -> str:
    tile, threads = sc.gmem_launch(C, w, torch.device("cuda"))
    return f"{-(-C // tile)} thread blocks of {threads} threads ({tile} chunks each)"


def _seeded_codes(n: int, n_ns: int) -> np.ndarray:
    rng = np.random.default_rng(2027)
    codes = rng.integers(0, 4, size=n, dtype=np.int8)
    _repeat_codes(rng, codes, n_ns, (10, 5000))
    return codes


def kernels() -> dict[str, dict]:
    """Phase 3: each kernel against its plain version at the bench shape."""
    n = 1 << 27
    codes = _seeded_codes(n, 64)
    flat, C, L, rows, off = _cell(codes, W)
    view = sc._chunk_view(flat, L, C, rows)
    say(f"== kernels: {n} bases, k={K} w={W}, C={C} chunks of L={L}")
    out = {}

    h, val = sc.hash_chunked(flat, L, C, rows, K)
    h_ref, val_ref = sc.hash_chunked_ref(view, K)
    err = _compare("hash", (h, val), (h_ref, val_ref))
    del h_ref, val_ref
    ms = _time_ms(lambda: sc.hash_chunked(flat, L, C, rows, K), 5)
    plain_ms = _time_ms(lambda: sc.hash_chunked_ref(view, K), 2)
    # 1 B of code in and 9 B out per row; two rotations, four xors, an add
    # and the valid test: ~12 integer operations
    out["hash"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   **bound(flat.numel() + 9 * rows * C, 12 * rows * C)}
    say(f"   hash rows pitched to {h.stride(0)} columns")

    flags, err = _flags(val, L, W, off, f"w={W}")
    _compare(f"flag summary, masks and P (w={W})", sc.flag_summary(val, L, W, off),
             sc.flag_summary_ref(val, L, W, off))
    out["flags"] = {"max_abs_err": err, **_flag_times(val, L, W, off)}
    say(_flag_line(out["flags"], f"w={W}, C={C} chunks of L={L}") + "; the summary's masks "
        "and P bit-equal to flag_summary_ref")
    cap = sc._slot_cap(L, W)
    tile = sc.emit_tile(W)
    if not tile:
        fail(f"w={W} does not fit the shared-memory route")
    want = sc.window_emit_ref(h, flags, L, W, off, cap)
    got = sc.window_emit(h, flags, L, W, off, cap)
    err = _compare("window_emit", got, want)
    _compare("window_emit (device-memory route)",
             sc._window_emit_gmem(h, flags, L, W, off, cap), want)
    over = torch.nonzero(got[2] > cap).flatten()
    n_max = int(got[2].max())
    del got, want
    # the route it replaced, the new one, the new one, the route it replaced
    old_ms = _time_ms(lambda: sc._window_emit_gmem(h, flags, L, W, off, cap), 5)
    ms = min(_time_ms(lambda: sc.window_emit(h, flags, L, W, off, cap), 5),
             _time_ms(lambda: sc.window_emit(h, flags, L, W, off, cap), 5))
    old_ms = min(old_ms, _time_ms(lambda: sc._window_emit_gmem(h, flags, L, W, off, cap), 5))
    plain_ms = _time_ms(lambda: sc.window_emit_ref(h, flags, L, W, off, cap), 2)
    out["window_emit"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": None, **_emit_bound(L, C, W, cap)}
    say(f"   window_emit: shared-memory route (tiles of {tile} chunks) {ms:.3f} ms, the "
        f"device-memory route {old_ms:.3f} ms ({_gmem_launch(C, W)}), same inputs, both "
        f"bit-equal")
    say(f"   emission capacity {cap}/chunk; {over.numel()} chunks overflowed "
        f"(max count {n_max})")
    if over.numel() == 0:
        fail("the repeat stretches overflowed no chunk: kernel 3 unexercised")

    say(_exact_all(h, L, W, off))
    err = _compare("window (overflowed chunks)", (sc.window_argmin(h, L, W, off, over),),
                   (sc.window_argmin_ref(h, L, W, off, over),))
    # a launch this short is timed queued behind a spinning kernel, beside
    # the card's time for an empty launch: the floor under its bound
    ms = _time_queued_ms(lambda: sc.window_argmin(h, L, W, off, over), 50)
    unqueued_ms = _time_ms(lambda: sc.window_argmin(h, L, W, off, over), 50)
    plain_ms = _time_ms(lambda: sc.window_argmin_ref(h, L, W, off, over), 5)
    stream = torch.cuda.current_stream().cuda_stream
    floor_ms = _time_queued_ms(lambda: sc._lib().nj_noop(stream), 200)
    n_over = over.numel()
    out["window"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "launch_floor_ms": floor_ms, **_argmin_bound(L, n_over, W)}
    say(f"   window over the {n_over} overflowed chunks: {n_over * -(-L // W)} thread blocks of "
        f"{sc.split_threads(W, 1)} threads; {ms:.4f} ms on the card ({unqueued_ms:.4f} ms "
        f"from a host that waits for nothing); one empty launch {floor_ms:.4f} ms")
    del h, val, flags, flat, view

    # few long chunks: the hash kernel again, and the one-chunk tiles beside
    # the device-memory route that served this window before them
    flat, C, L, rows, off = _cell(codes, W_LONG)
    view = sc._chunk_view(flat, L, C, rows)
    h, val = sc.hash_chunked(flat, L, C, rows, K)
    _compare(f"hash (w={W_LONG})", (h, val), sc.hash_chunked_ref(view, K))
    ms = _time_ms(lambda: sc.hash_chunked(flat, L, C, rows, K), 5)
    plain_ms = _time_ms(lambda: sc.hash_chunked_ref(view, K), 1)
    b = bound(flat.numel() + 9 * rows * C, 12 * rows * C)
    say(f"   hash at w={W_LONG}: C={C} chunks of L={L}, {rows} rows; bit-equal; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_bytes']} bytes)")
    flags, _ = _flags(val, L, W_LONG, off, f"w={W_LONG}")
    say(_flag_line(_flag_times(val, L, W_LONG, off), f"w={W_LONG}, C={C} chunks of L={L}"))
    cap = sc._slot_cap(L, W_LONG)
    want = sc.window_emit_ref(h, flags, L, W_LONG, off, cap)
    with timers.recording(True):
        _compare(f"window_emit (w={W_LONG})", sc.window_emit(h, flags, L, W_LONG, off, cap), want)
    c = counters()
    if sc.emit_tile(W_LONG) != 1 or c["launch:window_emit"] != 1 or c["launch:window_emit_gmem"]:
        fail(f"w={W_LONG} did not take the one-chunk tiles: {dict(c)}")
    _compare(f"window_emit (device-memory route, w={W_LONG})",
             sc._window_emit_gmem(h, flags, L, W_LONG, off, cap), want)
    del want
    old_ms = _time_ms(lambda: sc._window_emit_gmem(h, flags, L, W_LONG, off, cap), 5)
    ms = min(_time_ms(lambda: sc.window_emit(h, flags, L, W_LONG, off, cap), 5),
             _time_ms(lambda: sc.window_emit(h, flags, L, W_LONG, off, cap), 5))
    old_ms = min(old_ms, _time_ms(lambda: sc._window_emit_gmem(h, flags, L, W_LONG, off, cap), 5))
    plain_ms = _time_ms(lambda: sc.window_emit_ref(h, flags, L, W_LONG, off, cap), 1)
    b = _emit_bound(L, C, W_LONG, cap)
    say(f"   window_emit at w={W_LONG}: tiles of 1 chunk {ms:.3f} ms, the device-memory route "
        f"{old_ms:.3f} ms ({_gmem_launch(C, W_LONG)}), same inputs, both bit-equal; plain "
        f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_bytes']} bytes)")
    del flags, val
    say(_exact_all(h, L, W_LONG, off))
    del h, flat, view

    # the device-memory route where it serves: a window no tile holds
    flat, C, L, rows, off = _cell(codes, W_GMEM)
    h, val = sc.hash_chunked(flat, L, C, rows, K)
    flags, _ = _flags(val, L, W_GMEM, off, f"w={W_GMEM}")
    say(_flag_line(_flag_times(val, L, W_GMEM, off), f"w={W_GMEM}, C={C} chunks of L={L}"))
    cap = sc._slot_cap(L, W_GMEM)
    with timers.recording(True):
        err = _compare(f"window_emit_gmem (w={W_GMEM})",
                       sc.window_emit(h, flags, L, W_GMEM, off, cap),
                       sc.window_emit_ref(h, flags, L, W_GMEM, off, cap))
    c = counters()
    if sc.emit_tile(W_GMEM) or c["launch:window_emit_gmem"] != 1 or c["launch:window_emit"]:
        fail(f"w={W_GMEM} did not take the device-memory route: {dict(c)}")
    ms = min(_time_ms(lambda: sc.window_emit(h, flags, L, W_GMEM, off, cap), 5),
             _time_ms(lambda: sc.window_emit(h, flags, L, W_GMEM, off, cap), 5))
    plain_ms = _time_ms(lambda: sc.window_emit_ref(h, flags, L, W_GMEM, off, cap), 1)
    out["window_emit_gmem"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": None, **_emit_bound(L, C, W_GMEM, cap)}
    say(f"   window_emit_gmem at w={W_GMEM}: C={C} chunks of L={L}, {_gmem_launch(C, W_GMEM)}")
    del flags, val
    say(_exact_all(h, L, W_GMEM, off))
    del h, flat

    # the shared-memory route off w=1000: overlap-size windows and windows
    # under 191, where some of a block's row groups are empty, then its
    # narrower tiles, down to the longest window a one-chunk tile holds
    w_max = W_LONG
    while sc.emit_tile(w_max + 1):
        w_max += 1
    small = _seeded_codes(1 << 24, 8)
    tile_ms = 0.0
    for w, tile in ((10, 8), (100, 8), (2000, 4), (4000, 2), (4243, 1), (w_max, 1)):
        flat, C, L, rows, off = _cell(small, w)
        h, val = sc.hash_chunked(flat, L, C, rows, K)
        flags, _ = _flags(val, L, w, off, f"w={w}, {small.shape[0]} bases")
        cap = sc._slot_cap(L, w)
        with timers.recording(True):
            _compare(f"window_emit (w={w})", sc.window_emit(h, flags, L, w, off, cap),
                     sc.window_emit_ref(h, flags, L, w, off, cap))
        c = counters()
        if sc.emit_tile(w) != tile or c["launch:window_emit"] != 1:
            fail(f"w={w} did not take the shared-memory route in tiles of {tile}: {dict(c)}")
        say(f"   flags and window_emit at w={w}, {small.shape[0]} bases: tiles of {tile} "
            f"chunks, bit-equal")
        if w in (10, 4243):  # a short and an odd window
            say(_exact_all(h, L, w, off))
        if w == w_max:
            tile_ms = _time_ms(lambda: sc.window_emit(h, flags, L, w, off, cap), 5)
    # the device-memory route from the first window it serves, and the exact
    # kernel at a window above what two segments of shared memory would hold
    for w in (w_max + 1, 20_000):
        flat, C, L, rows, off = _cell(small, w)
        h, val = sc.hash_chunked(flat, L, C, rows, K)
        flags, _ = _flags(val, L, w, off, f"w={w}, {small.shape[0]} bases")
        cap = sc._slot_cap(L, w)
        with timers.recording(True):
            _compare(f"window_emit_gmem (w={w})", sc.window_emit(h, flags, L, w, off, cap),
                     sc.window_emit_ref(h, flags, L, w, off, cap))
        c = counters()
        if sc.emit_tile(w) or c["launch:window_emit_gmem"] != 1 or c["launch:window_emit"]:
            fail(f"w={w} did not take the device-memory route: {dict(c)}")
        ms = _time_ms(lambda: sc.window_emit(h, flags, L, w, off, cap), 5)
        say(f"   flags and window_emit_gmem at w={w}, {small.shape[0]} bases: C={C} chunks of "
            f"L={L}, {_gmem_launch(C, w)}, bit-equal; {ms:.3f} ms"
            + (f" beside {tile_ms:.3f} ms for the one-chunk tiles at w={w_max}"
               if w == w_max + 1 else ""))
        if w == 20_000:
            say(_flag_line(_flag_times(val, L, w, off),
                           f"w={w}, {small.shape[0]} bases, C={C} chunks of L={L}"))
            say(_exact_all(h, L, w, off))
    del h, val, flags, flat
    for name, r in out.items():
        say(f"   {name}: bit-equal; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_bytes']} bytes)")
    return out


def copy() -> dict:
    """Phase 4: the copy kernel against ``copy_`` on the profiler's array,
    timed in turns."""
    x = torch.arange(kernel_prof.copy_rows(1 << 27) * 2048, dtype=torch.int32,
                     device="cuda").view(-1, 2048)
    x[::7] ^= -1  # words with the top bit set too
    nbytes = x.numel() * 4
    odd = x.view(-1).view(torch.int8)[: 1_000_003]  # a byte count that is no multiple of 16
    err = _compare("copy", (membw.copy_words(x),), (membw.copy_words_ref(x),))
    err = max(err, _compare("copy (byte tail)", (membw.copy_words(odd),),
                            (membw.copy_words_ref(odd),)))
    y = torch.empty_like(x)
    turns = {"plain": lambda: membw.copy_words_ref(x), "kernel": lambda: membw.copy_words(x),
             "copy_": lambda: y.copy_(x)}
    times: dict[str, list[float]] = {name: [] for name in turns}
    for _ in range(5):  # plain, kernel, copy_, plain, kernel, copy_, ...
        for name, fn in turns.items():
            times[name].append(_time_ms(fn, 10))
    best = {name: min(v) for name, v in times.items()}
    say(f"== copy: {tuple(x.shape)} 32-bit words, {nbytes} bytes; bit-equal")
    for name, v in times.items():
        say(f"   {name}: best {best[name]:.4f} ms ({2 * nbytes / best[name] / 1e6:.1f} GB/s); "
            f"rounds {' '.join(f'{t:.4f}' for t in v)}")
    out = {"max_abs_err": err, "ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": best["copy_"], **bound(2 * nbytes, 0)}
    say(f"   bound {out['bound_ms']:.4f} ms by {out['bound_by']} ({out['bound_bytes']} bytes)")
    return out


def _records(rng, total: int) -> list[np.ndarray]:
    """Records of mixed length (some under w+k-1), a third with N runs, one
    with the repeat stretches."""
    recs = []
    size = 0
    while size < total:
        n = int(min(rng.lognormal(11.5, 1.5), 4_000_000)) + 10
        c = rng.integers(0, 4, size=n, dtype=np.uint8)
        if len(recs) % 3 == 0 and n > 20_000:
            for s in rng.integers(0, n - 5000, size=int(rng.integers(1, 6))):
                c[s : s + int(rng.integers(1, 3000))] = 4
        recs.append(c)
        size += n
    recs += [rng.integers(0, 4, size=n, dtype=np.uint8) for n in (9, 1030, 1031, 1032)]
    big = rng.integers(0, 4, size=400_000, dtype=np.uint8)
    _repeat_codes(rng, big.view(np.int8), 4, (10, 2000))
    recs.append(big)
    return recs


def _oracle(c: np.ndarray, w: int):
    return native.sketch_codes_native(c, K, w) if native.available() else sketch_codes(c, K, w)


def _same(got, recs, what: str, w: int = W) -> None:
    for i, (g, c) in enumerate(zip(got, recs)):
        r = _oracle(c, w)
        if g.positions.tolist() != r.positions.tolist() or g.hashes.tolist() != r.hashes.tolist():
            fail(f"{what}: record {i} ({c.shape[0]} bases) differs from the oracle")


def _peak_bytes(fn):
    """(fn(), the most device memory it held above what was held before)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _flags_counted(c: collections.Counter) -> None:
    """Every device batch launches the hash kernel once and the flag
    kernel's passes."""
    if (c["launch:flags"] < 1 or c["launch:flags"] != sc.FLAG_LAUNCHES * c["launch:hash"]
            or c["launch:flags_plain"]):
        fail(f"a device batch went round the flag kernel: {dict(c)}")


def sketch() -> int:
    """Phase 5: the batched sketch against the host oracle; returns the
    launches of the device-memory window/emission route on its path, the
    w=10000 batch."""
    rng = np.random.default_rng(44)
    recs = _records(rng, 48 << 20)
    if not native.available():  # the numpy oracle is slow: a 2^22-base subset
        sub, acc = [], 0
        for c in recs[::-1]:
            if acc + c.shape[0] <= 1 << 22:
                sub.append(c)
                acc += c.shape[0]
        recs = sub
    oracle = "native C++ sketcher" if native.available() else "nthash_np.sketch_codes"
    bases = sum(c.shape[0] for c in recs)
    t0 = time.monotonic()
    with timers.recording(True):
        got, peak = _peak_bytes(lambda: sr.sketch_records_torch(recs, K, W, "cuda"))
    wall = time.monotonic() - t0
    c = counters()
    _same(got, recs, "sketch")
    say(f"== sketch: {len(recs)} records, {bases} bases in {wall:.3f} s; equal to the "
        f"{oracle}; counts {json.dumps(c)}")
    say(f"   peak device memory of the batch {peak} bytes, {peak / bases:.2f} a base")
    if c["sketch_route:host_records"]:
        fail("a record took the host sketcher")
    _flags_counted(c)
    small = recs[-12:]
    with timers.recording(True):
        got = sr.sketch_records_torch(small, K, W, "cuda", slot_cap=2)
    c = counters()
    _same(got, small, "forced overflow")
    if c["sketch_route:exact_runs"] < 1 or c["launch:window"] < 1:
        fail(f"slot_cap=2 did not take the exact path: {dict(c)}")
    _flags_counted(c)
    say(f"   forced overflow (slot_cap=2): exact through kernel 3, counts {json.dumps(c)}")
    long_w, acc = [], 0
    for c in recs:
        if acc < 1 << 24:
            long_w.append(c)
            acc += c.shape[0]
    gmem = 0
    for w, route, other in ((W_LONG, "window_emit", "window_emit_gmem"),
                            (W_GMEM, "window_emit_gmem", "window_emit")):
        with timers.recording(True):
            got = sr.sketch_records_torch(long_w, K, w, "cuda")
        c = counters()
        _same(got, long_w, f"w={w}", w)
        if c["launch:" + route] < 1 or c["launch:" + other] or c["sketch_route:host_records"]:
            fail(f"w={w} did not go through {route}: {dict(c)}")
        _flags_counted(c)
        say(f"   w={w}: {len(long_w)} records, {acc} bases, equal to the {oracle}; "
            f"counts {json.dumps(c)}")
        gmem = c["launch:window_emit_gmem"]
    return gmem


def prof() -> dict[str, int]:
    """Phase 6: the per-stage profiler in a process of its own; returns its
    counters."""
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "ntjoin_tpu_torch.kernel_prof"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        fail(f"kernel_prof exited {res.returncode}:\n{res.stderr[-4000:]}")
    lines = {}
    for ln in res.stdout.splitlines():
        obj = json.loads(ln)
        lines.update(obj)
        say("   " + ln)
    missing = [s for s in kernel_prof.STAGES if not isinstance(lines.get(s), dict)
               or "skipped" in lines[s]]
    if missing or "counts" not in lines:
        fail(f"kernel_prof printed no result for {missing or ['counts']}")
    say(f"== prof: stages {' '.join(kernel_prof.STAGES)} in {time.monotonic() - t0:.1f} s")
    return lines["counts"]


# -- phase 7: graph stages ---------------------------------------------------------


def graph_assemblies(rng, n_mx: int = 2_000_000, n_chrom: int = 24,
                     n_contigs: int = 500) -> list[AssemblySketch]:
    """Sketches of one genome of ``n_mx`` minimizers ~500 bp apart (1 Gbp at
    w=1000) in ``n_chrom`` chromosomes, as three assemblies of ~n_contigs
    contigs each: every assembly substitutes 1% of the hashes and plants
    0.2% within-assembly duplicates; reference 2 moves 40 blocks of 2,000
    minimizers (branches); the target's contigs are shuffled and a third of
    them reverse-ordered.  Weights 2, 2, 1."""
    base = np.unique(rng.integers(0, 2**64 - 1, size=n_mx + n_mx // 50, dtype=np.uint64))
    base = rng.permutation(base)[:n_mx]
    gpos = np.cumsum(rng.integers(1, 1000, size=n_mx)).astype(np.int64)
    chrom_cuts = np.sort(rng.choice(np.arange(1, n_mx), n_chrom - 1, replace=False))
    out = []
    for a, (name, weight) in enumerate((("ref1", 2.0), ("ref2", 2.0), ("target", 1.0))):
        h = base.copy()
        sub = rng.random(n_mx) < 0.01
        h[sub] = rng.integers(0, 2**64 - 1, size=int(sub.sum()), dtype=np.uint64)
        dup = rng.choice(n_mx, n_mx // 500, replace=False)
        h[dup] = h[rng.choice(n_mx, dup.shape[0])]
        order = np.arange(n_mx)
        if name == "ref2":
            for _ in range(40):
                s, t = rng.integers(0, n_mx - 2000, size=2)
                blk = order[s : s + 2000]
                rest = np.concatenate([order[:s], order[s + 2000 :]])
                order = np.concatenate([rest[:t], blk, rest[t:]])
        cuts = np.union1d(chrom_cuts, rng.choice(np.arange(1, n_mx), n_contigs - n_chrom,
                                                 replace=False))
        contigs = np.split(order, cuts)
        if name == "target":
            contigs = [contigs[i] for i in rng.permutation(len(contigs))]
        hs, ps, cs = [], [], []
        for ci, idx in enumerate(contigs):
            p = gpos[idx] - gpos[idx].min()
            if name == "target" and rng.random() < 1 / 3:
                p = p.max() - p
            srt = np.argsort(p, kind="stable")
            hs.append(h[idx][srt])
            ps.append(p[srt])
            cs.append(np.full(idx.shape[0], ci, np.int32))
        out.append(AssemblySketch.from_stream(
            name, weight, [f"{name}_{i}" for i in range(len(contigs))],
            np.concatenate(hs), np.concatenate(ps), np.concatenate(cs)))
    return out


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph(n_mx: int = 2_000_000, device: str = "cuda") -> None:
    """Phase 7: the device graph stages against the host's at 1 Gbp scale."""
    t0 = time.monotonic()
    asms = graph_assemblies(np.random.default_rng(7), n_mx)
    say(f"== graph: {' '.join(str(a.hash.shape[0]) for a in asms)} minimizers after "
        f"within-assembly uniqueness; made in {time.monotonic() - t0:.1f} s")
    n_min = 2
    min_w = min(a.weight for a in asms)

    def port():
        with timers.recording(True):
            shared, t_index = _timed(lambda: di.shared_index_device(asms, device))
            g, t_graph = _timed(lambda: di.build_graph_device(shared, device))
            comp, t_cc = _timed(g.components)
            g.global_weight_filter(n_min, min_w)
            (paths, ncomp), t_paths = _timed(lambda: find_paths(g, shared, n_min, device))
        return (shared, g, comp, paths, ncomp), (t_index, t_graph, t_cc, t_paths)

    port()  # first use of each torch op on the card
    (shared, g, comp, paths, ncomp), port_s = port()
    counts = counters()
    (host, t_index) = _timed(lambda: SharedIndex(asms))
    hg, t_graph = _timed(lambda: build_graph(host))
    hcomp, t_cc = _timed(hg.components)
    hg.global_weight_filter(n_min, min_w)
    branch = int((hg.degrees() > 2).sum())
    (hpaths, hncomp), t_paths = _timed(lambda: find_paths(hg, host, n_min, None))

    def same(what, a, b):
        if not (np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)):
            fail(f"graph: {what} differs between the device and the host")

    same("node hashes", shared.node_hash, host.node_hash)
    same("positions", shared.pos, host.pos)
    same("contigs", shared.ctg, host.ctg)
    for a, ((gi, gc), (hi, hc)) in enumerate(zip(shared.streams, host.streams)):
        same(f"stream {a} ids", gi, hi)
        same(f"stream {a} contigs", gc, hc)
    for name in ("src", "dst", "weight", "support_mask"):
        same(f"edge {name}", getattr(g, name), getattr(hg, name))
    same("component labels", comp, hcomp.astype(comp.dtype))
    same("alive mask", g.alive, hg.alive)
    if ncomp != hncomp or [p for p, _ in paths] != [p for p, _ in hpaths]:
        fail(f"graph: paths differ ({len(paths)} vs {len(hpaths)}, {ncomp} vs {hncomp} "
             "components)")
    for op in GRAPH_OPS:
        if counts[f"graph:{op}@{torch.device(device).type}"] < 1:
            fail(f"graph: op {op} did not run on the GPU: {dict(counts)}")
    lens = sorted((len(p) for p, _ in paths), reverse=True)
    say(f"   equal: {shared.num_nodes} nodes, {g.src.shape[0]} edges, {ncomp} components, "
        f"{len(paths)} paths (longest {lens[:3]} nodes), {branch} branch nodes before "
        f"path finding; counts {json.dumps(counts)}")
    for stage, p, h in zip(("shared index", "graph build", "components", "find_paths"),
                           port_s, (t_index, t_graph, t_cc, t_paths)):
        say(f"   {stage}: device {p:.4f} s, host {h:.4f} s")


# -- phase A: the general path at full size ------------------------------------------


def _paint_gaps(rng, c: np.ndarray) -> int:
    """An N run of 50-500 bp every 2-8 kbp, as in a draft scaffold of a
    short-read assembly; returns the number of runs."""
    s, runs = int(rng.integers(0, 8000)), 0
    while s < c.shape[0]:
        ln = int(rng.integers(50, 501))
        c[s : s + ln] = 4
        s += ln + int(rng.integers(2000, 8001))
        runs += 1
    return runs


def _kernel_split(fn, top: int = 10) -> str:
    """The device time of one call of fn by torch op (the kernels each op
    launched itself, from torch.profiler's CPU and CUDA activity); "not
    measured" where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.key.startswith("aten::") and e.self_device_time_total > 0]
    if not rows:
        return "not measured (no device time in the trace)"
    rows.sort(key=lambda r: -r[2])
    total = sum(ms for _, _, ms in rows)
    return f"{total:.3f} ms in all; " + "; ".join(
        f"{k} x{n} {ms:.3f} ms" for k, n, ms in rows[:top])


def _counted_route(c: collections.Counter, w: int, what: str) -> None:
    """The batches launched the hash, flag and window/emission kernels of
    their route, a general batch also the compaction kernel, no plain
    version, and the host sketched nothing."""
    route = "window_emit" if sc.emit_tile(w) else "window_emit_gmem"
    if (c["launch:hash"] < 1 or c["launch:flags"] != sc.FLAG_LAUNCHES * c["launch:hash"]
            or c["launch:" + route] < 1
            or (c["sketch_route:general_batches"] and c["launch:stream"] < 4)
            or c["sketch_route:host_records"] or _plain_calls(c)):
        fail(f"{what}: the general path did not run on its kernels: {dict(c)}")


def draft_scaffolds() -> tuple[list[np.ndarray], int]:
    """Phase A's 100 Mbp: 20 seeded draft scaffolds of 5 Mbp (the genome of
    phase 8) with an N run of 50-500 bp every 2-8 kbp; and the runs added."""
    rng = np.random.default_rng(61)
    recs = genome(rng, [5_000_000] * 20)
    return recs, sum(_paint_gaps(rng, c) for c in recs)


def general() -> dict[str, dict]:
    """Phase A: 100 Mbp of draft scaffolds through the general path at
    w=1000 and 5000 against the host oracle, its kernels against their plain
    versions on the same batch, and CUDA-event times of its stages; returns
    the general path's launches in its own run at w=1000 and its kernels'
    times, plain times and bounds on that batch."""
    recs, runs = draft_scaffolds()
    bases = sum(c.shape[0] for c in recs)
    say(f"== general: {len(recs)} draft scaffolds, {bases} bases (the genome of phase 8), "
        f"{runs} more N runs of 50-500 bp every 2-8 kbp")
    out = {}
    for w in (W, W_LONG):
        t0 = time.monotonic()
        with timers.recording(True):
            got, peak = _peak_bytes(lambda: sr.sketch_records_torch(recs, K, w, "cuda"))
        wall = time.monotonic() - t0
        counts = counters()
        _same(got, recs, f"general path, w={w}", w)
        if (counts["sketch_route:general_records"] != len(recs)
                or counts["sketch_route:general_batches"] != 1):
            fail(f"w={w}: the records did not take the general path in one batch: "
                 f"{dict(counts)}")
        _counted_route(counts, w, f"w={w}")
        say(f"   w={w}: sketch_records_torch {wall:.3f} s, equal to the host sketcher record by "
            f"record; peak device memory {peak} bytes, {peak / bases:.2f} a base; counts "
            f"{json.dumps(counts)}")
        if w == W:
            if counts["launch:window"] < 1:
                fail(f"w={w}: no chunk of the stream overflowed, the exact kernel did not run")
            launches = {name: counts["launch:" + name]
                        for name in ("hash", "stream", "flags", "window_emit", "window")}
            _same(sr.sketch_records_torch(recs, K, w, "cuda", slot_cap=2), recs,
                  f"general path, slot_cap=2, w={w}", w)
            say(f"   w={w}, slot_cap=2 (an equality check only): equal to the host sketcher")

        # the batch's kernels against their plain versions
        host, total, offsets = sr.pack_batch(recs, K, w)
        flat, starts = host.cuda(), torch.from_numpy(offsets).cuda()
        h, val, L = sg.hash_batch(flat, total, K, w)
        C = h.shape[1]
        _compare(f"general hash (w={w})", (h, val),
                 sc.hash_chunked_ref(sc._chunk_view(flat, L, C, L + K - 1), K))
        _compare(f"general compaction, count pass (w={w})",
                 (sg._count(val, L, total, starts, K),),
                 (sg.tile_counts_ref(val, L, total, starts, K),))
        hs, vs, Ls, index = sg.stream_batch(flat, total, starts, K, w)
        p_hs, p_vs, p_Ls, p_index = sg.stream_batch(flat, total, starts, K, w, plain=True)
        if Ls != p_Ls:
            fail(f"general compaction (w={w}): chunks of {Ls}, the plain version's {p_Ls}")
        S = index.S
        every = torch.arange(S, device=flat.device)
        stream_err = _compare(f"general compaction, every rank decoded (w={w})",
                              (hs, vs, index.firsts, sg.decode_ranks(index, every)),
                              (p_hs, p_vs, p_index.firsts,
                               sg.decode_ranks(p_index, every, plain=True)))
        del p_hs, p_vs, p_index, every
        ranks, _ = sc.window_stream(hs, vs, Ls, w, 0)
        stream_err = max(stream_err, _compare(
            f"general compaction, the {ranks.numel()} emitted ranks decoded (w={w})",
            (sg.decode_ranks(index, ranks),), (sg.decode_ranks(index, ranks, plain=True),)))

        def compaction():
            """The compaction kernel's passes on the batch's hash layout, the
            decode on this run's emitted ranks."""
            firsts, S = sg.first_ranks(sg._count(val, L, total, starts, K))
            chunks = sg._chunks(*sg._gather(h, val, L, total, starts, K, firsts, S), w)
            return chunks, sg._decode(sg.StreamIndex(val, firsts, L, total, K, starts), ranks)

        def compaction_plain():
            """The plain version's steps on the batch's hash layout."""
            pos = sg.valid_positions(val, L, total, starts, K)
            hflat, Ls = sg.gather_stream(h, pos, L, K, w)
            vflat = sg.stream_valid(pos, starts, hflat.shape[0])
            return (sg.stream_chunks(hflat, Ls, w), sg.stream_chunks(vflat, Ls, w), Ls,
                    pos[ranks])

        flags, _ = _flags(vs, Ls, w, 0, f"general, w={w}")
        cap = sc._slot_cap(Ls, w)
        emitted = sc.window_emit(hs, flags, Ls, w, 0, cap)
        _compare(f"general window/emission (w={w})", emitted,
                 sc.window_emit_ref(hs, flags, Ls, w, 0, cap))
        over = torch.nonzero(emitted[2] > cap).flatten()
        del emitted
        _compare(f"general exact window, {over.numel()} chunks (w={w})",
                 (sc.window_argmin(hs, Ls, w, 0, over),),
                 (sc.window_argmin_ref(hs, Ls, w, 0, over),))
        kern = sg.sketch_general_torch(flat, total, starts, K, w)
        _compare(f"general path (w={w})", kern,
                 sg.sketch_general_torch(flat, total, starts, K, w, plain=True))
        _compare(f"general path, slot_cap=2 (w={w})",
                 sg.sketch_general_torch(flat, total, starts, K, w, slot_cap=2), kern)
        firsts = index.firsts
        hflat, vflat = sg._gather(h, val, L, total, starts, K, firsts, S)
        t = {"hash": _time_ms(lambda: sg.hash_batch(flat, total, K, w), 3),
             "compaction": _time_ms(compaction, 5),
             "compaction_plain": _time_ms(compaction_plain, 3),
             "count pass, scan and sync": _time_ms(
                 lambda: sg.first_ranks(sg._count(val, L, total, starts, K)), 5),
             "count pass": _time_queued_ms(lambda: sg._count(val, L, total, starts, K), 20),
             "gather pass": _time_ms(
                 lambda: sg._gather(h, val, L, total, starts, K, firsts, S), 5),
             "chunks pass": _time_ms(lambda: sg._chunks(hflat, vflat, w), 5),
             "decode pass": _time_queued_ms(lambda: sg._decode(index, ranks), 20),
             "flags": _time_ms(lambda: sc.window_flags(vs, Ls, w, 0), 5),
             "window_emit": _time_ms(lambda: sc.window_emit(hs, flags, Ls, w, 0, cap), 5),
             "call": _time_ms(lambda: sg.sketch_general_torch(flat, total, starts, K, w), 3)}
        say(f"   w={w}: kernels bit-equal to their plain versions on the batch (hash: C={C} "
            f"chunks of L={L}; the compaction's counts of {sg.stream_tiles(L)} tiles a "
            f"column and their first ranks, its stream of {S} k-mers and dead slots: "
            f"C={hs.shape[1]} chunks of L={Ls}, and the positions of every rank and of the "
            f"{ranks.numel()} emitted ones; the exact kernel over the {over.numel()} chunks "
            f"that overflowed {cap} slots; the whole call, and with slot_cap=2)")
        say(f"   w={w} times (CUDA events): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
            + f"; {total / t['call'] / 1e6:.2f} Gbases/s")
        if w == W:
            view = sc._chunk_view(flat, L, C, L + K - 1)
            Cs = hs.shape[1]
            out = {
                "hash": {"ms": t["hash"], **bound(flat.numel() + 9 * (L + K - 1) * C,
                                                  12 * (L + K - 1) * C),
                         "plain_ms": _time_ms(lambda: sc.hash_chunked_ref(view, K), 1)},
                # the flags read once, the kept hashes and the starts; the tile first
                # ranks; chunks with their halo; the emitted ranks and their positions
                "stream": {"ms": t["compaction"], "plain_ms": t["compaction_plain"],
                           "max_abs_err": stream_err, "library_ms": None,
                           **bound(total - K + 1 + 8 * S + 8 * starts.numel()
                                   + 8 * firsts.numel() + 9 * (Ls + w - 1) * Cs
                                   + 16 * ranks.numel(), 0)},
                "flags": _flag_times(vs, Ls, w, 0),
                "window_emit": {"ms": t["window_emit"], **_emit_bound(Ls, Cs, w, cap),
                                "plain_ms": _time_ms(lambda: sc.window_emit_ref(
                                    hs, flags, Ls, w, 0, cap), 1)},
                # over this run's overflowed chunks, queued as in phase 3
                "window": {"ms": _time_queued_ms(lambda: sc.window_argmin(hs, Ls, w, 0, over), 50),
                           **_argmin_bound(Ls, over.numel(), w),
                           "plain_ms": _time_ms(lambda: sc.window_argmin_ref(
                               hs, Ls, w, 0, over), 5)},
            }
            for name, n in launches.items():
                out[name]["launches"] = n
            for name, r in out.items():
                say(f"   general {name} at w={w}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
                    f"({r['bound_bytes']} bytes); {r['launches']} launches in the run")
            say(_flag_line(out["flags"],
                           f"the general stream, w={w}, C={Cs} chunks of L={Ls}"))
            say("   the plain compaction's device time by kernel (torch.profiler, one call): "
                + _kernel_split(compaction_plain))
        del h, val, hs, vs, index, firsts, ranks, flags, flat, host, kern, hflat, vflat
    return out


def _sparse_gaps(rng, c: np.ndarray, longest: int = 20) -> None:
    """An N run of 1-``longest`` bp every 2-8 kbp: nearly every k-mer stays
    valid, the general path's most memory a base."""
    at = np.cumsum(rng.integers(2000, 8001, size=c.shape[0] // 2000 + 1))
    at = at[at < c.shape[0] - longest]
    ln = rng.integers(1, longest + 1, size=at.shape[0])
    step = np.arange(longest)
    c[(at[:, None] + step)[step < ln[:, None]]] = 4


def bound_records() -> None:
    """Phase D: for each path one record as long as ``record_bound`` lets
    the card take, against the host sketcher, its peak device memory within
    the path's bytes a base."""
    dev = torch.device("cuda")
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    rng = np.random.default_rng(83)
    for general, per in ((False, sr.FUSED_BYTES_PER_BASE), (True, sr.GENERAL_BYTES_PER_BASE)):
        n = sr.record_bound(dev, general)
        c = rng.integers(0, 4, size=n, dtype=np.uint8)
        if general:
            _sparse_gaps(rng, c)
        path = "general" if general else "fused"
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        with timers.recording(True):
            (got,), peak = _peak_bytes(lambda: sr.sketch_records_torch([c], K, W, "cuda"))
        wall = time.monotonic() - t0
        counts = counters()
        if (counts["sketch_route:host_records"]
                or counts["sketch_route:general_records"] != int(general)):
            fail(f"bound: the {n}-base record did not take the {path} path: {dict(counts)}")
        t0 = time.monotonic()
        want = _oracle(c, W)
        host_s = time.monotonic() - t0
        if not (np.array_equal(got.positions, want.positions)
                and np.array_equal(got.hashes, want.hashes)):
            fail(f"bound: the {n}-base record on the {path} path differs from the host sketcher")
        say(f"== bound ({path} path): one record of {n} bases (record_bound on a card of "
            f"{total_mem} bytes; MAX_RECORD_BASES {sr.MAX_RECORD_BASES}), "
            f"{int((c >= 4).sum())} N bases; equal to the host sketcher ({got.positions.shape[0]} "
            f"minimizers); sketch_records_torch {wall:.3f} s, host {host_s:.3f} s; peak device "
            f"memory {peak} bytes, {peak / n:.2f} a base (bound {per}), "
            f"{peak / total_mem:.3f} of the card")
        if peak > per * n:
            fail(f"bound: the {path} path held {peak / n:.2f} bytes a base, over {per}")
        del c, got, want


# -- phase E: the sketch tiled across a mesh -------------------------------------------

CHR1_BASES = 248_956_422  # human chromosome 1, GRCh38
MESH_KERNELS = ("hash", "flags", "window_emit", "window_emit_gmem", "window", "stream")


def _seam_run(codes: np.ndarray, n_shards: int, length: int) -> int:
    """Paint an N run of ``length`` bases inside the overlap of tiles 0 and
    1 of ``n_shards`` (retiling until it stays there); returns its start."""
    runs = pm._valid_kmer_runs(codes, K)
    n_valid = int(runs[1].sum())
    removed = length + K - 1
    for _ in range(5):
        tw = -(-(n_valid - removed - W + 1) // n_shards)
        # right after the k-mer of rank tw + w/2, inside the overlap
        start = int(pm._kmer_at(runs, np.array([tw + W // 2]))[0]) + K
        trial = codes.copy()
        trial[start : start + length] = 4
        lo, hi, _ = pm._tile_record(trial, n_shards, K, W)
        if lo[1] < start and start + length < hi[0]:
            codes[:] = trial
            return start
        removed = n_valid - int(pm._valid_kmer_runs(trial, K)[1].sum())
    fail(f"mesh: no seam of {n_shards} tiles holds the N run")


def _equal(got, want, what: str) -> None:
    for i, (g, r) in enumerate(zip(got, want)):
        if not (np.array_equal(g.positions, r.positions) and np.array_equal(g.hashes, r.hashes)):
            fail(f"{what}: record {i} differs from the host sketcher")


def _mesh_counted(c: collections.Counter, tiles: int, general: bool, what: str) -> None:
    """Every tile went into a device batch that launched the hash, flag and
    window/emission kernels; none to the host, no plain version."""
    if (c["mesh:tiles"] != tiles or c["sketch_route:host_records"]
            or c["sketch_route:general_records"] != (tiles if general else 0)):
        fail(f"{what}: the tiles did not all take the card's {'general' if general else 'fused'} "
             f"path: {dict(c)}")
    _counted_route(c, W, what)


def mesh_phase(smi: str) -> dict[str, int]:
    """Phase E: sketch_records_sharded over four and three shards of the one
    card, on a chromosome-1-long N-free record and on phase A's draft
    scaffolds with an N run longer than the halo across a seam of each
    tiling, equal to the single-device sketch and the host sketcher; the
    walls of both; the gathered distinct count; dryrun_multichip.  Returns
    the kernels' launches in the sharded runs."""
    rng = np.random.default_rng(91)
    t0 = time.monotonic()
    (chr1,) = genome(rng, [CHR1_BASES])
    bad = chr1 >= 4
    chr1[bad] = rng.integers(0, 4, size=int(bad.sum()), dtype=np.uint8)  # N-free
    drafts, _ = draft_scaffolds()
    seams = {n: _seam_run(drafts[i], n, 3000) for i, n in enumerate((4, 3))}
    say(f"== mesh: one N-free record of {CHR1_BASES} bases (phase 8's generator); phase A's "
        f"{len(drafts)} draft scaffolds with a 3,000-base N run (halo {W + K - 2}) across a seam "
        f"of 4 tiles (record 0, base {seams[4]}) and of 3 (record 1, base {seams[3]}); made in "
        f"{time.monotonic() - t0:.1f} s")
    launches = dict.fromkeys(MESH_KERNELS, 0)
    for name, recs in (("chr1", [chr1]), ("drafts", drafts)):
        general = name == "drafts"
        t0 = time.monotonic()
        want = [_oracle(c, W) for c in recs]
        host_s = time.monotonic() - t0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        single = sr.sketch_records_torch(recs, K, W, "cuda")
        single_s = time.monotonic() - t0
        _equal(single, want, f"mesh ({name}): the single-device sketch")
        for n_shards in (4, 3):
            t0 = time.monotonic()
            with timers.recording(True):
                got = pm.sketch_records_sharded(recs, K, W, ["cuda:0"] * n_shards)
            wall = time.monotonic() - t0
            counts = counters()
            _equal(got, want, f"mesh ({name}, {n_shards} shards)")
            _mesh_counted(counts, n_shards * len(recs), general,
                          f"mesh ({name}, {n_shards} shards)")
            for k in MESH_KERNELS:
                launches[k] += counts["launch:" + k]
            say(f"   {name}, {n_shards} shards of cuda:0: equal to the single-device sketch and "
                f"the host sketcher ({sum(g.positions.shape[0] for g in got)} minimizers); "
                f"sharded {wall:.3f} s, single-device {single_s:.3f} s, host {host_s:.3f} s "
                f"({smi}); counts {json.dumps(counts)}")
        if name == "chr1":
            h = got[0].hashes
            per = -(-h.shape[0] // 4)
            vals = np.zeros(4 * per, dtype=np.uint64)
            vals[: h.shape[0]] = h
            uniq, total = pm.distributed_unique_count(
                ["cuda:0"] * 4, torch.from_numpy(vals.view(np.int64).reshape(4, per)),
                torch.full((4,), per))
            expect = np.unique(vals).shape[0]
            if uniq.tolist() != [expect] * 4 or total.tolist() != [4 * per] * 4:
                fail(f"mesh: distributed_unique_count {uniq.tolist()} {total.tolist()}, "
                     f"np.unique {expect}")
            say(f"   distributed_unique_count over 4 rows of its sketch on cuda:0: {expect} "
                "distinct, as np.unique")
        del single, got, want
    dryrun_multichip(8, "cuda")
    say("   dryrun_multichip(8, 'cuda'): every step equal to its oracle")
    return {k: v for k, v in launches.items() if v}


# -- phase F: two processes on the one card --------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tsv_hashes(path: str) -> np.ndarray:
    """The hashes of a minimizer TSV as int64, in stream order, duplicates
    kept."""
    hs = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            hs += [int(t.split(":", 1)[0]) for t in line.rstrip("\n").split("\t")[1].split()]
    return np.array(hs, dtype=np.uint64).view(np.int64)


def distributed_phase(work: str, args: list[str]) -> dict[str, int]:
    """Phase F: ``assemble backend=cuda n_procs=2 local_devices=2`` as two
    processes on the one card, in a directory of its own beside phase 8's
    card run (``work/port``), whose artifacts it must give byte for byte;
    each process's counters; then the hash-bucket verdict over the three
    assemblies' streams on the card against the replicated one.  Returns the
    kernels' launches summed over both processes."""
    port, dist = os.path.join(work, "port"), os.path.join(work, "dist")
    os.makedirs(dist)
    for fa in ("ref1.fa", "ref2.fa", "target.fa"):
        os.link(os.path.join(port, fa), os.path.join(dist, fa))
    coord = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "ntjoin_tpu_torch.cli", "assemble", "backend=cuda", *args,
           "n_procs=2", "local_devices=2", f"coordinator={coord}"]
    t0 = time.monotonic()
    procs = [subprocess.Popen(cmd + [f"process_id={pid}"], cwd=dist,
                              env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.monotonic() - t0
    for pid, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"distributed: process {pid} exited {p.returncode}:\n{err[-4000:]}")
    say(f"== distributed: two processes of two shards each on cuda:0 (gloo at {coord}); "
        f"wall {wall:.3f} s for both")
    launches = dict.fromkeys(MESH_KERNELS, 0)
    for pid, (out, _) in enumerate(outs):
        c = counters(_counts_line(out, "trace_counts")["counters"])
        if (c["dist:shards@cuda"] != 4 or c["sketch_route:host_records"] or _plain_calls(c)
                or c["launch:hash"] < 1 or c["launch:flags"] != sc.FLAG_LAUNCHES * c["launch:hash"]
                or c["launch:window_emit"] < 1
                or c["dist:exchanges:all_to_all"] != 2 or c["dist:exchange_bytes:all_to_all"] <= 0
                or "dist:verdict_us" not in c):
            fail(f"distributed: process {pid} did not hold 4 shards on the card, sketch on the "
                 f"card's kernels, exchange and judge on the card: {dict(c)}")
        for k in MESH_KERNELS:
            launches[k] += c["launch:" + k]
        say(f"   process {pid}: {c['dist:records']} records, {c['dist:entries']} minimizers, "
            f"{c['dist:survivors']} survive; bytes sent by 2 exchanges "
            f"{c['dist:exchange_bytes:all_to_all']}; verdict on the card "
            f"{c['dist:verdict_us'] / 1e3:.3f} ms; counts {json.dumps(c)}")
    made = [f for f in sorted(os.listdir(dist)) if not f.endswith(".fa") or "scaffolds" in f]
    for f in ("e2e.path", "e2e.agp", "e2e.mx.dot",
              *(f"target.fa.k{K}.w{W}.n2.{p}.scaffolds.fa" for p in ("assigned", "unassigned",
                                                                       "all"))):
        if f not in made:
            fail(f"distributed: artifact {f} missing")
    for f in made:
        if not filecmp.cmp(os.path.join(dist, f), os.path.join(port, f), shallow=False):
            fail(f"distributed: artifact {f} differs from the one-process card run's")
    say(f"   {len(made)} artifacts byte-equal to phase 8's card run ({', '.join(made)})")

    # the verdict over the three streams, 4 shards of the card, both ways
    streams = [_tsv_hashes(os.path.join(port, f"{fa}.k{K}.w{W}.tsv"))
               for fa in ("ref1.fa", "ref2.fa", "target.fa")]
    h = np.concatenate(streams)
    asm = np.repeat(np.arange(3), [s.shape[0] for s in streams])
    width = -(-h.shape[0] // 4)
    rows = [torch.from_numpy(pp._pack_rows(x, fill, 4, width)).cuda()
            for x, fill in ((h, 0), (asm, -1), (np.ones(h.shape[0], bool), False))]
    bw = pd.bucket_width_for_rows(rows[0].cpu().numpy(), rows[2].cpu().numpy(), 4)
    with timers.recording(True):
        sharded = pd.distributed_survive_sharded(*rows, 3, bw).reshape(-1)
    sharded_ms = timers.COUNTERS["dist:verdict_us"] / 1e3
    with timers.recording(True):
        replicated = pd.distributed_survive(*rows, 3)
    replicated_ms = timers.COUNTERS["dist:verdict_us"] / 1e3
    if not torch.equal(sharded, replicated):
        fail(f"distributed: sharded and replicated verdicts differ in "
             f"{int((sharded != replicated).sum())} entries")
    say(f"   the hash-bucket verdict over the three streams ({h.shape[0]} minimizers, 4 shards "
        f"of {width}, buckets of {bw}) bit-equal to the replicated one on the card; "
        f"{int(sharded.sum())} survive; verdict {sharded_ms:.3f} ms sharded, "
        f"{replicated_ms:.3f} ms replicated")
    return {k: v for k, v in launches.items() if v}


# -- phase B: Mann-Kendall ------------------------------------------------------------


def _mk_bound(batches, host_lengths) -> dict:
    """The S kernel's bound: what the function must move, the valid values
    read once (8 bytes each; the padding is never read), the lengths in and
    S out; its binary-search steps (``mk.mk_steps``), one operation a step.
    ``scratch_bytes`` is the design's own traffic, not in the bound: rows of
    several tiles write their sorted tiles and read them once more."""
    nbytes = steps = scratch = 0
    for (p, _), n in zip(batches, host_lengths):
        width = int(p.shape[1])
        nbytes += 8 * int(n.sum()) + 16 * len(n)
        if width > mk.MK_TILE:
            scratch += 16 * int(n.sum())
        steps += mk.mk_steps(n, width)
    return {**bound(nbytes, steps), "steps": steps, "scratch_bytes": scratch}


def _long_row(n: int, seed: int = 72) -> list[int]:
    """A run of n positions, sorted with a fifth of its values moved."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.integers(0, 2**40, size=n))
    swap = rng.random(n) < 0.2
    x[swap] = rng.integers(0, 2**40, size=int(swap.sum()))
    return x.tolist()


def _mk_rows() -> float:
    """The S kernel on four more inputs, each bit-equal to its plain version
    on the card: a row of 2^19 values (the kernel's and the plain version's
    times), an all-equal and a strictly decreasing row of 100,000, and one
    batch of rows of length 0, 1 and more with garbage past each length.
    Returns the largest difference (0)."""
    n19, n = 1 << 19, 100_000
    cases = []
    for what, run, want in (("2^19 values, 20% moved", _long_row(n19), None),
                            ("100,000 equal values", [5] * n, 0),
                            ("100,000 decreasing values", list(range(7 * n, 0, -7)),
                             -(n * (n - 1) // 2))):
        ((_, pos, lengths),) = orientation._mk_batches([run])
        cases.append((what, torch.from_numpy(pos).cuda(), torch.from_numpy(lengths).cuda(),
                      want))
    short = [[], [3], [], [9], [4, 4, 1, 8, 8, 2, 7, 7], [6, 2, 9, 1, 5]]
    rng = np.random.default_rng(73)
    pos = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, size=(len(short), 8)))
    for row, r in enumerate(short):
        pos[row, : len(r)] = torch.tensor(r, dtype=torch.int64)
    cases.append(("a batch of lengths 0, 1, 0, 1, 8, 5", pos.cuda(),
                  torch.tensor([len(r) for r in short]).cuda(), None))
    err = 0.0
    for what, p, n, want in cases:
        got = mk.mk_s_batch(p, n)
        err = max(err, _compare(f"mann-kendall S kernel ({what})", (got,),
                                (mk.mk_s_batch_ref(p, n),)))
        if want is not None and got.tolist() != [want]:
            fail(f"mann-kendall ({what}): S {got.tolist()}, want {want}")
        if got[n < 2].any():
            fail(f"mann-kendall ({what}): a row of length 0 or 1 has S != 0")
        tile, _, _, pairs, _ = mk.mk_launch(*p.shape)
        line = (f"   S kernel on {what} (B={p.shape[0]}, width {p.shape[1]}, tiles of {tile}, "
                f"{pairs} tile pairs a row): S {got.tolist()} bit-equal to the plain version; "
                f"{_time_ms(lambda p=p, n=n: mk._mk_s_kernel(p, n), 5):.4f} ms")
        if p.shape[1] >= n19:
            plain_ms = _time_ms(lambda p=p, n=n: mk.mk_s_batch_ref(p, n), 1)
            line += f", the plain version {plain_ms:.1f} ms"
        say(line)
    return err


def mann_kendall() -> dict:
    """Phase B: the batched Mann-Kendall S on the card against the CPU, on
    runs of the sizes a 1 Gbp path gives: the S kernel against its plain
    version on the card (and on four more inputs, ``_mk_rows``), its time
    back to back and queued beside the plain version's, the public op's,
    the ``_mk_s`` route's and the host scalar route's on the same runs, the
    launches of its two passes, and the verdicts of both.  Returns the
    kernel's times and bound."""
    runs = split_bench.mk_runs()
    packed = [(pos, n) for _, pos, n in orientation._mk_batches(runs)]
    batches = [(torch.from_numpy(pos).cuda(), torch.from_numpy(n).cuda()) for pos, n in packed]
    host_lengths = [n for _, n in packed]
    err = _compare("mann-kendall S kernel", [mk.mk_s_batch(p, n) for p, n in batches],
                   [mk.mk_s_batch_ref(p, n) for p, n in batches])
    err = max(err, _mk_rows())

    def kernel():
        for pos, n in batches:
            mk._mk_s_kernel(pos, n)

    def op():
        for pos, n in batches:
            mk.mk_s_batch(pos, n)

    def route():  # the op as core.orientation._mk_s calls it: lengths checked on the host
        for (pos, _), n in zip(batches, host_lengths):
            mk.mk_s_batch_host(pos, n)

    def plain():
        for pos, n in batches:
            mk.mk_s_batch_ref(pos, n)

    with timers.recording(True):
        kernel()
    launched = timers.COUNTERS.get("launch:mk_s", 0)
    sort_launches = len(batches)  # pass 2 only where a row has several tiles
    cross_launches = sum(mk.mk_launch(*p.shape)[3] > 0 for p, _ in batches)
    if launched != sort_launches + cross_launches:
        fail(f"mann-kendall: {launched} launches of the S kernel over {len(batches)} batches, "
             f"want {sort_launches} + {cross_launches}")
    kernel_ms, queued_ms = _time_ms(kernel, 5), _time_queued_ms(kernel, 2)
    op_ms, route_ms, plain_ms = _time_ms(op, 5), _time_ms(route, 5), _time_ms(plain, 1)
    t0 = time.monotonic()
    with timers.recording(True):
        s_card = orientation._mk_s(runs, torch.device("cuda"))
    card_s = time.monotonic() - t0
    counts = counters()
    if counts["mk:runs@cuda"] != len(runs) or counts["mk:runs@cpu"]:
        fail(f"mann-kendall: the op did not run on the card: {dict(counts)}")
    t0 = time.monotonic()
    s_cpu = orientation._mk_s(runs, torch.device("cpu"))
    cpu_s = time.monotonic() - t0
    if s_card != s_cpu:
        fail(f"mann-kendall: S differs between the card and the CPU in "
             f"{sum(x != y for x, y in zip(s_card, s_cpu))} runs")
    t0 = time.monotonic()
    scalar = [orientation.determine_orientation(r, True, 90) for r in runs]
    scalar_s = time.monotonic() - t0
    if orientation.determine_orientations(runs, True, 90, "cuda") != scalar:
        fail("mann-kendall: the batched verdicts differ from the scalar route's")
    say(f"== mann-kendall: {len(runs)} runs (B=4096 of L=2..2048 positions, 2 of 100,000), "
        f"{counts['mk:batches@cuda']} batches by padded width; S of the kernel equal to its plain "
        f"version's on the card, and on the card and the CPU; verdicts "
        f"{sum(v == '+' for v in scalar)} +, {sum(v == '-' for v in scalar)} -, "
        f"{sum(v == '?' for v in scalar)} ? as the scalar route's")
    pairs = sum(len(r) * (len(r) - 1) // 2 for r in runs)
    out = {"ms": kernel_ms, "queued_ms": queued_ms, "plain_ms": plain_ms, "max_abs_err": err,
           "library_ms": None, **_mk_bound(batches, host_lengths)}
    by, op_bound = out["bound_bytes"] / PEAK_BYTES_S * 1e3, out["steps"] / PEAK_OPS_S * 1e3
    say(f"   the S kernel {kernel_ms:.4f} ms for {len(batches)} batches back to back, "
        f"{queued_ms:.4f} ms queued behind a spinning kernel ({sort_launches} pass 1 and "
        f"{cross_launches} pass 2 launches); the public op with its checks {op_ms:.4f} ms, "
        f"the op on _mk_s's route (lengths checked on the host) {route_ms:.4f} ms, the plain "
        f"version {plain_ms:.3f} ms (CUDA events); bound {out['bound_ms']:.4f} ms by "
        f"{out['bound_by']}: {out['bound_bytes']} bytes {by:.4f} ms, {out['steps']} search "
        f"steps {op_bound:.4f} ms at {PEAK_OPS_S:.3g} a second ({pairs} pairs in the runs; "
        f"the design's own scratch of sorted tiles, outside the bound, "
        f"{out['scratch_bytes']} bytes {out['scratch_bytes'] / PEAK_BYTES_S * 1e3:.4f} ms); "
        f"_mk_s with the host's packing and copies {card_s:.3f} s; the plain version on the "
        f"CPU {cpu_s:.3f} s; the host scalar route {scalar_s:.3f} s")
    return out


# -- phase 8 and phase C: end to end ---------------------------------------------------

_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _fasta(path: str, names: list[str], seqs: list[np.ndarray], width: int = 80) -> None:
    with open(path, "wb") as fh:
        for name, c in zip(names, seqs):
            s = _ASCII[c]
            full = s.shape[0] // width
            body = np.empty((full, width + 1), dtype=np.uint8)
            body[:, :width] = s[: full * width].reshape(full, width)
            body[:, width] = ord("\n")
            fh.write(b">" + name.encode() + b"\n" + body.tobytes())
            if s.shape[0] > full * width:
                fh.write(s[full * width :].tobytes() + b"\n")


def genome(rng, sizes: list[int]) -> list[np.ndarray]:
    """Chromosomes of seeded random bases with ~1% of bases in N gaps of
    100-5,000 bp, homopolymers, microsatellites and satellite arrays."""
    chroms = []
    for n in sizes:
        c = rng.integers(0, 4, size=n, dtype=np.uint8)

        def spots(count, longest):
            return rng.integers(0, n - longest, size=count)

        for s in spots(n // 250_000, 5000):
            c[s : s + int(rng.integers(100, 5001))] = 4
        for s in spots(n // 50_000, 60):
            c[s : s + int(rng.integers(10, 61))] = rng.integers(0, 4)
        for s in spots(n // 50_000, 3000):
            unit = rng.integers(0, 4, size=int(rng.integers(1, 7)), dtype=np.uint8)
            ln = int(rng.integers(20, 301)) if rng.random() < 0.95 else int(rng.integers(1000, 3001))
            c[s : s + ln] = np.resize(unit, ln)
        for s in spots(n // 5_000_000 + 1, 30_000):
            unit = rng.integers(0, 4, size=int(rng.integers(10, 101)), dtype=np.uint8)
            ln = int(rng.integers(3000, 30_001))
            c[s : s + ln] = np.resize(unit, ln)
        chroms.append(c)
    return chroms


def _revcomp(c: np.ndarray) -> np.ndarray:
    r = c[::-1].copy()
    ok = r < 4
    r[ok] = 3 - r[ok]
    return r


def references(work: str, chroms: list[np.ndarray], rng) -> None:
    """ref1 = the chromosomes, ref2 = 0.1% substitutions."""
    names = [f"chr{i + 1}" for i in range(len(chroms))]
    _fasta(os.path.join(work, "ref1.fa"), names, chroms)
    subs = []
    for c in chroms:
        c2 = c.copy()
        idx = rng.choice(c.shape[0], c.shape[0] // 1000, replace=False)
        idx = idx[c2[idx] < 4]
        c2[idx] = (c2[idx] + rng.integers(1, 4, size=idx.shape[0])) % 4
        subs.append(c2)
    _fasta(os.path.join(work, "ref2.fa"), names, subs)


def contigs_target(work: str, chroms: list[np.ndarray], rng, n_contigs: int = 2000) -> None:
    """target = shuffled contigs, a quarter reverse-complemented, some with
    terminal Ns."""
    total = sum(c.shape[0] for c in chroms)
    contigs = []
    for c in chroms:
        m = max(1, round(n_contigs * c.shape[0] / total))
        cuts = np.sort(rng.choice(np.arange(1, c.shape[0]), m - 1, replace=False))
        for a, b in zip(np.concatenate([[0], cuts]), np.concatenate([cuts, [c.shape[0]]])):
            piece = c[a:b].copy()
            if rng.random() < 0.25:
                piece = _revcomp(piece)
            if rng.random() < 0.1:
                t = int(rng.integers(1, 50))
                if rng.random() < 0.5:
                    piece[:t] = 4
                else:
                    piece[-t:] = 4
            contigs.append(piece)
    order = rng.permutation(len(contigs))
    _fasta(os.path.join(work, "target.fa"), [f"contig{i}" for i in range(len(order))],
           [contigs[i] for i in order])


def draft_target(work: str, chroms: list[np.ndarray], rng) -> None:
    """target = a short-read draft: scaffolds of ~5 Mbp with an N gap of
    50-500 bp every 2-8 kbp (past the segmented route's guard at w=1000),
    every third with two 30 kbp blocks swapped (a misjoin: positions not
    monotonic, so Mann-Kendall decides its orientation), a quarter
    reverse-complemented, shuffled."""
    scaffolds = []
    for c in chroms:
        m = max(1, round(c.shape[0] / 5_000_000))
        for piece in np.array_split(c, m):
            piece = piece.copy()
            _paint_gaps(rng, piece)
            if len(scaffolds) % 3 == 1:
                a = piece.shape[0] // 3
                piece[a : a + 60_000] = np.concatenate([piece[a + 30_000 : a + 60_000],
                                                        piece[a : a + 30_000]])
            if rng.random() < 0.25:
                piece = _revcomp(piece)
            scaffolds.append(piece)
    order = rng.permutation(len(scaffolds))
    _fasta(os.path.join(work, "target.fa"), [f"scaffold{i}" for i in range(len(order))],
           [scaffolds[i] for i in order])


def _run(cmd: list[str], cwd: str) -> tuple[float, str]:
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.monotonic()
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=900)
    wall = time.monotonic() - t0
    if res.returncode != 0:
        fail(f"{' '.join(cmd[:4])} exited {res.returncode}:\n{res.stderr[-4000:]}")
    return wall, res.stdout


def _stages(out: str) -> list[str]:
    lines = out.splitlines()
    if "stage\twall_s\tpeak_rss_kb" not in lines:
        return []
    i = lines.index("stage\twall_s\tpeak_rss_kb")
    return [ln for ln in lines[i + 1 :] if ln.count("\t") == 2 and "_counts\t" not in ln]


def _stage_rss(work: str, prefix: str, out: str) -> dict[str, dict[str, int]]:
    """Each stage the run printed in ``out``, in its order: the resident
    set (kB) at its start and end and the highest read while it was open,
    from its `.time` file in ``work``; printed in GB."""
    rss = {}
    for name in (ln.split("\t")[0] for ln in _stages(out)):
        safe = name.replace("/", "_").replace(":", ".")
        with open(os.path.join(work, f"{prefix}.{safe}.time"), encoding="utf-8") as fh:
            kv = dict(ln.split("\t") for ln in fh.read().splitlines())
        rss[name] = {key: int(kv[key]) for key in ("rss_start_kb", "rss_end_kb", "rss_max_kb")}
        say(f"     {name}: rss_start {rss[name]['rss_start_kb'] / 1e6:.3f} GB, rss_end "
            f"{rss[name]['rss_end_kb'] / 1e6:.3f} GB, peak {rss[name]['rss_max_kb'] / 1e6:.3f} GB")
    if not rss:
        fail(f"the run in {work} printed no stage")
    return rss


def _fai(work: str, fa: str) -> list[int]:
    """The record lengths of ``fa`` in ``work``, from its .fai file."""
    with open(os.path.join(work, fa + ".fai"), encoding="utf-8") as fh:
        return [int(ln.split("\t")[1]) for ln in fh]


def _check_held(work: str, held: int) -> None:
    """``codes_held_max`` of the card run: no more than one batch's buffer
    for its largest assembly (its records and separators, as
    sketch_records.stream_len pads them: below t + C + w + k) or the
    probe's block; no record took the host."""
    t = min(sr.BATCH_BASES, max(sum(n + K - 1 for n in _fai(work, fa))
                                for fa in ("ref1.fa", "ref2.fa", "target.fa")))
    most = max(t + sc.layout(t, K, W)[0] + W + K, native.PROBE_BASES)
    say(f"   card run's codes_held_max {held} bytes (bound {most}: one batch's buffer)")
    if not 0 < held <= most:
        fail(f"the card run held {held} bytes of codes at once, bound {most}")


def _check_sketch_rss(work: str, rss: dict, held: int) -> None:
    """Each sketch stage of the card run after the first (which also makes
    the CUDA context and loads the kernels) grows its resident set by no
    more than what streaming holds: the reader's byte a base, the larger of
    the reader's growing copy of its longest record (up to twice that
    record) and the codes held (``codes_held_max``), and half a byte a base
    for the rest (sketches, TSV text, the allocator).  An assembly's codes
    or ``str``s held whole would add a byte a base."""
    for name in [s for s in rss if s.startswith("sketch:")][1:]:
        lens = _fai(work, name.split(":", 1)[1])
        bases = sum(lens)
        most = bases + max(2 * max(lens), held) + bases // 2
        grew = (rss[name]["rss_max_kb"] - rss[name]["rss_start_kb"]) * 1024
        say(f"   {name} grew {grew} bytes, {grew / bases:.3f} a base (bound {most}, "
            f"{most / bases:.3f} a base)")
        if grew > most:
            fail(f"{name} grew its resident set by {grew} bytes for {bases} bases, bound {most}: "
                 "the sketch stage holds more than one batch of the assembly")


def _counts_line(out: str, key: str) -> dict:
    line = next((ln for ln in out.splitlines() if ln.startswith(key + "\t")), None)
    if line is None:
        fail(f"the port printed no {key}")
    return json.loads(line.split("\t", 1)[1])


def e2e(sizes: list[int], target, words: tuple[str, ...] = (),
        what: str = "e2e", then=None) -> tuple[dict, dict, object]:
    """Phase 8 (and phase C): the port's assemble on the card against its
    host path (C++ sketcher, NumPy graph layers), with the target that
    ``target`` writes and the extra ``words``; then ``then(work directory,
    the assemble words)`` (phase F).  Returns the card run's counters and
    what ``then`` returned."""
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory(prefix="ntjoin_smoke_") as tmp:
        port, ref = os.path.join(tmp, "port"), os.path.join(tmp, "ref")
        os.makedirs(port)
        os.makedirs(ref)
        t0 = time.monotonic()
        chroms = genome(rng, sizes)
        references(port, chroms, rng)
        target(port, chroms, rng)
        for fa in ("ref1.fa", "ref2.fa", "target.fa"):
            os.link(os.path.join(port, fa), os.path.join(ref, fa))
        say(f"== {what}: {sum(sizes)} bp genome in {len(sizes)} chromosomes, target by "
            f"{target.__name__}, {' '.join(words) or 'no more words'}; written in "
            f"{time.monotonic() - t0:.1f} s")
        args = ["target=target.fa", "references=ref1.fa ref2.fa", "reference_weights=2 2",
                f"k={K}", f"w={W}", "n=2", "agp=True", "time=True", "prefix=e2e", *words]
        host = "native" if native.available() else "numpy"
        p_wall, p_out = _run([sys.executable, "-m", "ntjoin_tpu_torch.cli", "assemble", "-B",
                              "backend=cuda", *args], port)
        r_wall, r_out = _run([sys.executable, "-m", "ntjoin_tpu_torch.cli", "assemble", "-B",
                              f"backend={host}", "index_backend=host", *args], ref)
        want = [f"{fa}{ext}" for fa in ("ref1.fa", "ref2.fa", "target.fa")
                for ext in (".fai", f".k{K}.w{W}.tsv")]
        want += ["e2e.path", "e2e.mx.dot", "e2e.agp", f"e2e.target.fa.k{K}.w{W}.tsv.unassigned.bed"]
        want += [f"target.fa.k{K}.w{W}.n2.{p}.scaffolds.fa" for p in ("assigned", "unassigned", "all")]
        # every artifact the host run made (inputs and stage timings aside)
        made = {f for f in os.listdir(ref) if not f.endswith((".time", ".fa")) or "scaffolds" in f}
        made |= set(want)
        for f in sorted(made):
            a, b = os.path.join(port, f), os.path.join(ref, f)
            if not (os.path.exists(a) and os.path.exists(b)):
                fail(f"artifact {f} missing (card {os.path.exists(a)}, host {os.path.exists(b)})")
            if not filecmp.cmp(a, b, shallow=False):
                fail(f"artifact {f} differs between the card run and the host path")
        with open(os.path.join(port, "e2e.path"), encoding="utf-8") as fh:
            joins = sum(1 for ln in fh if ln.startswith("ntJoin"))
        if joins == 0:
            fail("no scaffold joined: the e2e run did no work")
        say(f"   {len(made)} artifacts byte-equal ({', '.join(sorted(made))})")
        say(f"   {joins} scaffolds in e2e.path")
        say(f"   card (backend=cuda) wall {p_wall:.3f} s; stages:")
        for ln in _stages(p_out):
            say("     " + ln)
        p_rss = _stage_rss(port, "e2e", p_out)
        say(f"   host (backend={host}, index_backend=host) wall {r_wall:.3f} s; stages:")
        for ln in _stages(r_out):
            say("     " + ln)
        _stage_rss(ref, "e2e", r_out)
        counts = counters(_counts_line(p_out, "trace_counts")["counters"])
        _check_held(port, counts["sketch:codes_held_max"])
        _check_sketch_rss(port, p_rss, counts["sketch:codes_held_max"])
        say(f"   card run's counters: {json.dumps(counts)}")
        host_counts = counters(_counts_line(r_out, "trace_counts")["counters"])
        say(f"   host run's counters: {json.dumps(host_counts)}")
        if any(host_counts["launch:" + name] for name in SOURCES) or any(
                name.startswith("graph:") for name in host_counts):
            fail("the host path launched a kernel or a torch graph op: no independent oracle")
        for op in GRAPH_OPS:
            if counts[f"graph:{op}@cuda"] < 1 or counts[f"graph:{op}@cpu"]:
                fail(f"graph op {op} did not run on the GPU in the e2e run: {dict(counts)}")
        return counts, then(tmp, args) if then else None


JSON_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    smi = card()
    build()
    times = kernels()
    times["copy"] = copy()
    counts = {"window_emit_gmem": sketch()}
    counts["copy"] = prof()["launch:copy"]  # the profiler is the copy kernel's main path
    graph()
    general_path = general()
    times["stream"] = general_path["stream"]
    times["mk_s"] = mann_kendall()
    sizes = [24_000_000, 22_000_000, 20_000_000, 18_000_000, 16_000_000]
    run, dist_launches = e2e(sizes, contigs_target, then=distributed_phase)
    if run["sketch_route:host_records"] != 0:
        fail(f"{run['sketch_route:host_records']} records took the host sketcher")
    if run["launch:flags"] != sc.FLAG_LAUNCHES * run["launch:hash"]:
        fail(f"the e2e run's batches went round the flag kernel: {dict(run)}")
    counts.update({name: run["launch:" + name]
                   for name in ("hash", "flags", "window_emit", "window", "stream")})
    # phase C: the same genome, an N-dense draft target, mkt=True
    draft, _ = e2e(sizes, draft_target, ("mkt=True",), "e2e, N-dense draft, mkt=True")
    if draft["sketch_route:general_records"] < 1 or draft["sketch_route:host_records"]:
        fail(f"the draft's N-dense scaffolds did not take the general path: {dict(draft)}")
    _counted_route(draft, W, "e2e draft")
    if draft["mk:runs@cuda"] < 1 or draft["mk:runs@cpu"]:
        fail(f"the Mann-Kendall op did not run on the card in the mkt=True run: {dict(draft)}")
    counts["mk_s"] = draft["launch:mk_s"]  # the mkt=True run is the S kernel's main path
    bound_records()
    mesh_launches = mesh_phase(smi)

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "ntjoin_tpu"
              or m.startswith("ntjoin_tpu.")]
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded[:5]}")
    for name in SOURCES:
        if counts[name] < 1:
            fail(f"kernel {name} was not launched on its main path")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         **{key: times[name][key] for key in JSON_KEYS + ("bound_bytes",)},
         **{key: times[name][key] for key in ("launch_floor_ms", "queued_ms")
            if key in times[name]},
         **({"launches_general": general_path[name]["launches"]}
            if name in general_path else {}),
         **({"general_ms": general_path[name]["ms"]} if name in general_path else {}),
         **({"launches_mesh": mesh_launches[name]} if name in mesh_launches else {}),
         **({"launches_dist": dist_launches[name]} if name in dist_launches else {})}
        for name in SOURCES
    ]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
