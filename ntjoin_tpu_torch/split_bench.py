"""Times of the flag kernel and of the two kernels that read their rows from
device memory (kernel 3 and kernel 2's device-memory route) on one CUDA GPU,
for tuning them and for comparing two trees in one call.

    python -m ntjoin_tpu_torch.split_bench times [--quick] [--unchecked] [--flags]
    python -m ntjoin_tpu_torch.split_bench sweep
    python -m ntjoin_tpu_torch.split_bench variant DIR [noscan] [noload] [nostore]
                                                   [noballot] [rows=N] [threads=N]
                                                   [flagrows=N] [flagthreads=N]
    python -m ntjoin_tpu_torch.split_bench stream [--quick]
    python -m ntjoin_tpu_torch.split_bench mk

``times`` holds each op bit-equal to its plain version and prints one JSON
line per (window, stream) with CUDA-event milliseconds: 2^24 bases at w=10,
100, 1000, 4243, 8362, 8363 and 20000, and (without ``--quick``) 2^27 bases
at w=1000, 5000 and 10000; ``exact_over_ms`` is kernel 3 over the chunks whose
emission lists overflowed (``--unchecked``: no comparison, for a tree
with parts compiled out).  The flag op is timed as its callers launch it
(``flags_ms``) and queued behind a spinning kernel (``flags_queued_ms``:
the device time alone, where the host is slower than the launches), beside
its bound (``flags_bound_ms``: the elements in and the flags out at 3.35
TB/s) and, in a tree whose flag kernel runs as three passes, each pass
queued (``flags_summary_ms``, ``flags_scan_ms``, ``flags_walk_ms``);
``--flags`` times the flag op alone.  It uses only what the package has offered since
its first version, so a copy of this file in another tree's package times
that tree (run it from that tree's root: parent, change, change, parent in
one call).  ``sweep`` times both kernels for every (chunks, threads) a thread
block at 2^27 bases.  ``variant`` copies the package into DIR with parts of
the split kernels compiled out (the scans, the loads, kernel 3's stores, the
flag kernel's ballots: times then say what each part costs, outputs are
wrong) or with other rows a thread and threads a block (the split kernels'
``rows``/``threads``, the flag walk's ``flagrows``/``flagthreads``); run
``times --unchecked`` or ``sweep`` from DIR.  ``stream`` times the general
path's compaction kernel (``ops/sketch_general.py``) pass by pass on 100 Mbp
of draft scaffolds (20 of 5 Mbp, an N run of 50-500 bp every 2-8 kbp) at
w=1000 and 5000 (``--quick``: 1000 only), its outputs held bit-equal to
the plain version's first (``--unchecked``: not), and the whole general
call (``sketch_general_torch``, ``call_ms``); on a tree whose
compaction still makes a position for every rank (its ``_positions``) it
times that tree's passes, so that a copy of this file in such a tree's
package compares the two in one call.  ``mk`` times the Mann-Kendall S
kernel queued (``queued_ms``) on ``chip_smoke.py`` phase B's runs
(``mk_runs``), the 64 batches and each run of 100,000 alone, each held
bit-equal to the plain version first, and traces the 64 batches queued
and back to back with torch.profiler (``trace_queued``, ``trace``: the
kernels, their device time, the span, its idle share and the SMs the
grids could fill).  It calls only ``_mk_s_kernel`` and ``mk_s_batch_ref``,
which every tree with the S kernel has, so a copy of this file in another
tree's package times that tree.  Exits 2 without a
CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from ntjoin_tpu_torch.ops import sketch_cuda as sc

K = 32


def _codes(n: int, n_ns: int) -> np.ndarray:
    """Seeded bases with N runs, a poly-C and an AC stretch."""
    rng = np.random.default_rng(2027)
    codes = rng.integers(0, 4, size=n, dtype=np.int8)
    for s in rng.integers(0, n - 6000, size=n_ns):
        codes[s : s + int(rng.integers(10, 5000))] = 4
    codes[n // 3 : n // 3 + 5000] = 1
    s = 2 * n // 3
    codes[s : s + 5000 : 2] = 0
    codes[s + 1 : s + 5001 : 2] = 1
    return codes


def _cell(codes: np.ndarray, w: int):
    """Hashes, valid flags and layout of the stream at window w, on the card."""
    n = codes.shape[0]
    C, L = sc.layout(n, K, w)
    flat = np.full(C * L + w + K - 2, 4, dtype=np.int8)
    flat[:n] = codes
    h, val = sc.hash_chunked(torch.from_numpy(flat).cuda(), L, C, L + w + K - 2, K)
    return h, val, C, L, K - 1


def _ms(fn, reps: int = 5) -> float:
    """Best of two CUDA-event means over ``reps`` back-to-back calls."""
    best = float("inf")
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


_CHECKED = True


def _same(name: str, got, want) -> None:
    for g, r in zip(got, want) if _CHECKED else ():
        if not torch.equal(g, r):
            raise SystemExit(f"split_bench: {name} differs from its plain version")


def times(quick: bool, flags_only: bool = False) -> None:
    flags_ref = getattr(sc, "window_flags_ref", sc.window_flags)
    cells = [(1 << 24, 8, w) for w in (10, 100, 1000, 4243, 8362, 8363, 20000)]
    if not quick:
        cells += [(1 << 27, 64, w) for w in (1000, 5000, 10000)]
    streams: dict[int, np.ndarray] = {}
    for n, n_ns, w in cells:
        if n not in streams:
            streams[n] = _codes(n, n_ns)
        h, val, C, L, off = _cell(streams[n], w)
        flags = sc.window_flags(val, L, w, off)
        _same(f"flags w={w}", (flags,), (flags_ref(val, L, w, off),))
        out = {"bases": n, "w": w, "chunks": C, "chunk_len": L,
               "flags_ms": _ms(lambda: sc.window_flags(val, L, w, off), 10),
               "flags_queued_ms": _queued_ms(lambda: sc.window_flags(val, L, w, off), 10),
               "flags_bound_ms": (L + w - 1 + L) * flags.stride(0) / 3.35e9}
        if hasattr(sc, "_flag_masks"):  # the three-pass flag kernel
            masks = sc._flag_masks(val, L, w, off)
            P = sc._flag_scan(masks)
            out["flags_summary_ms"] = _queued_ms(lambda: sc._flag_masks(val, L, w, off), 10)
            out["flags_scan_ms"] = _queued_ms(lambda: sc._flag_scan(masks), 10)
            out["flags_walk_ms"] = _queued_ms(lambda: sc._flag_walk(masks, P, C, L, w), 10)
            del masks, P
        if flags_only:
            print(json.dumps(out), flush=True)
            continue
        cap = sc._slot_cap(L, w)
        want = sc.window_emit_ref(h, flags, L, w, off, cap)
        _same(f"device-memory route w={w}", sc._window_emit_gmem(h, flags, L, w, off, cap), want)
        over = torch.nonzero(want[2] > cap).flatten()
        del want
        _same(f"exact w={w}", (sc.window_argmin(h, L, w, off),),
              (sc.window_argmin_ref(h, L, w, off),))
        out["gmem_ms"] = _ms(lambda: sc._window_emit_gmem(h, flags, L, w, off, cap), 3)
        out["exact_all_ms"] = _ms(lambda: sc.window_argmin(h, L, w, off), 3)
        if sc.emit_tile(w):
            out["tile_ms"] = _ms(lambda: sc.window_emit(h, flags, L, w, off, cap), 3)
        if over.numel():
            _same(f"exact over the overflowed chunks, w={w}",
                  (sc.window_argmin(h, L, w, off, over),),
                  (sc.window_argmin_ref(h, L, w, off, over),))
            out["overflowed"] = int(over.numel())
            out["exact_over_ms"] = _ms(lambda: sc.window_argmin(h, L, w, off, over), 20)
        print(json.dumps(out), flush=True)


def sweep() -> None:
    codes = _codes(1 << 27, 64)
    for w in (1000, 5000, 10000):
        h, val, C, L, off = _cell(codes, w)
        flags = sc.window_flags(val, L, w, off)
        cap = sc._slot_cap(L, w)
        want_e = sc.window_emit_ref(h, flags, L, w, off, cap)
        want_a = sc.window_argmin_ref(h, L, w, off)
        for tile in (32, 16, 8, 4, 2, 1):
            for most in (128, 256, 512):
                launch = (tile, sc.split_threads(w, tile, most))
                passes = -(-w // (launch[1] // tile * sc.SPLIT_ROWS))
                if passes > 1 and 24 * passes * tile > sc._SPLIT_SUB_MAX:
                    continue  # the passes' minima would not fit in shared memory
                sc.gmem_launch = sc.argmin_launch = lambda *a, _l=launch: _l
                out = {"w": w, "chunks_a_block": tile, "threads": launch[1]}
                if tile <= 8:
                    _same("device-memory route", sc._window_emit_gmem(h, flags, L, w, off, cap),
                          want_e)
                    out["gmem_ms"] = _ms(lambda: sc._window_emit_gmem(h, flags, L, w, off, cap), 3)
                if tile != 2:
                    _same("exact", (sc.window_argmin(h, L, w, off),), (want_a,))
                    out["exact_all_ms"] = _ms(lambda: sc.window_argmin(h, L, w, off), 3)
                print(json.dumps(out), flush=True)
        del want_e, want_a


def _queued_ms(fn, reps: int = 20) -> float:
    """Device time of launches queued behind a spinning kernel, so that a
    host slower than the card does not space them out."""
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


def _drafts() -> list[np.ndarray]:
    """20 seeded scaffolds of 5 Mbp with an N run of 50-500 bp every 2-8 kbp."""
    rng = np.random.default_rng(61)
    recs = []
    for _ in range(20):
        c = rng.integers(0, 4, size=5_000_000, dtype=np.uint8)
        at = np.cumsum(rng.integers(2000, 8001, size=c.shape[0] // 2000 + 1))
        at = at[at < c.shape[0] - 500]
        for a, ln in zip(at.tolist(), rng.integers(50, 501, size=at.shape[0]).tolist()):
            c[a : a + ln] = 4
        recs.append(c)
    return recs


def stream(quick: bool) -> None:
    from ntjoin_tpu_torch.ops import sketch_general as sg
    from ntjoin_tpu_torch.ops import sketch_records as sr

    recs = _drafts()
    old = hasattr(sg, "_positions")  # a tree that makes a position for every rank
    for w in (1000,) if quick else (1000, 5000):
        host, total, offsets = sr.pack_batch(recs, K, w)
        flat, starts = host.cuda(), torch.from_numpy(offsets).cuda()
        h, val, L = sg.hash_batch(flat, total, K, w)
        hs, vs, Ls, extra = sg.stream_batch(flat, total, starts, K, w)
        p_hs, p_vs, p_Ls, p_extra = sg.stream_batch(flat, total, starts, K, w, plain=True)
        ranks, _ = sc.window_stream(hs, vs, Ls, w, 0)
        if old:
            _same(f"compaction w={w}", (hs, vs, extra), (p_hs, p_vs, p_extra))
        else:
            _same(f"compaction w={w}", (hs, vs, extra.firsts, sg.decode_ranks(extra, ranks)),
                  (p_hs, p_vs, p_extra.firsts, sg.decode_ranks(p_extra, ranks, plain=True)))
        del p_hs, p_vs, p_extra
        firsts, S = sg.first_ranks(sg._count(val, L, total, starts, K))
        hflat, vflat = sg._gather(h, val, L, total, starts, K, firsts, S)
        out = {"w": w, "bases": total, "C": val.shape[1], "L": L, "S": S, "Cs": hs.shape[1],
               "Ls": Ls, "emitted": int(ranks.numel()), "tree": "positions" if old else "tiles",
               "count_ms": _queued_ms(lambda: sg._count(val, L, total, starts, K)),
               "count_scan_sync_ms": _ms(
                   lambda: sg.first_ranks(sg._count(val, L, total, starts, K))),
               "gather_ms": _ms(lambda: sg._gather(h, val, L, total, starts, K, firsts, S)),
               "chunks_ms": _ms(lambda: sg._chunks(hflat, vflat, w)),
               "call_ms": _ms(lambda: sg.sketch_general_torch(flat, total, starts, K, w), 3)}
        if old:
            out["positions_ms"] = _ms(
                lambda: sg._positions(val, L, total, starts, K, firsts, S))
        else:
            index = sg.StreamIndex(val, firsts, L, total, K, starts)
            counts = sg._count(val, L, total, starts, K)
            out["scan_ms"] = _queued_ms(lambda: counts.cumsum(0))
            out["decode_ms"] = _queued_ms(lambda: sg._decode(index, ranks))
        print(json.dumps(out), flush=True)
        del h, val, hs, vs, extra, hflat, vflat, flat, starts, host


def mk_runs(seed: int = 71) -> list[list[int]]:
    """The Mann-Kendall cell (``chip_smoke.py`` phase B): 4,096 runs of
    2-2,048 positions and two of 100,000, each sorted with a fifth of its
    values moved, half of them reversed."""
    rng = np.random.default_rng(seed)
    lengths = [int(n) for n in rng.integers(2, 2049, size=4096)] + [100_000, 100_000]
    runs = []
    for n in lengths:
        x = np.sort(rng.integers(0, 50_000_000, size=n))
        swap = rng.random(n) < 0.2
        x[swap] = rng.integers(0, 50_000_000, size=int(swap.sum()))
        runs.append((x if rng.random() < 0.5 else x[::-1]).tolist())
    return runs


def device_spans(prof, cats: tuple[str, ...] = ("kernel",)) -> list[tuple]:
    """(start, end, grid, name, category) of each device event of these
    categories in a torch.profiler run (chrome-trace microseconds), sorted
    by start; ``gpu_memcpy`` and ``gpu_memset`` are the copies' and fills'."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("grid", [0, 1, 1]),
                   e["name"], e["cat"]) for e in events if e.get("cat") in cats)


def busy_us(spans: list[tuple]) -> float:
    """The length of the union of the intervals [start, end) of ``spans``,
    sorted by start: the time in which at least one of them ran."""
    busy, end = 0.0, spans[0][0] if spans else 0.0
    for lo, hi, *_ in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def _trace(fn, queued: bool) -> dict:
    """One call of fn under torch.profiler (behind a spinning kernel where
    ``queued``): its kernels' count (the op's own fills included), their
    device time, the span from the
    first one's start to the last one's end, the share of that span in which
    no kernel ran, and the SMs that the launches' grids could fill (at most
    132, weighted by each launch's time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if queued:
            torch.cuda._sleep(20_000_000)
        fn()
        torch.cuda.synchronize()
    spans = [s for s in device_spans(prof) if "spin_kernel" not in s[3]]
    if not spans:
        return {"kernels": 0, "device_ms": "not measured (no kernel in the trace)"}
    busy = busy_us(spans)
    device = sum(hi - lo for lo, hi, *_ in spans)
    sms = sum((hi - lo) * min(132, g[0] * g[1] * g[2]) for lo, hi, g, *_ in spans) / device
    span = spans[-1][1] - spans[0][0]
    return {"kernels": len(spans), "device_ms": device / 1e3, "span_ms": span / 1e3,
            "idle_share": 1 - busy / span, "sms": sms}


def mk() -> None:
    """The S kernel (``mannkendall._mk_s_kernel``) queued behind a spinning
    kernel, on the Mann-Kendall cell's 64 batches and on each run of
    100,000 alone, S held bit-equal to the plain version first; and a trace
    of the 64 batches, queued and back to back."""
    from ntjoin_tpu_torch.core import orientation
    from ntjoin_tpu_torch.ops import mannkendall as mk_op

    def on_card(runs):
        return [(torch.from_numpy(pos).cuda(), torch.from_numpy(n).cuda())
                for _, pos, n in orientation._mk_batches(runs)]

    def kernel(batches):
        return [mk_op._mk_s_kernel(p, n) for p, n in batches]

    runs = mk_runs()
    for what, batches in (("phase B", on_card(runs)), ("100,000 a", on_card(runs[-2:-1])),
                          ("100,000 b", on_card(runs[-1:]))):
        _same(f"S kernel ({what})", kernel(batches),
              [mk_op.mk_s_batch_ref(p, n) for p, n in batches])
        out = {"cell": what, "batches": len(batches),
               "queued_ms": _queued_ms(lambda b=batches: kernel(b), 2)}
        if what == "phase B":
            out["trace_queued"] = _trace(lambda b=batches: kernel(b), True)
            out["trace"] = _trace(lambda b=batches: kernel(b), False)
        print(json.dumps(out), flush=True)


# What ``variant`` rewrites, by file under the package: (find, replace).
_PARTS = {
    "noscan": ("csrc/vanherk.cuh", [
        ("  KeyArg x = mine;\n",
         "  if (total) *total = none;\n  return none;\n  KeyArg x = mine;\n"),
        ("  KeyArg x = mine, y = mine;\n",
         "  pre = suf = none;\n  return;\n  KeyArg x = mine, y = mine;\n"),
    ]),
    "noload": ("csrc/vanherk.cuh", [
        ("? hc[e * h_pitch] : ~0ull;", "? (uint64_t)(e + hcol) * 0x9E3779B97F4A7C15ull : ~0ull;"),
    ]),
    "noballot": ("csrc/flags.cu", [
        ("          const uint32_t m = __ballot_sync(~0u, z & (1u << (8 * k)));\n"
         "          if (lane == (col & 31)) mine[col >> 5] = m;\n",
         "          if (lane == (col & 31)) mine[col >> 5] = z;\n"),
    ]),
    "nostore": ("csrc/window.cu", [
        ("      if (chunk >= 0 && t0 + r < w && j < L) am",
         "      if (arg[r] != 0xFFFFFFF0u) continue;\n"
         "      if (chunk >= 0 && t0 + r < w && j < L) am"),
    ]),
}


def variant(dst: str, what: list[str]) -> None:
    pkg = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(dst, "ntjoin_tpu_torch")
    shutil.copytree(pkg, out, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    edits: dict[str, list[tuple[str, str]]] = {}
    for word in what:
        if word in _PARTS:
            path, pairs = _PARTS[word]
            edits.setdefault(path, []).extend(pairs)
        elif word.startswith("rows="):
            n = int(word[5:])
            edits.setdefault("csrc/vanherk.cuh", []).append(
                (f"constexpr int kRows = {sc.SPLIT_ROWS};", f"constexpr int kRows = {n};"))
            edits.setdefault("ops/sketch_cuda.py", []).append(
                (f"\nSPLIT_ROWS = {sc.SPLIT_ROWS}\n", f"\nSPLIT_ROWS = {n}\n"))
        elif word.startswith(("flagrows=", "flagthreads=")):
            name, n = word.split("=")
            cu, py = {"flagrows": (f"kWalkRows = {sc.FLAG_ROWS},", "FLAG_ROWS"),
                      "flagthreads": (f"kWalkThreads = {sc.FLAG_THREADS};", "FLAG_THREADS")}[name]
            edits.setdefault("csrc/flags.cu", []).append(
                (cu, cu.split("=")[0] + f"= {int(n)}" + cu[-1]))
            edits.setdefault("ops/sketch_cuda.py", []).append(
                (f"\n{py} = {getattr(sc, py)}\n", f"\n{py} = {int(n)}\n"))
        elif word.startswith("threads="):
            n = int(word[8:])
            edits.setdefault("csrc/vanherk.cuh", []).append(
                (f"constexpr int kMaxThreads = {sc.SPLIT_MAX_THREADS};",
                 f"constexpr int kMaxThreads = {n};"))
            edits.setdefault("ops/sketch_cuda.py", []).append(
                (f"\nSPLIT_MAX_THREADS = {sc.SPLIT_MAX_THREADS}\n", f"\nSPLIT_MAX_THREADS = {n}\n"))
        else:
            raise SystemExit(f"split_bench: unknown part {word!r}")
    for path, pairs in edits.items():
        with open(os.path.join(out, path), encoding="utf-8") as fh:
            text = fh.read()
        for find, replace in pairs:
            if find not in text:
                raise SystemExit(f"split_bench: {path} no longer holds {find!r}")
            text = text.replace(find, replace)
        with open(os.path.join(out, path), "w", encoding="utf-8") as fh:
            fh.write(text)
    print(f"{out}: {' '.join(what) or 'unchanged'}")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("times", "sweep", "variant", "stream", "mk"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "variant":
        if len(argv) < 2:
            print("split_bench: variant needs a directory", file=sys.stderr)
            return 2
        variant(argv[1], argv[2:])
        return 0
    if not torch.cuda.is_available():
        print("split_bench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0), "build_s": sc.build()[0]}),
          flush=True)
    global _CHECKED
    if argv[0] == "times":
        _CHECKED = "--unchecked" not in argv[1:]
        times("--quick" in argv[1:], "--flags" in argv[1:])
    elif argv[0] == "stream":
        _CHECKED = "--unchecked" not in argv[1:]
        stream("--quick" in argv[1:])
    elif argv[0] == "mk":
        mk()
    else:
        sweep()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
