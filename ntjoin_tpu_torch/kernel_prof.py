"""Per-stage device timing of the minimizer sketch on one CUDA GPU.  Port of
``scripts/kernel_prof.py``.

    python -m ntjoin_tpu_torch.kernel_prof [stage ...]

Stages (default: all, in this order):

* ``link``: pinned int8 codes to the device, from torch's pinned memory
  and from the sketch's own batch buffer (``sketch_records.host_buffer``,
  pinned by ``cudaHostRegister``), with what making each took; a
  results-sized copy back (4 x 300,000 int32) and a one-element round
  trip.
* ``fused``: ``sketch_fused_torch`` on KP_SIZE bases, k=32, w=1000 (KP_W):
  three trials of CUDA events (``ms_trials``, sorted; ``ms`` the least).
* ``events``: the copy kernel, the sketch through the hash, through the
  window/emission kernel and whole, and the exact window kernel over every
  chunk (the counterpart of the original's ``slope`` stage).
* ``membw``: the copy kernel, its plain version, an elementwise xor and a
  sum over the same array, in GB/s of the bytes each moves.
* ``ablate``: in-context marginals of hash, flags, window/emission and
  compaction (the flag op timed by itself, the others by difference), and
  the exact path over the overflowed chunks when it ran.
* ``decomp``: the kernels one at a time, window plus compaction, and a
  repeat-dense input (poly-C blocks every KP_SIZE/64) with the exact path
  over the chunks it overflows.
* ``multi`` / ``general``: ``sketch_records_torch`` over 2 Mbp records,
  ``general`` with 100 N runs of 500 bp; walls and the ``STAGES`` split.

Each stage prints one JSON line ``{stage: {...}}`` when it ends; a stage
that the budget (KP_BUDGET_S seconds, default 3000) leaves no time for
prints ``{stage: {"skipped": ...}}``.  The run ends with ``{"counts": ...}``,
the counters of the whole run (``utils/timers.py``: kernel launches under
``launch:``), and ``{"done": true}``.  Times in
``*_ms`` are CUDA events over back-to-back calls after a warm-up; ``per_call``
and ``wall`` times are host clocks around synchronised calls.  KP_SIZE sets
the bases (default 2^27), KP_W the window of every stage but the copy
array's rows (default 1000).  Without a CUDA device the run prints no stage
and exits 2.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ntjoin_tpu_torch.constants import CODE_INVALID
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops import sketch_records as sr
from ntjoin_tpu_torch.ops.membw import copy_words, copy_words_ref
from ntjoin_tpu_torch.utils import timers

STAGES = ("link", "fused", "events", "membw", "ablate", "decomp", "multi", "general")
K, W = 32, 1000
DEVICE = "cuda"
# least seconds left for a stage to start
_NEEDS = {"link": 30, "fused": 60, "events": 60, "membw": 30, "ablate": 60, "decomp": 90,
          "multi": 120, "general": 120}


def emit(name: str, obj) -> None:
    print(json.dumps({name: obj}), flush=True)


def events_ms(fn, reps: int = 5) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` back-to-back
    calls, after one warm-up call."""
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


def per_call_ms(fn, reps: int = 5) -> list[float]:
    """Sorted host-clock milliseconds of synchronised single calls."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def copy_rows(size: int) -> int:
    """Rows of the original's copy array: the TPU code layout of ``size``
    bases, 2048 chunks of ceil(nk / 2048) k-mers plus the w + k - 2 halo,
    rounded up to 128 rows (66,688 rows, 546 MB of uint32, at 2^27)."""
    rows = -(-(size - K + 1) // 2048) + W + K - 2
    return -(-rows // 128) * 128


def _stream(codes: np.ndarray, w: int = W) -> tuple[torch.Tensor, int, int]:
    """Codes padded with invalid bases to the layout's length, on the GPU;
    and the layout (C, L)."""
    C, L = sc.layout(codes.shape[0], K, w)
    buf = np.full(C * L + w + K - 2, CODE_INVALID, dtype=np.int8)
    buf[: codes.shape[0]] = codes
    return torch.from_numpy(buf).to(DEVICE), C, L


def stage_link(buf: torch.Tensor) -> dict:
    t0 = time.perf_counter()
    host = buf.cpu().pin_memory()
    pin_ms = (time.perf_counter() - t0) * 1e3
    dev = torch.empty_like(host, device=DEVICE)
    up = events_ms(lambda: dev.copy_(host, non_blocking=True))
    # the sketch's batch buffer: page-aligned memory pinned by cudaHostRegister
    t0 = time.perf_counter()
    reg = sr.host_buffer(host.numel(), True)
    register_ms = (time.perf_counter() - t0) * 1e3
    reg.copy_(host)
    up_reg = events_ms(lambda: dev.copy_(reg, non_blocking=True))
    sr.unpin(reg)
    res = torch.zeros(4 * 300_000, dtype=torch.int32, device=DEVICE)
    down = per_call_ms(res.cpu)
    one = torch.ones(1, dtype=torch.int32, device=DEVICE)
    rtt = per_call_ms(one.item)
    return {
        "upload_bytes": host.numel(), "upload_ms": up,
        "upload_gb_s": host.numel() / up / 1e6, "pin_ms": pin_ms,
        "upload_registered_ms": up_reg, "upload_registered_gb_s": host.numel() / up_reg / 1e6,
        "register_ms": register_ms,
        "download_bytes": res.numel() * 4, "download_ms": down,
        "download_gb_s": res.numel() * 4 / down[0] / 1e6,
        "rtt_ms": rtt,
    }


def marginals(t_hash: float, t_flags: float, t_win: float, t_full: float) -> dict:
    """The ``ablate`` stage's split of the fused call: the times of the call
    cut after the hash, after the window/emission op and whole, and of the
    flag op by itself, as each part's marginal."""
    return {"through_hash_ms": t_hash, "through_window_ms": t_win, "full_ms": t_full,
            "hash_ms": t_hash, "flags_ms": t_flags, "window_ms": t_win - t_hash - t_flags,
            "compaction_ms": t_full - t_win}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kernel_prof: no CUDA device (torch.cuda.is_available() is False); the "
              "profiler times the GPU kernels only", file=sys.stderr)
        return 2
    stages = argv or list(STAGES)
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        print(f"kernel_prof: unknown stage(s) {unknown}; stages: {' '.join(STAGES)}",
              file=sys.stderr)
        return 2
    deadline = time.monotonic() + float(os.environ.get("KP_BUDGET_S", 3000))
    size = int(os.environ.get("KP_SIZE", 1 << 27))
    w = int(os.environ.get("KP_W", W))
    with timers.recording(True):
        return _profile(stages, deadline, size, w)


def _profile(stages: list[str], deadline: float, size: int, w: int) -> int:
    """Each asked stage in turn, inside ``main``'s recording; then the
    run's counters."""
    emit("device", {"name": torch.cuda.get_device_name(0), "size": size, "k": K, "w": w})
    codes = np.random.default_rng(42).integers(0, 4, size=size, dtype=np.int8)
    flat, C, L = _stream(codes, w)
    rows, off, cap = L + w + K - 2, K - 1, sc._slot_cap(L, w)

    def fused(stop_after=None):
        return sc.sketch_fused_torch(flat, size, K, w, stop_after=stop_after)

    def words() -> torch.Tensor:
        n = copy_rows(size) * 2048
        return torch.arange(n, dtype=torch.int32, device=DEVICE).view(-1, 2048)

    for stage in (s for s in STAGES if s in stages):
        if deadline - time.monotonic() < _NEEDS[stage]:
            emit(stage, {"skipped": "KP_BUDGET_S"})
            continue
        if stage == "link":
            emit(stage, stage_link(flat))
        elif stage == "fused":
            n_emit = int(fused()[0].shape[0])
            trials = sorted(events_ms(fused) for _ in range(3))
            emit(stage, {"emissions": n_emit, "per_call_ms": per_call_ms(fused),
                         "ms": trials[0], "ms_trials": trials,
                         "gbases_s": size / trials[0] / 1e6, "chunks": C, "chunk_len": L})
        elif stage == "events":
            big = words()
            nbytes = big.numel() * 4
            copy_ms = events_ms(lambda: copy_words(big), 10)
            del big
            h, _ = fused("hash")
            scan_ms = events_ms(lambda: sc.window_argmin(h, L, w, off))
            del h
            full_ms = events_ms(fused)
            emit(stage, {
                "copy_ms": copy_ms, "copy_gb_s": 2 * nbytes / copy_ms / 1e6, "copy_bytes": nbytes,
                "through_hash_ms": events_ms(lambda: fused("hash")),
                "through_window_ms": events_ms(lambda: fused("window")),
                "fused_ms": full_ms, "fused_gbases_s": size / full_ms / 1e6,
                "scanonly_window_ms": scan_ms,
            })
        elif stage == "membw":
            big = words()
            nbytes = big.numel() * 4
            out = {"bytes": nbytes}
            for name, fn, traffic in (
                ("copy_kernel", lambda: copy_words(big), 2 * nbytes),
                ("copy_plain", lambda: copy_words_ref(big), 2 * nbytes),
                ("torch_xor", lambda: big ^ 1, 2 * nbytes),
                ("torch_sum", lambda: big.sum(), nbytes),
            ):
                ms = events_ms(fn, 10)
                out[name] = {"ms": ms, "gb_s": traffic / ms / 1e6}
            del big
            emit(stage, out)
        elif stage == "ablate":
            t_hash = events_ms(lambda: fused("hash"))
            t_win = events_ms(lambda: fused("window"))
            runs0 = timers.COUNTERS.get("sketch_route:exact_runs", 0)
            t_full = events_ms(fused)
            val = fused("hash")[1]
            t_flags = events_ms(lambda: sc.window_flags(val, L, w, off))
            del val
            out = {**marginals(t_hash, t_flags, t_win, t_full),
                   "exact_ran": timers.COUNTERS.get("sketch_route:exact_runs", 0) > runs0}
            if out["exact_ran"]:
                h, _ = fused("hash")
                over = torch.nonzero(fused("window")[2] > cap).flatten()
                out["exact_chunks"] = int(over.numel())
                out["exact_ms"] = events_ms(lambda: sc.window_argmin(h, L, w, off, over))
                del h
            emit(stage, out)
        elif stage == "decomp":
            out = {}
            h, val = sc.hash_chunked(flat, L, C, rows, K)
            out["hash_ms"] = events_ms(lambda: sc.hash_chunked(flat, L, C, rows, K))
            flags = sc.window_flags(val, L, w, off)
            out["flags_ms"] = events_ms(lambda: sc.window_flags(val, L, w, off))
            del val
            out["window_emit_ms"] = events_ms(lambda: sc.window_emit(h, flags, L, w, off, cap))

            def window_compact():
                spos, shsh, count = sc.window_emit(h, flags, L, w, off, cap)
                count = count.masked_fill(count > cap, 0)
                return sc._compact_lists(spos, shsh, count, int(count.sum()))

            out["window_compact_ms"] = events_ms(window_compact)
            del h, flags
            rep = codes.copy()
            for s0 in range(0, size, size // 64):
                rep[s0 : s0 + 4000] = 1  # poly-C blocks
            flat_r, _, _ = _stream(rep, w)
            h, val = sc.hash_chunked(flat_r, L, C, rows, K)
            flags = sc.window_flags(val, L, w, off)
            del val
            out["repeatdense_window_emit_ms"] = events_ms(
                lambda: sc.window_emit(h, flags, L, w, off, cap))
            over = torch.nonzero(sc.window_emit(h, flags, L, w, off, cap)[2] > cap).flatten()
            out["repeatdense_exact_chunks"] = int(over.numel())
            out["repeatdense_exact_ms"] = events_ms(
                lambda: sc.window_argmin(h, L, w, off, over))
            del h, flags, flat_r
            emit(stage, out)
        else:  # multi, general
            recs_codes = codes
            if stage == "general":
                recs_codes = codes.copy()
                rng = np.random.default_rng(7)
                for s0 in rng.integers(0, size - 600, 100):
                    recs_codes[s0 : s0 + 500] = CODE_INVALID
            recs = [recs_codes[i : i + 2_000_000] for i in range(0, size, 2_000_000)]
            sr.sketch_records_torch(recs, K, w, DEVICE)  # warm
            walls, splits = [], []
            for _ in range(3):
                sr.STAGES.clear()
                t0 = time.monotonic()
                sr.sketch_records_torch(recs, K, w, DEVICE)
                walls.append(time.monotonic() - t0)
                splits.append(dict(sr.STAGES))
            best = int(np.argmin(walls))
            emit(stage, {"records": len(recs), "wall_s": sorted(walls),
                         "gbases_s": size / walls[best] / 1e9, "stages_s": splits[best]})
        torch.cuda.empty_cache()
    emit("counts", timers.COUNTERS)
    emit("done", True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
