"""Structured stage timing — the framework's tracing/observability hook.

Successor of the reference's per-Make-target GNU ``time -v`` logging
(``ntJoin:98-107``): wall-clock and peak-RSS per named stage, an in-process
summary, and optional per-stage ``<prefix>.<stage>.time`` files.  Device-side
profiling is layered on via ``jax.profiler`` in the bench harness.
"""
from __future__ import annotations

import contextlib
import resource
import time


def status_kb(field: str) -> int | None:
    """A ``kB`` field of ``/proc/self/status`` (``VmRSS``, ``VmHWM``), or
    None where the system has no such line."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def peak_rss_kb() -> int:
    """This process's peak resident set in kB: ``VmHWM`` where the system
    gives it, else ``ru_maxrss``.  On Linux ``ru_maxrss`` keeps the
    high-water mark across ``execve``, so in a process spawned by a larger
    one it reads at least that process's peak at the spawn."""
    hwm = status_kb("VmHWM")
    return hwm if hwm is not None else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


class StageTimers:
    def __init__(self, enabled: bool = False, prefix: str = "out"):
        self.enabled = enabled
        self.prefix = prefix
        self.stages: list[tuple[str, float, int]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            wall = time.monotonic() - t0
            rss_kb = peak_rss_kb()
            self.stages.append((name, wall, rss_kb))
            if self.enabled:
                safe = name.replace("/", "_").replace(":", ".")
                with open(f"{self.prefix}.{safe}.time", "w", encoding="utf-8") as fh:
                    fh.write(f"stage\t{name}\nwall_s\t{wall:.4f}\npeak_rss_kb\t{rss_kb}\n")

    def report(self) -> None:
        if not self.enabled or not self.stages:
            return
        print("stage\twall_s\tpeak_rss_kb")
        for name, wall, rss in self.stages:
            print(f"{name}\t{wall:.4f}\t{rss}")
