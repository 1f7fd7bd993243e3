"""Structured stage timing — the framework's tracing/observability hook.

Successor of the reference's per-Make-target GNU ``time -v`` logging
(``ntJoin:98-107``): wall-clock and peak-RSS per named stage, an in-process
summary, and optional per-stage ``<prefix>.<stage>.time`` files, which also
hold the resident set (``VmRSS``) at the stage's start and at its end
(``rss_start_kb``, ``rss_end_kb``) and the highest one read while it was
open (``rss_max_kb``, every ``SAMPLE_S`` seconds): the peak says how high
the process has been so far, the two ends what the stage left behind, and
``rss_max_kb - rss_start_kb`` what the stage itself took at most.
"""
from __future__ import annotations

import contextlib
import resource
import threading
import time

# Seconds between two reads of the resident set while a stage is open
# (``RssMax``; ``perf_scale``'s sampler reads at the same period).
SAMPLE_S = 0.05


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
    one it reads at least that process's peak at the spawn.  Where both
    exist the lower one is taken: the kernel may read them from its
    per-CPU page counters at different precision, and the two then differ
    by a few hundred kB either way."""
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    hwm = status_kb("VmHWM")
    return maxrss if hwm is None else min(hwm, maxrss)


# Names of the stages open now, innermost last: a sampler in another thread
# reads ``OPEN[-1]`` to tell which stage a sample falls in.
OPEN: list[str] = []


class RssMax:
    """A thread that reads ``VmRSS`` every ``SAMPLE_S`` seconds from its
    start until ``stop``: the highest of its reads and of the first and
    last reads given, in kB (None where the system has no ``VmRSS``)."""

    def __init__(self, first_kb: int | None):
        self.kb = first_kb
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _take(self, kb: int | None) -> None:
        if kb is not None and kb > (self.kb or 0):
            self.kb = kb

    def _run(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            self._take(status_kb("VmRSS"))

    def stop(self, last_kb: int | None) -> int | None:
        self._stop.set()
        self._thread.join()
        self._take(last_kb)
        return self.kb


class StageTimers:
    def __init__(self, enabled: bool = False, prefix: str = "out"):
        self.enabled = enabled
        self.prefix = prefix
        self.stages: list[tuple[str, float, int]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        rss_start = status_kb("VmRSS")
        rss_max = RssMax(rss_start) if self.enabled else None
        t0 = time.monotonic()
        OPEN.append(name)
        try:
            yield
        finally:
            OPEN.pop()
            wall = time.monotonic() - t0
            rss_kb = peak_rss_kb()
            self.stages.append((name, wall, rss_kb))
            if self.enabled:
                rss_end = status_kb("VmRSS")
                most = rss_max.stop(rss_end)
                safe = name.replace("/", "_").replace(":", ".")
                with open(f"{self.prefix}.{safe}.time", "w", encoding="utf-8") as fh:
                    fh.write(f"stage\t{name}\nwall_s\t{wall:.4f}\npeak_rss_kb\t{rss_kb}\n"
                             f"rss_start_kb\t{rss_start}\nrss_end_kb\t{rss_end}\n"
                             f"rss_max_kb\t{most}\n")

    def report(self) -> None:
        if not self.enabled or not self.stages:
            return
        print("stage\twall_s\tpeak_rss_kb")
        for name, wall, rss in self.stages:
            print(f"{name}\t{wall:.4f}\t{rss}")
