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
            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
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
