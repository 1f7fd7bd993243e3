"""A traced job's device time, read from its ``torch.profiler`` chrome trace.

``device_spans`` and ``busy_us`` are copies of
``ntjoin_tpu_torch/split_bench.py``'s.  A device operation belongs to the
stage (``stage:<name>`` mark) that was open on the host when it was
launched; an idle gap, to the stage open at its middle, or to "outside
stages".
"""
from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside stages"


def device_spans(events: list[dict], cats: tuple[str, ...] = DEVICE_CATS) -> list[tuple]:
    """(start, end, name, category, correlation) of each device event of
    these categories (microseconds), sorted by start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"],
                   e.get("args", {}).get("correlation"))
                  for e in events if e.get("cat") in cats)


def busy_us(spans: list[tuple]) -> float:
    """The length of the union of the intervals [start, end) of ``spans``,
    sorted by start: the time in which at least one of them ran."""
    busy, end = 0.0, spans[0][0] if spans else 0.0
    for lo, hi, *_ in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


class _Stages:
    """The host's stage marks, to ask which was open at a time."""

    def __init__(self, events: list[dict]):
        marks = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("stage:"):])
                       for e in events
                       if e.get("cat") == "user_annotation" and e["name"].startswith("stage:"))
        self.starts = [m[0] for m in marks]
        self.marks = marks

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:  # the innermost mark open at t: the latest to start
            lo, hi, name = self.marks[i]
            if lo <= t < hi:
                return name
            i -= 1
        return OUTSIDE


def read(path: str, job_mark: str) -> dict:
    """From a job's trace: ``span_s`` (the ``job_mark`` annotation), ``busy_s``
    (device events' union within it), ``ops`` ({name: device seconds}),
    ``ops_by_stage`` ({stage: {category: seconds}}; kernels by the stage of
    their launch) and ``gaps`` ({stage: idle seconds}), or {} where the trace
    holds no device event."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    job = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == job_mark]
    spans = device_spans(events)
    if not job or not spans:
        return {}
    lo_job, hi_job = job[0]["ts"], job[0]["ts"] + job[0]["dur"]
    spans = [s for s in spans if s[1] > lo_job and s[0] < hi_job]
    if not spans:
        return {}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    stages = _Stages(events)
    ops: dict[str, float] = {}
    by_stage: dict[str, dict[str, float]] = {}
    for lo, hi, name, cat, corr in spans:
        sec = (hi - lo) / 1e6
        ops[name] = ops.get(name, 0.0) + sec
        where = stages.at(launch.get(corr, lo))
        cell = by_stage.setdefault(where, {})
        cell[cat] = cell.get(cat, 0.0) + sec
    gaps: dict[str, float] = {}
    end = lo_job
    for lo, hi, *_ in spans + [(hi_job, hi_job)]:
        if lo > end:
            where = stages.at((lo + end) / 2)
            gaps[where] = gaps.get(where, 0.0) + (min(lo, hi_job) - end) / 1e6
        end = max(end, hi)
    return {"span_s": (hi_job - lo_job) / 1e6, "busy_s": busy_us(spans) / 1e6,
            "ops": ops, "ops_by_stage": by_stage, "gaps": gaps}
