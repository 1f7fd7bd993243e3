"""One ``assemble`` job: ``ntjoin_tpu_torch.cli.main`` in a fresh forked
process, in a fresh directory that links to the inputs.

The harness has imported the port and torch but made no CUDA context, so a
job pays its own context and kernel load, as a user's process does, and not
the interpreter's start or ``import torch``.  A traced job runs with
``time=True`` under ``torch.profiler``; each stage that the port opens
(``utils/timers.OPEN``) is marked in the trace as ``stage:<name>``.
"""
from __future__ import annotations

import glob
import json
import os
import time

from njbench import proc

PROFILE_MARK = "njbench.job"


class _StageMarks(list):
    """``timers.OPEN`` in a traced job: the same list, and each stage pushed
    opens a ``record_function`` that its pop closes."""

    def __init__(self, record_function):
        super().__init__()
        self._rf = record_function
        self._open = []

    def append(self, name):
        super().append(name)
        mark = self._rf("stage:" + name)
        mark.__enter__()
        self._open.append(mark)

    def pop(self, *args):
        self._open.pop().__exit__(None, None, None)
        return super().pop(*args)


def call(words: list[str]) -> int:
    """The timed path: the port's CLI entry, as a user's process runs it."""
    from ntjoin_tpu_torch import cli

    return cli.main(words)


def _body(words: list[str], traced: bool) -> dict:
    import resource

    import torch
    from ntjoin_tpu_torch.ops import sketch_records
    from ntjoin_tpu_torch.utils import timers

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        timers.OPEN = _StageMarks(record_function)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        mark = record_function(PROFILE_MARK)
        mark.__enter__()
    start_kb = proc.status_kb("self")
    t0 = time.perf_counter()
    rc = call(words)
    # the job's own high-water mark of resident memory, from its fork to the
    # return of its call: read before the harness's own queries of the card
    # below, which raise it on a CUDA machine (PERF.md section 6)
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    on_card = torch.cuda.is_initialized()
    if on_card:
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    out = {"rc": rc, "main_s": main_s, "start_rss_kb": start_kb, "peak_rss_kb": peak_kb,
           "device_peak_bytes": torch.cuda.max_memory_reserved() if on_card else 0,
           "device": torch.cuda.get_device_name() if on_card else "cpu",
           "cards": torch.cuda.device_count() if on_card else 0,
           "sketch_stages": dict(sketch_records.STAGES)}
    if prof is not None:
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace("trace.json")
    out["end_maxrss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return out


def run(job_dir: str, inputs: list[str], words: list[str], traced: bool) -> dict:
    """One job in ``job_dir`` (made here, with a link to each input): the
    child's answer (``peak_rss_kb``, its own high-water mark when its call
    returned, among it) merged with its wall, the forbidden modules it had
    loaded and its ``ru_maxrss`` from ``os.wait4`` (``maxrss_kb``)."""
    os.makedirs(job_dir)
    for path in inputs:
        os.symlink(path, os.path.join(job_dir, os.path.basename(path)))

    def child():
        os.chdir(job_dir)
        return _body(words, traced)

    got = proc.Child(child, log=os.path.join(job_dir, "job.log")).wait()
    answer = got.pop("answer")
    rc = answer["rc"] if answer else got["rc"] or 1
    got.update(answer or {})
    got["rc"] = rc
    return got


def stage_records(job_dir: str) -> dict:
    """Each ``time=True`` stage file of the job: {stage: {wall_s,
    rss_start_kb, rss_end_kb, rss_max_kb, peak_rss_kb}} (None where the
    system gave no reading)."""
    out = {}
    for path in glob.glob(os.path.join(job_dir, "*.time")):
        with open(path, encoding="utf-8") as fh:
            kv = dict(line.split("\t", 1) for line in fh.read().splitlines())
        name = kv.pop("stage")
        out[name] = {key: None if val == "None" else float(val) for key, val in kv.items()}
    return out


def log_counts(job_dir: str) -> dict:
    """The ``<name>\\t<json>`` count lines the CLI prints with ``time=True``
    (``sketch_counts``, ``index_counts``, ``mk_counts``)."""
    out = {}
    try:
        with open(os.path.join(job_dir, "job.log"), encoding="utf-8", errors="replace") as fh:
            for line in fh:
                name, _, rest = line.rstrip("\n").partition("\t")
                if name.endswith("_counts") and rest.startswith("{"):
                    out[name] = json.loads(rest)
    except OSError:
        pass
    return out
