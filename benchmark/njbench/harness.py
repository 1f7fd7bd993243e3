"""One run of a benchmark cell: set-up, the measured window of back-to-back
``assemble`` jobs, the check of every job against the plain reference, and
the metrics read from what the run recorded.

Set-up: this process imports torch and the port and never makes a CUDA
context; it narrows ``CUDA_VISIBLE_DEVICES`` to the cards the cell asks for,
so that the port's multi-card branch cannot take more; a child builds (or
finds built) the port's libraries and looks for the cards.  Another child
writes the cell's inputs from the seed (``gen.Inputs``); ``run.py`` starts
it before it imports torch, so that the two overlap.  Every child reports the forbidden modules
(``proc.FORBIDDEN``) it had loaded; they are gathered in ``forbidden``.  The window: jobs
run one after another, each in a fresh forked process and directory, until
``seconds`` have passed; every job started is finished and counted.  After
it: with ``trace``, a fresh interpreter times the port's process start; a
child runs the reference over the inputs and compares every job's artifacts
with it.
"""
from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

from njbench import check, gen, job, proc, trace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# bench.process_start's pattern: a fresh interpreter's import of the port's
# CLI and its first CUDA context, on its own host clock
_START = ("import time; t0 = time.perf_counter(); import ntjoin_tpu_torch.cli; import torch; "
          "t1 = time.perf_counter(); torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
          "t2 = time.perf_counter(); import sys; print(t1 - t0, t2 - t1); "
          "print(' '.join(m for m in sys.modules if m.split('.', 1)[0] in "
          + repr(proc.FORBIDDEN) + "))")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def pin_cards(chips: int) -> str:
    """Leave the first ``chips`` of the visible cards visible to every child
    forked from here on; returns the new ``CUDA_VISIBLE_DEVICES``."""
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [x.strip() for x in seen.split(",") if x.strip()] if seen is not None \
        else [str(i) for i in range(chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])
    return os.environ["CUDA_VISIBLE_DEVICES"]


def _devices(need_cuda: bool) -> dict:
    """Run in a child: build the port's libraries (or find them built) and
    read the cards (``count`` 0 where there is none)."""
    import torch

    from ntjoin_tpu_torch.io import native

    native.build()
    if not need_cuda:
        return {"count": 0, "kind": "cpu"}
    if not torch.cuda.is_available():
        return {"count": 0, "kind": None}
    from ntjoin_tpu_torch.ops import sketch_cuda

    build_s, _ = sketch_cuda.build()
    sketch_cuda._lib()  # loads it: a library that does not load fails here
    return {"count": torch.cuda.device_count(), "kind": torch.cuda.get_device_name(0),
            "build_s": build_s}


def _power_limit() -> str | None:
    """The card's name and power limit, from ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else None


def _process_start(forbidden: set) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _START], capture_output=True, text=True,
                         timeout=300, env=env)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        return {"error": res.stderr[-2000:]}
    times, _, loaded = res.stdout.partition("\n")
    forbidden.update(loaded.split())
    imports, context = (float(x) for x in times.split())
    return {"wall_s": wall, "import_s": imports, "cuda_init_s": context}


def _bytes(path: str) -> int:
    """Bytes of the files (not the links) under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files if not os.path.islink(os.path.join(d, f)))


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"njbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _words(config: dict, traffic: dict, inputs: dict, trace_on: bool, extra: list[str]) -> list[str]:
    v = {**config["words"], **traffic.get("words", {}),
         "target": inputs["target"], "references": " ".join(inputs["references"])}
    words = ["assemble"] + [f"{key}={val}" for key, val in v.items()]
    return words + (["time=True"] if trace_on else []) + extra


def run_cell(config: dict, traffic: dict, seed: int, seconds: float, trace_on: bool,
             t_start: float, chips: int = 1, need_cuda: bool = True,
             extra_words: list[str] | None = None, inputs: gen.Inputs | None = None) -> dict:
    """One run; the record the metric readers read.  ``inputs``: the
    writer already started for this cell and seed (closed here)."""
    if need_cuda:
        pin_cards(chips)
    inputs = inputs or gen.Inputs(config, traffic, seed)
    try:
        return _run(config, traffic, seed, seconds, trace_on, t_start, chips, need_cuda,
                    extra_words or [], inputs)
    finally:
        inputs.close()


def _run(config, traffic, seed, seconds, trace_on, t_start, chips, need_cuda, extra, pending):
    work, inputs_dir = pending.work, pending.dir
    forbidden = set()
    t_children = time.perf_counter()
    builder = proc.Child(lambda: _devices(need_cuda))
    writer = pending.child.wait()
    got = builder.wait()
    for child in (writer, got):
        forbidden.update(child["forbidden"])
    if writer["answer"] is None:
        raise RuntimeError(f"the input writer exited {writer['rc']}")
    if got["answer"] is None:
        raise NoDevice(f"the set-up child exited {got['rc']}")
    devices, inputs = got["answer"], writer["answer"]
    if need_cuda and devices["count"] < chips:
        raise NoDevice(f"{chips} CUDA device(s) asked for, {devices['count']} available")
    paths = [os.path.join(inputs_dir, name) for name in inputs["files"]]
    words = _words(config, traffic, inputs, trace_on, extra)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    # the set-up's parts: this process's start and imports; each child from
    # its fork to its answer (the input writer's from before the imports)
    setup_parts = {"imports_s": t_children - t_start,
                   "devices_s": got["t_end"] - got["t_fork"],
                   "inputs_s": writer["t_end"] - writer["t_fork"],
                   "inputs_started_s": writer["t_fork"] - t_start}
    jobs = []
    while not jobs or time.perf_counter() - t_window < seconds:
        jobs.append(job.run(os.path.join(work, f"job{len(jobs)}"), paths, words, trace_on))
    window_s = jobs[-1]["t_exit"] - jobs[0]["t_fork"]
    for j in jobs:
        forbidden.update(j["forbidden"])

    for i, j in enumerate(jobs):
        j["bytes_written"] = _bytes(os.path.join(work, f"job{i}"))
    run = {"seed": seed, "trace": trace_on, "setup_s": setup_s, "window_s": window_s,
           "setup_parts": setup_parts, "jobs": jobs, "inputs": inputs, "devices": devices,
           "words": words, "forbidden": forbidden,
           "cards": sorted({j.get("cards", 0) for j in jobs}) if need_cuda else None,
           "input_bytes": _bytes(inputs_dir),
           "harness_peak_kb": max(j["self_peak_kb"] for j in jobs)}
    if trace_on:
        for i, j in enumerate(jobs):
            jd = os.path.join(work, f"job{i}")
            j["stages"] = job.stage_records(jd)
            j.update(job.log_counts(jd))
            tr = os.path.join(jd, "trace.json")
            j["trace"] = trace.read(tr, job.PROFILE_MARK) if os.path.exists(tr) else {}
        run["power"] = _power_limit()
        run["process_start"] = _process_start(forbidden) if need_cuda else None

    word_map = dict(w.split("=", 1) for w in words[1:] if "=" in w)
    job_dirs = [os.path.join(work, f"job{i}") for i in range(len(jobs))]

    def reference():
        import torch

        from njref.pipeline import artifacts

        device = "cuda" if need_cuda and torch.cuda.is_available() else "cpu"
        ref = artifacts(inputs_dir, word_map, device)
        return {"diffs": [check.compare(d, ref, word_map) for d in job_dirs],
                "minimizers": ref["minimizers"]}

    t_ref = time.perf_counter()
    verdict = proc.run(reference, log=os.path.join(work, "reference.log"), forbidden=forbidden)
    run["reference_s"] = time.perf_counter() - t_ref
    run["minimizers"] = verdict["minimizers"]
    for j, diffs in zip(jobs, verdict["diffs"]):
        j["diffs"] = diffs
        j["ok"] = j["rc"] == 0 and all(diffs[k] <= lim for k, lim in check.LIMITS.items())
    run["forbidden"] = sorted(forbidden)
    return run


def result(run: dict, metrics: list[dict], kind: str, chips: int) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``
    (each reader's number, where it found one), ``device`` and, traced,
    ``breakdown``; ``checks`` last: each compared number, the worst over the
    jobs, beside its limit."""
    jobs = run["jobs"]
    failed = sum(not j["ok"] for j in jobs)
    values = {}
    for m in metrics:
        got = load_reader(m["name"])(run)
        if got is not None:
            values[m["name"]] = {"value": got, "unit": m["unit"]}
    # the cards the jobs saw, where they ran on cards
    count = run["cards"][0] if run.get("cards") and len(run["cards"]) == 1 else chips
    device = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind, "count": count,
              "memory_peak_bytes": max(j.get("device_peak_bytes", 0) for j in jobs)}
    out = {"correct": failed == 0, "attempted": len(jobs), "failed": failed,
           "metrics": values, "device": device}
    if run["trace"]:
        traced = [j["trace"] for j in jobs if j.get("trace")]
        device["busy_s"] = sum(t["busy_s"] for t in traced)
        device["window_s"] = run["window_s"]
        ops, gaps = {}, {}
        for t in traced:
            for name, sec in t["ops"].items():
                ops[name] = ops.get(name, 0.0) + sec
            for name, sec in t["gaps"].items():
                gaps[name] = gaps.get(name, 0.0) + sec
        out["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10]}
    out["checks"] = {name: {"value": max(j["diffs"][name] for j in jobs), "limit": lim}
                     for name, lim in check.LIMITS.items()}
    return out
