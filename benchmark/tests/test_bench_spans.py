"""The readers of the port's spans and counters (``trace_counts``): a tiny
cell traced through the port's ``backend=torch device=cpu`` gives each a
number, the stage readers keep reading the ``.time`` walls, and every span
is marked once in the job's profiler trace.  On a card, ``sketch_roofline``
attributes the same kernel time with the spans' nested marks as with the
stages' marks alone."""
import copy
import glob
import json
import os
import sys
import time

import pytest
from conftest import CPU_WORDS, TINY_CONFIG, TINY_TRAFFIC

from njbench import harness, job, trace

SPAN_READERS = ("sketch_encode_s", "sketch_tsv_s", "sketch_upload_wait_s", "scaffold_graph_s",
                "scaffold_paths_s", "scaffold_emit_s", "fai_s", "all_scaffolds_s",
                "sketch_tsv_ns_per_minimizer", "scaffold_format_ns_per_minimizer")
STAGES = {"sketch:ref1.fa", "sketch:ref2.fa", "sketch:target.fa", "scaffold"}


def _traced(words, need_cuda, keep):
    """A traced run of the tiny cell; each job's ``.time`` files, log and
    trace are kept under ``keep`` (``dir``), since the run deletes the jobs'
    directories."""
    real = job.run

    def kept(job_dir, *args):
        got = real(job_dir, *args)
        got["dir"] = os.path.join(keep, os.path.basename(job_dir))
        os.makedirs(got["dir"])
        for path in glob.glob(os.path.join(job_dir, "*")):
            if path.endswith((".time", ".json", ".log")):
                os.link(path, os.path.join(got["dir"], os.path.basename(path)))
        return got

    # the jobs print their count lines to the file behind fd 1, their log:
    # pytest's own capture of sys.stdout would keep them from it
    saved = sys.stdout, sys.stderr
    job.run, sys.stdout, sys.stderr = kept, sys.__stdout__, sys.__stderr__
    try:
        run = harness.run_cell(copy.deepcopy(TINY_CONFIG), copy.deepcopy(TINY_TRAFFIC),
                               2**32 + 17, 0.0, True, time.perf_counter(),
                               need_cuda=need_cuda, extra_words=words)
    finally:
        job.run = real
        sys.stdout, sys.stderr = saved
    return run


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    return _traced(CPU_WORDS, False, str(tmp_path_factory.mktemp("jobs")))


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_gives_a_number(cpu_run, name):
    got = harness.load_reader(name)(cpu_run)
    assert isinstance(got, float) and got > 0, got


def test_readers_give_nothing_without_spans(cpu_run):
    """A port that prints no ``trace_counts`` line: every reader is None."""
    bare = dict(cpu_run, jobs=[{k: v for k, v in j.items() if k != "trace_counts"}
                               for j in cpu_run["jobs"]])
    assert all(harness.load_reader(name)(bare) is None for name in SPAN_READERS)


def test_stage_readers_read_the_time_walls(cpu_run):
    """Spans write no ``.time`` file: the stages are the four of before,
    each ``.time`` wall is its stage's span, and ``sketch_s``,
    ``scaffold_s`` and ``unstaged_s`` read the ``.time`` walls."""
    assert all(j["ok"] for j in cpu_run["jobs"])
    sketch, scaffold, unstaged = [], [], []
    for j in cpu_run["jobs"]:
        st, spans = j["stages"], j["trace_counts"]["spans"]
        assert set(st) == STAGES
        assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(j["dir"], "*.time"))) \
            == sorted(f"out.k32.w1000.n1.{n.replace(':', '.')}.time" for n in STAGES)
        for name, rec in st.items():
            assert spans[name]["n"] == 1 and spans[name]["parent"] is None
            assert abs(spans[name]["s"] - rec["wall_s"]) <= 0.0001, name
        sketch.append(sum(rec["wall_s"] for name, rec in st.items() if name != "scaffold"))
        scaffold.append(st["scaffold"]["wall_s"])
        unstaged.append(j["main_s"] - sum(rec["wall_s"] for rec in st.values()))
    for name, walls in (("sketch_s", sketch), ("scaffold_s", scaffold),
                        ("unstaged_s", unstaged)):
        assert harness.load_reader(name)(cpu_run) == pytest.approx(sorted(walls)[len(walls) // 2])


def test_each_span_marked_once(cpu_run):
    """In a traced job the harness's marks replace the port's own, so each
    stage and span is one ``stage:<full name>`` annotation, nested in its
    parent's."""
    for j in cpu_run["jobs"]:
        with open(os.path.join(j["dir"], "trace.json"), encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
        marks = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith("stage:")]
        spans = j["trace_counts"]["spans"]
        for name, rec in spans.items():
            got = [e for e in marks if e["name"] == "stage:" + name]
            assert len(got) == rec["n"], name
            if rec["parent"] is not None:
                outer = [e for e in marks if e["name"] == "stage:" + rec["parent"]]
                assert all(any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                               for o in outer) for e in got), name
        assert len(marks) == sum(rec["n"] for rec in spans.values())


@pytest.mark.chip
def test_sketch_roofline_same_with_nested_marks(cuda, tmp_path):
    """The kernels that ``sketch_roofline`` counts are the same whether the
    trace holds the spans' nested marks or only the stages' own.  The run
    is made in a fresh interpreter: CUDA started in this process (by the
    ``cuda`` fixture, or an earlier card test) breaks it in a forked job."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        run = pool.apply(_traced, ([], True, str(tmp_path)))
    nested, stages_only = [], []
    for j in run["jobs"]:
        path = os.path.join(j["dir"], "trace.json")
        nested.append(trace.read(path, job.PROFILE_MARK))
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        doc["traceEvents"] = [
            e for e in doc["traceEvents"]
            if not (e.get("cat") == "user_annotation" and e["name"].startswith("stage:")
                    and e["name"][len("stage:"):] not in j["stages"])]
        bare = os.path.join(j["dir"], "stages_only.json")
        with open(bare, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        stages_only.append(trace.read(bare, job.PROFILE_MARK))
    assert any(any(s.startswith("sketch:") and "/" in s for s in t["ops_by_stage"])
               for t in nested)
    roof = harness.load_reader("sketch_roofline")
    got = roof(dict(run, jobs=[dict(j, trace=t) for j, t in zip(run["jobs"], nested)]))
    want = roof(dict(run, jobs=[dict(j, trace=t) for j, t in zip(run["jobs"], stages_only)]))
    assert got is not None and got == pytest.approx(want, rel=1e-9)
