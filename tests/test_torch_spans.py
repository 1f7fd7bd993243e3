"""The port's spans and counters (``utils/timers``): full names, parents
and self time; nothing recorded, pushed or read off the clock when off or
off the main thread; ``OPEN``'s marks in a ``torch.profiler`` trace; and a
tiny ``assemble backend=torch device=cpu time=True`` that writes the
``.time`` files it always wrote and prints every span and counter in its
``trace_counts`` line."""
import contextlib
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ntjoin_tpu_torch import cli
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.ops import sketch_records
from ntjoin_tpu_torch.utils import timers

PREFIX = "out.k32.w250.n2"
STAGES = ("sketch:ref.fa", "sketch:target.fa", "scaffold")
SPANS = (
    "fai:ref.fa", "fai:target.fa", "unique:ref.fa", "unique:target.fa", "all_scaffolds",
    *(f"sketch:{fa}/{s}" for fa in ("ref.fa", "target.fa")
      for s in ("reader", "plan", "pack", "buffer", "device", "split", "tsv")),
    *(f"scaffold/{s}" for s in ("index", "graph", "graph/filter", "paths", "paths/branch",
                                "format", "emit", "emit/trim")),
)
COUNTERS = ("minimizers", "path_minimizers", "graph_edges", "trim_sketch_bases",
            "tsv_fallback_records")
_RC = str.maketrans("ACGT", "TGCA")


def _inputs(d):
    """A 60 kbp genome and 12 overlapping pieces of it, every third reversed,
    one with an N run (so the general path runs too)."""
    rng = np.random.default_rng(4242)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=60_000))
    (d / "ref.fa").write_text(f">genome\n{genome}\n")
    pieces = []
    for i, b in enumerate(range(0, 60_000, 5000)):
        seg = genome[b : b + 5040]
        if i % 3 == 2:
            seg = seg[::-1].translate(_RC)
        if i == 4:
            seg = seg[:2000] + "N" * 50 + seg[2050:]
        pieces.append(f">piece{i}\n{seg}\n")
    (d / "target.fa").write_text("".join(pieces))


def _assemble(d, *extra):
    """``cli.main`` in ``d``: (rc, stdout)."""
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["assemble", "-B", "target=target.fa", "references=ref.fa",
                           "reference_weights=2", "k=32", "w=250", "n=2", "overlap=True",
                           "backend=torch", "device=cpu", *extra])
    finally:
        os.chdir(cwd)
    return rc, out.getvalue()


def _line(text, name):
    return json.loads(next(ln for ln in text.splitlines()
                           if ln.startswith(name + "\t")).split("\t", 1)[1])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The tiny job with ``time=True``: (its directory, stdout, trace_counts)."""
    d = tmp_path_factory.mktemp("traced")
    _inputs(d)
    sketch_records.STAGES.clear()
    rc, out = _assemble(d, "time=True")
    assert rc == 0
    return d, out, _line(out, "trace_counts")


# -- spans and counters, alone ------------------------------------------------------------


def test_full_names_parents_and_self_time(tmp_path):
    with timers.recording(True):
        with timers.span("before"):
            pass
        st = timers.StageTimers(enabled=True, prefix=str(tmp_path / "run"))
        with st.stage("scaffold"):
            with timers.span("emit"):
                assert timers.OPEN[-2:] == ["scaffold", "scaffold/emit"]
                time.sleep(0.02)
                with timers.span("trim"):
                    time.sleep(0.03)
            with timers.span("emit"):
                with timers.span("trim"):
                    time.sleep(0.01)
        got = timers.trace_counts()["spans"]
    assert not timers.OPEN
    assert {name: (rec["n"], rec["parent"]) for name, rec in got.items()} == {
        "before": (1, None), "scaffold": (1, None), "scaffold/emit": (2, "scaffold"),
        "scaffold/emit/trim": (2, "scaffold/emit")}
    emit, trim, stage = got["scaffold/emit"], got["scaffold/emit/trim"], got["scaffold"]
    assert trim["self_s"] == trim["s"] >= 0.04
    assert emit["self_s"] == pytest.approx(emit["s"] - trim["s"], abs=1e-9)
    assert emit["self_s"] >= 0.02
    assert stage["self_s"] == pytest.approx(stage["s"] - emit["s"], abs=1e-9)
    # the stage's .time wall is its span's
    wall = float(dict(ln.split("\t") for ln in (tmp_path / "run.scaffold.time")
                      .read_text().splitlines())["wall_s"])
    assert wall == pytest.approx(stage["s"], abs=1e-4)


def test_counters_add_from_any_thread():
    with timers.recording(True):
        timers.count("x", 2)
        t = threading.Thread(target=lambda: [timers.count("x", 1) for _ in range(1000)])
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        timers.count("y", np.int64(5))
        got = timers.trace_counts()["counters"]
    assert got == {"x": 1002, "y": 5} and all(type(v) is int for v in got.values())


@pytest.mark.parametrize("where", ["off", "other_thread"])
def test_spans_cost_nothing_off(monkeypatch, where):
    """Off, or off the main thread, a span is one shared empty context: no
    clock read, no push on ``OPEN``, nothing kept; off, a counter keeps
    nothing either."""
    def no_clock():
        raise AssertionError("the clock was read")

    seen = []

    def body():
        spans = [timers.span("a"), timers.span("b")]
        seen.append(spans[0] is spans[1])
        with spans[0]:
            seen.append(list(timers.OPEN))
        timers.count("z", 1)

    with timers.recording(where != "off"):
        monkeypatch.setattr(time, "perf_counter_ns", no_clock)
        if where == "off":
            body()
        else:
            t = threading.Thread(target=body)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        monkeypatch.undo()
        got = timers.trace_counts()
    assert seen == [True, []]
    assert got["spans"] == {}
    assert got["counters"] == ({} if where == "off" else {"z": 1})


def test_disabled_stage_reads_no_proc_and_keeps_nothing(monkeypatch, tmp_path):
    """A disabled stage pushes its name and nothing more: no ``/proc`` read,
    no rusage, no record, no file."""
    def forbidden(*a, **k):
        raise AssertionError("read while disabled")

    monkeypatch.setattr(timers, "status_kb", forbidden)
    monkeypatch.setattr(timers.resource, "getrusage", forbidden)
    monkeypatch.setattr(timers, "RssMax", forbidden)
    st = timers.StageTimers(enabled=False, prefix=str(tmp_path / "q"))
    with st.stage("x"):
        assert timers.OPEN[-1] == "x"
    assert not timers.OPEN and st.stages == [] and not list(tmp_path.iterdir())


def test_rss_sampler_files_spans_under_their_stage():
    """``perf_scale``'s sampler files a sample taken in a span under the
    stage around it, and one in a span outside every stage under
    ``(outside stages)``."""
    from ntjoin_tpu_torch.perf_scale import RssSampler

    sampler = RssSampler()
    st = timers.StageTimers(enabled=False)
    with timers.recording(True):
        with timers.span("fai:ref.fa"):
            sampler._sample()
        with st.stage("sketch:ref.fa"):
            with timers.span("pack"):
                assert timers.OPEN[-1] == "sketch:ref.fa/pack"
                sampler._sample()
    assert set(sampler.first) == {"(outside stages)", "sketch:ref.fa"}
    assert not timers.STAGE


def test_open_marks_only_under_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    made = []
    real = torch.profiler.record_function

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with timers.recording(True):
        with timers.span("quiet"):
            pass
        assert made == []
        with profile(activities=[ProfilerActivity.CPU]):
            with timers.span("outer"):
                with timers.span("inner"):
                    pass
    assert made == ["stage:outer", "stage:outer/inner"]


# -- the CLI ------------------------------------------------------------------------------


def test_stage_files_unchanged(traced):
    """The job writes the ``.time`` files it always wrote, one a stage, each
    with the six keys; spans write none."""
    d, out, _ = traced
    files = sorted(p.name for p in d.glob("*.time"))
    assert files == sorted(f"{PREFIX}.{s.replace(':', '.')}.time" for s in STAGES)
    for name in files:
        keys = [ln.split("\t")[0] for ln in (d / name).read_text().splitlines()]
        assert keys == ["stage", "wall_s", "peak_rss_kb", "rss_start_kb", "rss_end_kb",
                        "rss_max_kb"]
    lines = out.splitlines()
    i = lines.index("stage\twall_s\tpeak_rss_kb")
    assert [ln.split("\t")[0] for ln in lines[i + 1 : i + 4]] == list(STAGES)
    assert [ln.split("\t")[0] for ln in lines[i + 4 :]] == ["trace_counts"]


def test_trace_counts_name_every_span_and_counter(traced):
    d, _, tc = traced
    spans, counters = tc["spans"], tc["counters"]
    assert set(spans) == set(SPANS) | set(STAGES)
    assert set(COUNTERS) <= set(counters), sorted(set(COUNTERS) - set(counters))
    assert sum(rec["n"] for rec in spans.values()) < 200
    for name, rec in spans.items():
        assert rec["parent"] == (name.rsplit("/", 1)[0] if "/" in name else None), name
    tsv = [ln.split("\t", 1)[1].split() for p in d.glob("*.tsv")
           for ln in p.read_text().splitlines()]
    assert counters["minimizers"] == sum(map(len, tsv))
    assert 0 < counters["path_minimizers"] < counters["minimizers"]
    # the overlap trim sketches only the ends of the 60 kbp target's pieces
    assert 0 < counters["trim_sketch_bases"] < 60_000 // 4
    assert counters["tsv_fallback_records"] == (0 if native.available() else 13)


def test_child_spans_within_their_stage(traced):
    """Each stage's child spans sum to no more than its wall, and the
    sketch's ``STAGES`` keep their four keys."""
    _, _, tc = traced
    spans = tc["spans"]
    for stage in STAGES + ("scaffold/emit",):
        kids = sum(rec["s"] for rec in spans.values() if rec["parent"] == stage)
        assert 0 < kids <= spans[stage]["s"], stage
        assert spans[stage]["self_s"] == pytest.approx(spans[stage]["s"] - kids, abs=1e-6)
    assert set(sketch_records.STAGES) == {"plan", "pack", "device", "split"}
    for key, sec in sketch_records.STAGES.items():
        got = sum(rec["s"] for name, rec in spans.items() if name.endswith("/" + key))
        assert sec == pytest.approx(got, abs=1e-6), key


def test_no_trace_counts_without_time(tmp_path):
    _inputs(tmp_path)
    rc, out = _assemble(tmp_path)
    assert rc == 0 and "trace_counts" not in out and not list(tmp_path.glob("*.time"))
    assert not timers.ON and timers.trace_counts() == {"spans": {}, "counters": {}}


def _layer(counters: dict, prefix: str, keep: bool = True) -> dict:
    return {name: n for name, n in counters.items() if name.startswith(prefix) == keep}


def test_index_backends_count_alike(tmp_path):
    """The host and the device index backends record the same counters, but
    for the device's graph ops (``graph:``)."""
    got = {}
    for backend in ("host", "device"):
        d = tmp_path / backend
        d.mkdir()
        _inputs(d)
        rc, out = _assemble(d, "time=True", f"index_backend={backend}")
        assert rc == 0
        got[backend] = _line(out, "trace_counts")["counters"]
    assert _layer(got["host"], "graph:", False) == _layer(got["device"], "graph:", False)
    assert not _layer(got["host"], "graph:") and _layer(got["device"], "graph:")


def test_second_run_counts_from_zero(tmp_path):
    """Two ``time=True`` runs in one process print the same counters: each
    recording starts from none, the kernels' launches included."""
    got = []
    for run in ("first", "second"):
        d = tmp_path / run
        d.mkdir()
        _inputs(d)
        rc, out = _assemble(d, "time=True")
        assert rc == 0 and not [ln for ln in out.splitlines() if ln.startswith("sketch_counts")]
        got.append(_line(out, "trace_counts")["counters"])
    assert got[0] == got[1]
    assert got[0]["launch:hash_plain"] >= 2 and got[0]["sketch:codes_held_max"] > 0


def test_counter_names_follow_the_rule(traced):
    """Every counter of the job is one the benchmark reads, unprefixed, or
    ``<layer>:<name>``, each layer of the torch path present, the graph
    ops' with the device type they ran on."""
    _, _, tc = traced
    counters = tc["counters"]
    layers = {name.split(":", 1)[0] for name in counters if ":" in name}
    assert layers == {"launch", "sketch_route", "sketch", "graph"}, sorted(counters)
    assert {name for name in counters if ":" not in name} == set(COUNTERS) | {"fai_rescans"}
    for op in ("shared_filter", "edge_tally", "cc", "escalate", "rank"):
        assert counters[f"graph:{op}@cpu"] >= 1, op
    assert all(name.endswith("_plain") for name in _layer(counters, "launch:"))


def test_profiler_trace_nests_the_spans(tmp_path):
    """Under a CPU ``torch.profiler`` the port's own ``OPEN`` marks every
    stage and span, ``stage:scaffold/emit`` inside ``stage:scaffold``."""
    from torch.profiler import ProfilerActivity, profile

    _inputs(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rc, out = _assemble(tmp_path, "time=True")
    assert rc == 0
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json", encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    marks = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("stage:"):
            marks.setdefault(e["name"][len("stage:"):], []).append((e["ts"], e["ts"] + e["dur"]))
    spans = _line(out, "trace_counts")["spans"]
    assert {name: len(m) for name, m in marks.items()} == \
        {name: rec["n"] for name, rec in spans.items()}
    (lo, hi), = marks["scaffold"]
    (elo, ehi), = marks["scaffold/emit"]
    (tlo, thi), = marks["scaffold/emit/trim"]
    assert lo <= elo <= tlo <= thi <= ehi <= hi
    pack = marks["sketch:target.fa/pack"]
    (slo, shi), = marks["sketch:target.fa"]
    assert all(slo <= a <= b <= shi for a, b in pack)
