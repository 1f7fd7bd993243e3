"""``BENCHMARK.json`` keeps to the benchmark's schema: names, units and
texts of the allowed characters and lengths, and every name found by the
harness's files."""
import json
import os
import re

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_text_ok(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    names = [e["name"] for g in groups for e in bench[g]]
    assert all(NAME.match(n) for n in names)
    for g in groups:
        assert len({e["name"] for e in bench[g]}) == len(bench[g])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert _text_ok(c["source"]) and _text_ok(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _text_ok(w["why"])
        assert w["chips"] in (1, 4)


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _text_ok(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["name"], m["layer"])
    for w in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as fh:
            cfg = json.load(fh)
        assert set(cfg["reduced"]) == set(c["reduced"])
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))


def test_check_fits(bench):
    """A full check of 24 cells at this window fits the driver's 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
