"""No module that a run of the benchmark or its reference loads has ``jax``,
``jaxlib``, ``flax`` or ``ntjoin_tpu`` as its whole top-level name, and the
reference loads nothing of ``ntjoin_tpu_torch`` (fresh interpreters)."""
import json
import os
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

_PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
{imports}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set[str]:
    code = _PROBE.format(root=ROOT, bench=BENCH_DIR, imports=imports)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.splitlines()[-1]))


def test_run_loads_no_jax():
    got = _top_level("import runpy; import torch; import ntjoin_tpu_torch.cli\n"
                     "from njbench import harness, check, gen, job, proc, trace\n"
                     "import control\n"
                     "for m in " + repr(sorted(os.listdir(os.path.join(BENCH_DIR, "metrics"))))
                     + ":\n    m.endswith('.py') and not m.startswith('_') and harness.load_reader(m[:-3])")
    assert not got & {"jax", "jaxlib", "flax", "ntjoin_tpu"}
    assert "ntjoin_tpu_torch" in got  # whole names: the port is not the JAX package


def test_reference_loads_nothing_of_the_port():
    got = _top_level("import njref.pipeline, njref.sketch, njbench.check")
    assert not got & {"jax", "jaxlib", "flax", "ntjoin_tpu", "ntjoin_tpu_torch"}


def test_run_refuses_a_forbidden_module():
    sys.path[:0] = [BENCH_DIR]
    import run

    sys.modules["ntjoin_tpu.fake"] = sys.modules["os"]
    try:
        assert run.forbidden_modules() == ["ntjoin_tpu.fake"]
    finally:
        del sys.modules["ntjoin_tpu.fake"]
    assert "ntjoin_tpu_torch.cli" not in run.forbidden_modules()


def test_harness_without_the_port_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "celegans_2ref.sr_draft", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and '"correct"' not in res.stdout


def _tiny_cell(monkeypatch, cfg, tr):
    """``run.main`` drives the tiny cell on the CPU (the look for a card
    skipped); the cache variables it sets are put back afterwards."""
    from conftest import CPU_WORDS

    from njbench import harness

    sys.path[:0] = [BENCH_DIR]
    import run

    real_cell, real_run = run._cell, harness.run_cell

    def tiny_cell(name):
        cell, _, _, e2e, layers = real_cell(name)
        return cell, cfg, tr, e2e, layers

    def tiny_run(*args, **kwargs):
        return real_run(*args, **{**kwargs, "need_cuda": False, "extra_words": CPU_WORDS})

    monkeypatch.setattr(run, "_cell", tiny_cell)
    monkeypatch.setattr(harness, "run_cell", tiny_run)
    for var in ("PYTORCH_KERNEL_CACHE_PATH", "CUDA_CACHE_PATH", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    return run


ARGS = ["--workload", "celegans_2ref.sr_draft", "--seed", str(2**31 + 5), "--seconds", "0",
        "--trace", "0"]


@pytest.mark.parametrize("where", ["job", "reference"])
def test_run_refuses_a_module_a_child_loads(tiny, monkeypatch, capsys, where):
    """A forbidden module that the port loads while a job runs, or that the
    reference loads in its child, stops the run with exit 4 and no result,
    although the process that prints the result never loads it."""
    import types

    import njref.pipeline
    from njbench import job

    target, attr = (job, "call") if where == "job" else (njref.pipeline, "artifacts")
    real = getattr(target, attr)

    def loads_jax(*args, **kwargs):
        sys.modules["jax"] = types.ModuleType("jax")
        return real(*args, **kwargs)

    monkeypatch.setattr(target, attr, loads_jax)
    run = _tiny_cell(monkeypatch, *tiny)
    assert run.main(ARGS) == 4
    out = capsys.readouterr()
    assert '"correct"' not in out.out and "jax" in out.err
    assert "jax" not in sys.modules


def test_run_passes_the_tiny_cell(tiny, monkeypatch, capsys):
    """The same drive with nothing planted prints a correct result."""
    run = _tiny_cell(monkeypatch, *tiny)
    assert run.main(ARGS) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["correct"] and set(last["metrics"]) == {"assemble_s", "peak_rss_gb", "setup_s"}


def test_run_refuses_another_card_count(tiny, monkeypatch, capsys):
    """Where the jobs saw another number of cards than the cell asks for,
    the run exits 3 with no result."""
    from njbench import harness

    run = _tiny_cell(monkeypatch, *tiny)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"cards": [2]})
    assert run.main(ARGS) == 3
    assert '"correct"' not in capsys.readouterr().out


@pytest.mark.parametrize("seen,want", [(None, "0"), ("3,5,7", "3"), ("", "")])
def test_pin_cards_leaves_the_cells_cards(monkeypatch, seen, want):
    """A one-chip cell sees one card, the first of those visible."""
    from njbench import harness

    if seen is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", seen)
    assert harness.pin_cards(1) == want == os.environ["CUDA_VISIBLE_DEVICES"]
