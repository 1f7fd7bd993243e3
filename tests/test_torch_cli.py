"""The port's command line against the JAX package's: byte-equal artifacts
on synthetic fixtures, its refusals, and the chip smoke script without a
card."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ntjoin_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RC = str.maketrans("ACGT", "TGCA")


def _many_contigs(d):
    """12 pieces of a 60 kbp genome, overlapping by 40 bp."""
    rng = np.random.default_rng(12345)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=60_000))
    (d / "ref.fa").write_text(f">genome\n{genome}\n")
    pieces = [f">piece{i}\n{genome[b:min(60_000, b + 5040)]}\n"
              for i, b in enumerate(range(0, 60_000, 5000))]
    (d / "target.fa").write_text("".join(pieces))


def _more_sequences(d):
    """24 pieces of a 120 kbp genome, every 4th reversed, terminal Ns, two
    unrelated contigs (the fixture pinned by tests/golden/longer.*)."""
    rng = np.random.default_rng(777)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=120_000))
    (d / "ref.fa").write_text(f">genome\n{genome}\n")
    pieces = []
    for i, b in enumerate(range(0, 120_000, 5000)):
        seg = genome[b : b + 5000]
        if i % 4 == 3:
            seg = seg[::-1].translate(_RC)
        if i == 5:
            seg = "N" * 12 + seg[12:]
        pieces.append(f">piece{i}\n{seg}\n")
    extra = "".join("ACGT"[i] for i in rng.integers(0, 4, size=3000))
    pieces.append(f">floating1\n{extra}\n")
    pieces.append(f">floating2\n{extra[::-1].translate(_RC)}\n")
    (d / "target.fa").write_text("".join(pieces))


_COMMON = ["target=target.fa", "references=ref.fa", "reference_weights=2", "k=32",
           "w=250", "n=2", "overlap=True"]
_PORT = (
    "import sys; from ntjoin_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
    "assert 'jax' not in sys.modules, 'the port imported jax'; sys.exit(rc)"
)


@pytest.mark.parametrize("index_backend", ["auto", "host"])
@pytest.mark.parametrize("fixture,prefix,extra", [
    (_many_contigs, "many", []),
    (_more_sequences, "longer", ["agp=True"]),
])
def test_port_cli_matches_jax_cli(tmp_path, fixture, prefix, extra, index_backend):
    """``index_backend=auto`` with ``backend=torch`` runs the port's device
    index on the CPU; ``host`` the JAX package's host layers."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        d.mkdir()
        fixture(d)
    env = dict(os.environ, PYTHONPATH=REPO)
    args = ["assemble", "-B", *_COMMON, f"prefix={prefix}", *extra]
    res = subprocess.run([sys.executable, "-c", _PORT, *args, "backend=torch", "time=True",
                          f"index_backend={index_backend}"],
                         cwd=port, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr + res.stdout
    counts = json.loads(next(ln for ln in res.stdout.splitlines()
                             if ln.startswith("index_counts\t")).split("\t", 1)[1])
    for op in ("shared_filter", "edge_tally", "cc", "escalate", "rank"):
        want = (None, 0) if index_backend == "host" else ("cpu", 1 + (op == "cc"))
        assert (counts[op]["device"], counts[op]["launches"]) == want, op
    res = subprocess.run([sys.executable, "-m", "ntjoin_tpu.cli", *args, "backend=numpy",
                          "index_backend=host"], cwd=ref, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr + res.stdout
    made = sorted(p.name for p in ref.iterdir())
    assert f"{prefix}.path" in made and f"{prefix}.mx.dot" in made
    assert "target.fa.k32.w250.tsv" in made and "ref.fa.fai" in made
    assert "target.fa.k32.w250.n2.all.scaffolds.fa" in made
    for name in made:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    if prefix == "longer":
        golden = os.path.join(REPO, "tests", "golden")
        for want, got in (("longer.path", "longer.path"), ("longer.agp", "longer.agp"),
                          ("longer.unassigned.bed", "longer.target.fa.k32.w250.tsv.unassigned.bed")):
            with open(os.path.join(golden, want), encoding="utf-8") as fh:
                assert (port / got).read_text() == fh.read(), want


@pytest.mark.parametrize("word,item", [
    ("mkt=True", "ROADMAP Queue A item 9"),
    ("backend=pallas", "ROADMAP Queue A items 2-3"),
    ("backend=jax", "ROADMAP Queue A items 2-3"),
    ("n_procs=2", "ROADMAP Queue A item 12"),
])
def test_refusals(tmp_path, capsys, monkeypatch, word, item):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["assemble", "target=t.fa", "references=r.fa", "reference_weights=2",
                   "backend=torch", word])
    err = capsys.readouterr().err
    assert rc != 0
    assert err.startswith("ERROR: ") and item in err and err.count("\n") == 1
    assert not list(tmp_path.iterdir())


def test_cuda_backend_needs_a_device(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "auto"):
        rc = cli.main(["assemble", "target=t.fa", "references=r.fa", "reference_weights=2",
                       f"backend={backend}"])
        assert rc != 0 and "needs a CUDA device" in capsys.readouterr().err


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout
