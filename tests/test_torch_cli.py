"""The port's command line against the JAX package's: byte-equal artifacts
on synthetic fixtures (``mkt=True`` among them), the other commands
(``help``, ``version``, ``check_install``, ``analysis``, ``quast``,
``all``) and ``run.py``, its refusals, the chip smoke script without a
card, and each input's ``.fai`` written from the sketch reader's rows (no
second read of the file) where it can be."""
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ntjoin_tpu_torch import cli
from ntjoin_tpu_torch.io import fasta, native

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
    index on the CPU; ``host`` the port's own host layers."""
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


def _swapped_blocks(d):
    """12 pieces of a 120 kbp genome, every third with two 2 kbp blocks
    swapped (minimizer positions not monotonic: Mann-Kendall decides), every
    fourth reversed."""
    rng = np.random.default_rng(4242)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=120_000))
    (d / "ref.fa").write_text(f">genome\n{genome}\n")
    pieces = []
    for i, b in enumerate(range(0, 120_000, 10_000)):
        seg = genome[b : b + 10_000]
        if i % 3 == 1:
            seg = seg[:3000] + seg[5000:7000] + seg[3000:5000] + seg[7000:]
        if i % 4 == 3:
            seg = seg[::-1].translate(_RC)
        pieces.append(f">piece{i}\n{seg}\n")
    (d / "target.fa").write_text("".join(pieces))


def _counts(stdout: str, key: str) -> dict:
    return json.loads(next(ln for ln in stdout.splitlines()
                           if ln.startswith(key + "\t")).split("\t", 1)[1])


@pytest.mark.parametrize("words", [["backend=torch"], ["backend=native", "index_backend=host"]])
@pytest.mark.parametrize("fixture,extra", [
    (_many_contigs, ["w=250"]),
    (_more_sequences, ["w=250", "agp=True"]),
    (_swapped_blocks, ["w=100"]),
])
def test_assemble_mkt_matches_jax_cli(tmp_path, fixture, extra, words):
    """``mkt=True``: every artifact byte-equal to ``ntjoin_tpu.cli``'s, the
    Mann-Kendall op on the CPU (``mk_counts``) wherever a run is not
    monotonic."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    for d in (port, ref):
        d.mkdir()
        fixture(d)
    args = ["assemble", "-B", "target=target.fa", "references=ref.fa", "reference_weights=2",
            "k=32", "n=2", "mkt=True", "prefix=mk", *extra]
    res = _run_cli(["-c", _PORT], args + words + ["time=True"], port)
    _run_cli(["-m", "ntjoin_tpu.cli"], args + ["backend=numpy", "index_backend=host"], ref)
    counts = _counts(res.stdout, "mk_counts")
    if fixture is _swapped_blocks:
        assert counts["mk_runs"] >= 4 and counts["device"] == "cpu", counts
    made = sorted(p.name for p in ref.iterdir())
    assert "mk.path" in made and len(made) >= 11
    for name in made:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name


def _run_cli(module_or_code: list[str], args: list[str], cwd) -> subprocess.CompletedProcess:
    res = subprocess.run([sys.executable, *module_or_code, *args], cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True)
    assert res.returncode == 0, res.stderr + res.stdout
    return res


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("fixture,prefix,extra", [
    (_many_contigs, "many", []),
    (_more_sequences, "longer", ["agp=True", "no_cut=True"]),
])
def test_port_host_backends_match_jax_cli(tmp_path, fixture, prefix, extra, backend):
    """The port's host sketchers and host layers (``backend=native|numpy
    index_backend=host``) give the JAX package's bytes for the same words,
    and so does ``backend=torch device=cpu`` with the torch index."""
    dirs = {name: tmp_path / name for name in ("jax", "port", "torch")}
    for d in dirs.values():
        d.mkdir()
        fixture(d)
    args = ["assemble", "-B", *_COMMON, f"prefix={prefix}", *extra]
    words = [f"backend={backend}", "index_backend=host"]
    _run_cli(["-m", "ntjoin_tpu.cli"], args + words, dirs["jax"])
    res = _run_cli(["-c", _PORT], args + words + ["time=True"], dirs["port"])
    sketch = json.loads(next(ln for ln in res.stdout.splitlines()
                             if ln.startswith("sketch_counts\t")).split("\t", 1)[1])
    index = json.loads(next(ln for ln in res.stdout.splitlines()
                            if ln.startswith("index_counts\t")).split("\t", 1)[1])
    assert not any(v for key, v in sketch.items()), sketch  # no kernel, no plain version
    assert not any(index[op]["launches"] for op in index if op != "cc_rounds"), index
    _run_cli(["-c", _PORT], args + ["backend=torch", "device=cpu"], dirs["torch"])
    made = sorted(p.name for p in dirs["jax"].iterdir())
    assert f"{prefix}.path" in made and "target.fa.k32.w250.n2.all.scaffolds.fa" in made
    assert sorted(p.name for p in dirs["port"].iterdir() if not p.name.endswith(".time")) == made
    for name in made:
        want = (dirs["jax"] / name).read_bytes()
        assert (dirs["port"] / name).read_bytes() == want, name
        assert (dirs["torch"] / name).read_bytes() == want, name


def test_own_cli_helpers_match_jax_cli(tmp_path):
    """``_parse_vars``, ``_truthy`` and ``_gzip_artifact`` are the port's own
    copies: same defaults, same verdicts, same file out."""
    import gzip

    from ntjoin_tpu import cli as jax_cli

    assert cli._DEFAULTS == jax_cli._DEFAULTS
    words = ["target=t.fa", "k=21", "references=a.fa b.fa", "x=1=2"]
    assert cli._parse_vars(words) == jax_cli._parse_vars(words)
    for bad in (cli._parse_vars, jax_cli._parse_vars):
        with pytest.raises(SystemExit, match="unrecognized argument 'oops'"):
            bad(["oops"])
    for val in ("True", "true ", "1", "yes", "YES", "no", "0", "False", ""):
        assert cli._truthy(val) == jax_cli._truthy(val), val
    for name, fn in (("port.fa", cli._gzip_artifact), ("jax.fa", jax_cli._gzip_artifact)):
        (tmp_path / name).write_text(">a\nACGT\n")
        assert fn(str(tmp_path / name), threads=1) == str(tmp_path / name) + ".gz"
        assert not (tmp_path / name).exists()
        with gzip.open(tmp_path / (name + ".gz"), "rt") as fh:
            assert fh.read() == ">a\nACGT\n"


@pytest.mark.parametrize("word,item", [
    ("backend=pallas", "ROADMAP Queue A items 2-3"),
    ("backend=jax", "ROADMAP Queue A items 2-3"),
    ("n_procs=2", "n_procs>1 needs coordinator=<host:port>"),
])
def test_refusals(tmp_path, capsys, monkeypatch, word, item):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["assemble", "target=t.fa", "references=r.fa", "reference_weights=2",
                   "backend=torch", word])
    err = capsys.readouterr().err
    assert rc != 0
    assert err.startswith("ERROR: ") and item in err and err.count("\n") == 1
    assert not list(tmp_path.iterdir())


def test_mesh_branch_matches_one_device(tmp_path, monkeypatch):
    """``_mesh`` handing four CPU shards: each record's sketch is tiled
    (``parallel/mesh.py``) and every artifact is byte-equal to the
    one-device run's."""
    from ntjoin_tpu_torch.parallel import mesh

    args = ["assemble", "-B", *_COMMON, "prefix=m", "agp=True", "backend=torch"]
    for name in ("one", "mesh"):
        (tmp_path / name).mkdir()
        _more_sequences(tmp_path / name)
    monkeypatch.chdir(tmp_path / "one")
    assert cli._mesh(cli._parse_vars(args[2:])) is None  # no card here
    assert cli.main(args) == 0
    monkeypatch.chdir(tmp_path / "mesh")
    monkeypatch.setattr(cli, "_mesh", lambda v: ["cpu"] * 4)
    mesh.reset_counts()
    assert cli.main(args) == 0
    assert mesh.COUNTS["sharded_records"] >= 24 and mesh.COUNTS["tiles"] >= 4 * 24
    made = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert "m.path" in made and "target.fa.k32.w250.tsv" in made
    assert sorted(p.name for p in (tmp_path / "mesh").iterdir()) == made
    for name in made:
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "one" / name).read_bytes(), name


def test_mesh_rule(monkeypatch):
    """The JAX package's rule: cuda or auto, more than one card, and
    NTJOIN_TPU_MESH not off."""
    monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: 4)
    v = cli._parse_vars(["backend=cuda"])
    assert cli._mesh(v) == [f"cuda:{i}" for i in range(4)]
    assert cli._mesh(cli._parse_vars(["backend=torch"])) is None
    monkeypatch.setenv("NTJOIN_TPU_MESH", "off")
    assert cli._mesh(v) is None
    monkeypatch.setenv("NTJOIN_TPU_MESH", "auto")
    monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: 1)
    assert cli._mesh(v) is None


def _help_keys(text: str) -> list[str]:
    """The option keys of a help text: first words of its tab-set lines."""
    return [ln.split("\t")[0] for ln in text.splitlines()
            if "\t" in ln and ln.split("\t")[0] and " " not in ln.split("\t")[0]]


@pytest.mark.parametrize("word", ["help", "-h", "--help", None])
def test_help_prints_the_manual(capsys, word):
    from ntjoin_tpu import cli as jax_cli

    assert cli.main([word] if word else []) == 0
    out = capsys.readouterr().out
    assert cli.VERSION in out
    for backend in ("cuda", "torch", "native", "numpy"):
        assert backend in out.split("\nbackend\t", 1)[1].splitlines()[0]
    assert "pallas" not in out and "jax" not in out
    keys = _help_keys(out)
    assert [k for k in keys if k != "device"] == _help_keys(jax_cli.HELP_TEXT)
    assert "device" in keys and len(keys) == 30


def test_version_and_check_install(capsys):
    from ntjoin_tpu import cli as jax_cli

    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == jax_cli.VERSION == cli.VERSION
    res = subprocess.run([sys.executable, "-c", _PORT, "check_install"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert "core sketch: OK" in res.stdout
    assert "CUDA device: none" in res.stdout and "native library: " in res.stdout


def test_unknown_command(capsys):
    assert cli.main(["frobnicate"]) == 1
    assert "unknown command 'frobnicate'" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["analysis", "quast", "all"])
def test_missing_tools_as_the_jax_cli(tmp_path, cmd):
    """Without minimap2, samtools and QUAST on PATH both command lines exit
    1 with the same MissingToolError message (``all`` assembles first)."""
    outs = []
    for pkg, code in (("jax", ["-m", "ntjoin_tpu.cli"]), ("port", ["-c", _PORT])):
        d = tmp_path / pkg
        d.mkdir()
        _many_contigs(d)
        words = [cmd, *_COMMON, "ref=ref.fa", "prefix=p"]
        words += ["backend=numpy", "index_backend=host"] if pkg == "jax" else ["backend=torch"]
        res = subprocess.run([sys.executable, *code, *words], cwd=d,
                             env=dict(os.environ, PYTHONPATH=REPO, PATH="/usr/bin:/bin"),
                             capture_output=True, text=True)
        outs.append((res.returncode, res.stderr.strip().splitlines()[-1]))
    tool = "quast" if cmd == "quast" else "minimap2"
    assert outs[0] == outs[1] == (1, f"ERROR: {tool} not found on PATH — the analysis stage "
                                     "wraps external alignment/evaluation tools "
                                     "(minimap2/samtools/quast)")
    if cmd == "all":
        assert (tmp_path / "port" / "p.path").read_bytes() == (tmp_path / "jax" / "p.path").read_bytes()


def test_run_matches_jax_run(tmp_path):
    """``python -m ntjoin_tpu_torch.run`` on the TSVs of a fixture: every
    artifact byte-equal to ``ntjoin_tpu.run``'s, with the device index on
    the CPU and with the host layers."""
    sk = tmp_path / "sketch"
    sk.mkdir()
    _swapped_blocks(sk)
    _run_cli(["-m", "ntjoin_tpu.cli"], ["assemble", "-B", "target=target.fa", "references=ref.fa",
                                        "reference_weights=2", "k=32", "w=100", "n=2",
                                        "backend=numpy"], sk)
    inputs = ["ref.fa", "target.fa", "ref.fa.k32.w100.tsv", "target.fa.k32.w100.tsv"]
    flags = ["ref.fa.k32.w100.tsv", "-s", "target.fa.k32.w100.tsv", "-r", "2", "-k", "32",
             "-n", "2", "-p", "run", "--agp", "--mkt"]
    runs = {"jax": ["-m", "ntjoin_tpu.run"],
            "device": ["-m", "ntjoin_tpu_torch.run", "--device", "cpu"],
            "host": ["-m", "ntjoin_tpu_torch.run", "--device", "cpu", "--index_backend", "host"]}
    for name, cmd in runs.items():
        d = tmp_path / name
        d.mkdir()
        for f in inputs:
            (d / f).write_bytes((sk / f).read_bytes())
        _run_cli(cmd, flags, d)
    made = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "run.path" in made and "run.agp" in made
    for name in ("device", "host"):
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == made
        for f in made:
            assert (tmp_path / name / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


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


_HOST = [*_COMMON, "backend=native", "index_backend=host", "time=True"]


def _traced(monkeypatch, capsys, d, words) -> dict:
    """``assemble`` in this process in ``d``; its ``trace_counts``."""
    monkeypatch.chdir(d)
    assert cli.main(["assemble", *words]) == 0
    return _counts(capsys.readouterr().out, "trace_counts")


def _spy_write_fai(monkeypatch, fail: bool = False) -> list:
    """The paths ``write_fai`` is called on, from the CLI or ``FastaStore``;
    with ``fail`` every call raises."""
    calls, real = [], fasta.write_fai

    def spy(path, out_path=None):
        calls.append(os.path.basename(path))
        if fail:
            raise AssertionError(f"{path} read again for its .fai")
        return real(path, out_path)

    monkeypatch.setattr(cli, "write_fai", spy)
    monkeypatch.setattr(fasta, "write_fai", spy)
    return calls


def test_fai_comes_from_the_reader_rows(tmp_path, monkeypatch, capsys):
    """On plain FASTAs with the native reader, ``assemble`` writes each
    input's ``.fai`` from the rows of the sketch's own read: ``write_fai``
    is never called, the bytes are its bytes, ``fai_rescans`` is 0."""
    if not native.available():
        pytest.skip("no g++ to build the native library")
    _more_sequences(tmp_path)
    real = fasta.write_fai
    _spy_write_fai(monkeypatch, fail=True)
    got = _traced(monkeypatch, capsys, tmp_path, ["-B", *_HOST, "prefix=rows"])
    assert got["counters"]["fai_rescans"] == 0
    assert {"fai:ref.fa", "fai:target.fa"} <= set(got["spans"])
    for fa in ("ref.fa", "target.fa"):
        real(str(tmp_path / fa), str(tmp_path / "want.fai"))
        assert (tmp_path / (fa + ".fai")).read_bytes() == (tmp_path / "want.fai").read_bytes()


def test_gzipped_input_is_read_again_for_its_fai(tmp_path, monkeypatch, capsys):
    """A gzipped reference takes the Python reader, which keeps no rows:
    its ``.fai`` comes from ``write_fai``, and ``fai_rescans`` counts it."""
    if not native.available():
        pytest.skip("no g++ to build the native library")
    _more_sequences(tmp_path)
    with open(tmp_path / "ref.fa", "rb") as src, gzip.open(tmp_path / "ref.fa.gz", "wb") as dst:
        dst.write(src.read())
    calls = _spy_write_fai(monkeypatch)
    words = [w if w != "references=ref.fa" else "references=ref.fa.gz" for w in _HOST]
    got = _traced(monkeypatch, capsys, tmp_path, ["-B", *words, "prefix=gz"])
    assert got["counters"]["fai_rescans"] == 1
    assert calls == ["ref.fa.gz"]


def test_fresh_tsv_with_a_stale_fai_reads_the_file(tmp_path, monkeypatch, capsys):
    """With the TSVs fresh no sketch reads the files: a missing ``.fai`` is
    written by ``write_fai`` (``fai_rescans`` 1), the same bytes as the
    reader's rows gave; a fresh one is left alone and not counted."""
    if not native.available():
        pytest.skip("no g++ to build the native library")
    _many_contigs(tmp_path)
    calls = _spy_write_fai(monkeypatch)
    first = _traced(monkeypatch, capsys, tmp_path, [*_HOST, "prefix=first"])
    assert first["counters"]["fai_rescans"] == 0 and calls == []
    want = (tmp_path / "ref.fa.fai").read_bytes()
    os.remove(tmp_path / "ref.fa.fai")
    again = _traced(monkeypatch, capsys, tmp_path, [*_HOST, "prefix=again"])
    assert again["counters"]["fai_rescans"] == 1 and calls == ["ref.fa"]
    assert "fai:ref.fa" in again["spans"] and "fai:target.fa" not in again["spans"]
    assert not any(name.startswith("sketch:") for name in again["spans"])
    assert (tmp_path / "ref.fa.fai").read_bytes() == want


def test_native_build_follows_the_reader_source(tmp_path, monkeypatch):
    """``native.build`` compiles both sources into the library, leaves a
    library newer than both alone, compiles again when only the port's
    reader source is newer, and gives False without it."""
    for name in ("SRC_PATH", "READER_PATH"):
        copy = tmp_path / os.path.basename(getattr(native, name))
        shutil.copy(getattr(native, name), copy)
        monkeypatch.setattr(native, name, str(copy))
    lib = tmp_path / "_build" / "libntjoin_native.so"
    monkeypatch.setattr(native, "LIB_PATH", str(lib))
    monkeypatch.setattr(native.shutil, "which", lambda name: "/usr/bin/" + name)
    compiled = []

    def fake_gxx(cmd, **kw):
        out = cmd.index("-o") + 1
        compiled.append(cmd[out + 1:])
        open(cmd[out], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native.subprocess, "run", fake_gxx)
    assert native.build() and compiled == [[native.SRC_PATH, native.READER_PATH]]
    t = os.path.getmtime(lib)
    for src in (native.SRC_PATH, native.READER_PATH):
        os.utime(src, (t - 10, t - 10))
    assert native.build() and len(compiled) == 1
    os.utime(native.READER_PATH, (t + 10, t + 10))
    assert native.build() and compiled[1] == compiled[0]
    os.remove(native.READER_PATH)
    assert native.build() is False and len(compiled) == 2
