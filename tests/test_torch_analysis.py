"""The port's analysis layer (``ntjoin_tpu_torch/analysis.py``, the
minimap2/samtools/QUAST wrappers) through the port's command line, with
stubbed tools: the cases of ``tests/test_analysis.py`` on the port's copy.

The real tools are absent; shell stubs on PATH record their argv so the
command construction (mirroring reference ``ntJoin:238-252``) is testable
end-to-end.
"""
import os
import stat
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stub(bindir, name, body):
    p = bindir / name
    p.write_text("#!/bin/bash\n" + body)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)


def _env(bindir):
    env = dict(os.environ, PYTHONPATH=REPO)
    env["PATH"] = f"{bindir}:{env['PATH']}"
    return env


def test_torch_quast_command(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "quast.log"
    _stub(bindir, "quast", f'echo "$@" >> {log}\nmkdir -p "$4"\n'
          f'touch "$4/report.tsv"\n')
    for f in ("t.fa", "r.fa", "truth.fa", "t.fa.k32.w1000.n2.all.scaffolds.fa"):
        (tmp_path / f).write_text(">x\nACGT\n")
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu_torch.cli", "quast", "target=t.fa",
         "references=r.fa", "ref=truth.fa", "n=2", "prefix=p1", "large=1"],
        cwd=tmp_path, env=_env(bindir), capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    assert "quast_p1/report.tsv" in res.stdout
    args = log.read_text().split()
    # reference flag set (ntJoin:244-252)
    for flag in ("--fast", "--scaffold-gap-max-size", "100000",
                 "--split-scaffolds", "--large"):
        assert flag in args
    assert args[args.index("-r") + 1] == "truth.fa"
    # assemblies: references, target, all.scaffolds — in that order
    assert args[-3:] == ["r.fa", "t.fa", "t.fa.k32.w1000.n2.all.scaffolds.fa"]


def test_torch_analysis_accepts_gzipped_scaffolds(tmp_path):
    """assemble gzip=True replaces <fa> with <fa>.gz; analysis must still
    find and align the scaffolds (a plain-name existence check would
    skip them)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.log"
    _stub(bindir, "minimap2", f'echo "minimap2 $@" >> {log}\necho SAM\n')
    _stub(bindir, "samtools", f'echo "samtools $@" >> {log}\ncat > /dev/null\n')
    for f in ("t.fa", "truth.fa"):
        (tmp_path / f).write_text(">x\nACGT\n")
    import gzip

    with gzip.open(tmp_path / "t.fa.k32.w1000.n1.all.scaffolds.fa.gz", "wt") as fh:
        fh.write(">s\nACGT\n")
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu_torch.cli", "analysis", "target=t.fa",
         "ref=truth.fa", "t=3"],
        cwd=tmp_path, env=_env(bindir), capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    assert "t.fa.k32.w1000.n1.all.scaffolds.fa.gz" in log.read_text()


def test_torch_quast_missing_tool(tmp_path):
    (tmp_path / "t.fa").write_text(">x\nACGT\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH="/usr/bin:/bin")
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu_torch.cli", "quast", "target=t.fa",
         "references=r.fa", "ref=truth.fa"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 1
    assert "quast not found" in res.stderr


def test_torch_analysis_alignment_pipeline(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.log"
    _stub(bindir, "minimap2", f'echo "minimap2 $@" >> {log}\necho SAM\n')
    _stub(bindir, "samtools", f'echo "samtools $@" >> {log}\ncat > /dev/null\n')
    for f in ("t.fa", "r.fa", "truth.fa", "t.fa.k32.w1000.n1.all.scaffolds.fa"):
        (tmp_path / f).write_text(">x\nACGT\n")
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu_torch.cli", "analysis", "target=t.fa",
         "references=r.fa", "ref=truth.fa", "t=3"],
        cwd=tmp_path, env=_env(bindir), capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    calls = log.read_text()
    # asm5 preset with the reference's -r100000, vs the truth reference
    assert "minimap2 -a -x asm5 -r100000 -t 3 truth.fa r.fa" in calls
    assert "minimap2 -a -x asm5 -r100000 -t 3 truth.fa t.fa" in calls
    assert (
        "minimap2 -a -x asm5 -r100000 -t 3 truth.fa "
        "t.fa.k32.w1000.n1.all.scaffolds.fa" in calls
    )
    assert "samtools index" in calls
    # bams written next to the inputs
    assert (tmp_path / "t.fa.bam").exists()



def test_torch_missing_tool_error_matches_jax(monkeypatch):
    """The copy raises the original's error, with its message, for a tool
    that is not on PATH."""
    import pytest

    import ntjoin_tpu.analysis as jax_analysis
    import ntjoin_tpu_torch.analysis as port

    monkeypatch.setenv("PATH", "/nonexistent")
    msgs = []
    for mod in (port, jax_analysis):
        with pytest.raises(mod.MissingToolError) as info:
            mod.align_to_reference("t.fa", "truth.fa")
        msgs.append(str(info.value))
    assert issubclass(port.MissingToolError, RuntimeError)
    assert msgs[0] == msgs[1] and "minimap2 not found" in msgs[0]
