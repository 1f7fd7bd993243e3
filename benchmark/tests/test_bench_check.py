"""The comparison that decides ``correct``, on a tiny cell through the
port's ``backend=torch device=cpu``: a clean run passes, and a run whose
timed path is broken underneath (the harness's look for a card skipped)
comes out not correct, once for each fault the cell can have."""
import glob
import os
import time

import pytest
from conftest import CPU_WORDS

from njbench import check, harness, job


def _run(cfg, tr, seed=2**32 + 9):
    return harness.run_cell(cfg, tr, seed, 0.0, False, time.perf_counter(),
                            need_cuda=False, extra_words=CPU_WORDS)


def _result(run):
    return harness.result(run, [{"name": "assemble_s", "unit": "s"}], "cpu", 1)


def _tsv(name):
    return glob.glob(f"{name}.k*.w*.tsv")[0]


def _alter_tsv_hash():
    path = _tsv("target.fa")
    lines = open(path).read().splitlines()
    for i, line in enumerate(lines):
        name, _, rest = line.partition("\t")
        if rest:
            toks = rest.split(" ")
            h, _, tail = toks[0].partition(":")
            toks[0] = f"{int(h) ^ 1}:{tail}"
            lines[i] = name + "\t" + " ".join(toks)
            break
    open(path, "w").write("\n".join(lines) + "\n")


def _drop_half_records():
    path = _tsv("ref1.fa")
    lines = open(path).read().splitlines()
    half = [line.partition("\t")[0] + "\t" if i % 2 else line for i, line in enumerate(lines)]
    open(path, "w").write("\n".join(half) + "\n")


def _alter_path_line():
    path = glob.glob("*.path")[0]
    lines = open(path).read().splitlines()
    lines[1] = lines[1].replace("+", "-", 1) if "+" in lines[1] else lines[1] + "x"
    open(path, "w").write("\n".join(lines) + "\n")


def _alter_scaffold_base():
    path = glob.glob("*.assigned.scaffolds.fa")[0]
    data = bytearray(open(path, "rb").read())
    i = data.index(b"\n") + 100
    data[i] = ord("A") if data[i] != ord("A") else ord("C")
    open(path, "wb").write(bytes(data))


FAULTS = {
    "tsv_hash": _alter_tsv_hash,
    "half_the_records": _drop_half_records,
    "path_line": _alter_path_line,
    "scaffold_base": _alter_scaffold_base,
}


def test_clean_run_is_correct(tiny):
    cfg, tr = tiny
    run = _run(cfg, tr)
    out = _result(run)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 1
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert sum(run["minimizers"].values()) > 0


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["state_unchanged"])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    """Each fault planted where the job produces its answer: an answer
    altered (a TSV hash, a ``.path`` line, a scaffold base), half of the
    records' minimizers left out, and a job that returns without doing its
    work."""
    cfg, tr = tiny
    real = job.call

    def broken(words):
        if fault == "state_unchanged":
            return 0
        rc = real(words)
        FAULTS[fault]()
        return rc

    monkeypatch.setattr(job, "call", broken)
    out = _result(_run(cfg, tr))
    assert not out["correct"] and out["failed"] == 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_compare_counts_what_differs(tmp_path):
    ref = {"tsv": {"a.fa": [("r1", ["1:0:AC", "2:5:GT"]), ("r2", [])]},
           "path": "a.fa\nntJoin0\tr1+:0-10\n", "assigned": ">ntJoin0\nACGT\n",
           "unassigned": ">r2:0-4\nTTTT\n"}
    words = {"target": "a.fa", "references": "", "k": "2", "w": "3", "n": "1"}
    (tmp_path / "a.fa.k2.w3.tsv").write_text("r1\t1:0:AC 9:5:GT\nr2\t\n")
    (tmp_path / "out.k2.w3.n1.path").write_text(ref["path"])
    (tmp_path / "a.fa.k2.w3.n1.assigned.scaffolds.fa").write_text(">ntJoin0\nACGA\n")
    (tmp_path / "a.fa.k2.w3.n1.unassigned.scaffolds.fa").write_text(ref["unassigned"])
    (tmp_path / "a.fa.k2.w3.n1.all.scaffolds.fa").write_text(ref["assigned"] + ref["unassigned"])
    assert check.compare(str(tmp_path), ref, words) == {
        "tsv_tokens": 1, "path_lines": 0, "scaffold_bytes": 1}
    os.remove(tmp_path / "out.k2.w3.n1.path")
    assert check.compare(str(tmp_path), ref, words)["path_lines"] == 2
