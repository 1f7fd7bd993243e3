"""The ``celegans_5ref`` configuration and the ``celegans_2ref.lr_draft``
cell: the three readers of the filters, the index and the uniqueness
filter on planted ``trace_counts`` lines, the five references the
generator writes, and the long-read draft's contig count at full size."""
import json
import os
import sys

import numpy as np
import pytest

from njbench import gen, harness
from njref.fasta import read_fasta

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(kind, name):
    with open(os.path.join(BENCH_DIR, kind, name + ".json"), encoding="utf-8") as fh:
        return json.load(fh)


def _job(spans, counters):
    return {"trace_counts": {"spans": {name: {"n": 1, "s": s, "self_s": s, "parent": None}
                                       for name, s in spans.items()},
                             "counters": counters}}


SPANS = {"unique:ref1.fa": 0.2, "unique:ref2.fa": 0.3, "unique:target.fa": 0.1,
         "scaffold/index": 0.5, "scaffold/graph": 0.4, "scaffold/graph/filter": 0.01,
         "scaffold/paths/branch": 0.03, "sketch:ref1.fa/unique": 9.0}
COUNTERS = {"minimizers": 1_000_000, "graph_edges": 400_000}


@pytest.mark.parametrize("name,want,missing", [
    ("unique_s", 0.6, "unique:"),
    ("scaffold_index_s", 0.5, "scaffold/index"),
    ("scaffold_filter_ns_per_edge", 100.0, "scaffold/paths/branch"),
])
def test_readers_on_planted_lines(name, want, missing):
    """Each reader's number from two planted jobs (the median of 1x and
    3x the spans), and None where no job has the spans it reads or the
    counter it divides by."""
    read = harness.load_reader(name)
    jobs = [_job(SPANS, COUNTERS), _job({k: 3 * s for k, s in SPANS.items()}, COUNTERS)]
    assert read({"jobs": jobs}) == pytest.approx(2 * want)
    bare = {k: s for k, s in SPANS.items() if not k.startswith(missing)
            and not (name == "scaffold_filter_ns_per_edge" and k == "scaffold/graph/filter")}
    assert read({"jobs": [_job(bare, COUNTERS)]}) is None
    assert read({"jobs": [{"rc": 0}]}) is None
    if name == "scaffold_filter_ns_per_edge":
        assert read({"jobs": [_job(SPANS, {k: v for k, v in COUNTERS.items()
                                            if k != "graph_edges"})]}) is None


def test_filter_rate_reads_either_filter():
    """A job whose global filter returned at once (``n`` at most the least
    weight) still has both spans; with the branch span alone the rate is
    that span's."""
    read = harness.load_reader("scaffold_filter_ns_per_edge")
    only = {k: s for k, s in SPANS.items() if k != "scaffold/graph/filter"}
    assert read({"jobs": [_job(only, COUNTERS)]}) == pytest.approx(75.0)


def test_five_references_follow_the_model(tmp_path):
    """``celegans_5ref`` at 1/500 of its genome (chromosomes, bound shifts
    and N runs scaled alike): five references of six records each, each
    record where its shifted bounds put it, N runs only in ref3 and ref5
    and where the generator says, the SNP rates as stated."""
    cfg = _load("configs", "celegans_5ref")
    assert cfg["words"]["reference_weights"] == "2 2 1 1 1" and cfg["words"]["n"] == "2"
    assert cfg["reduced"] == {}
    scale = 500
    cfg["chromosomes"] = {k: v // scale for k, v in cfg["chromosomes"].items()}
    for ref in cfg["references"]:
        ref["bounds_shift_bp"] //= scale
        if "n_runs" in ref:
            runs = ref["n_runs"]
            runs["scattered_bp"] //= scale
            runs["scattered_run_bp"] = [x // scale for x in runs["scattered_run_bp"]]
    summary = gen.generate(cfg, _load("traffic", "sr_draft"), 2**33 + 19, str(tmp_path))
    assert summary["references"] == ["ref1.fa", "ref2.fa", "ref3.fa", "ref4.fa", "ref5.fa"]
    total = sum(cfg["chromosomes"].values())
    seqs = {}
    for ref in cfg["references"]:
        records = read_fasta(str(tmp_path / ref["file"]))
        assert [name for name, _ in records] == list(cfg["chromosomes"])
        bounds = gen.chrom_bounds(cfg["chromosomes"], ref["bounds_shift_bp"])
        assert [len(seq) for _, seq in records] == np.diff(bounds).tolist()
        seqs[ref["file"]] = np.frombuffer(b"".join(seq for _, seq in records), np.uint8)
        n_mask = seqs[ref["file"]] == ord("N")
        want = np.zeros(total, bool)
        for a, b in summary["n_runs"].get(ref["file"], []):
            want[a:b] = True
        assert (n_mask == want).all()
        if "n_runs" in ref:
            assert 0 < int(want.sum()) <= ref["n_runs"]["scattered_bp"]
    assert summary["n_runs"]["ref3.fa"] != summary["n_runs"]["ref5.fa"]
    clear = np.ones(total, bool)
    for runs in summary["n_runs"].values():
        for a, b in runs:
            clear[a:b] = False
    for fa, rate in (("ref2.fa", 0.001), ("ref3.fa", 0.003), ("ref4.fa", 0.003),
                     ("ref5.fa", 0.003)):
        diff = np.count_nonzero(seqs[fa][clear] != seqs["ref1.fa"][clear]) / clear.sum()
        assert 0.7 * (rate + 0.001) < diff < 1.1 * (rate + 0.001), fa


def test_five_reference_cell_shares_the_two_reference_inputs(tmp_path):
    """For one seed the 5-ref configuration writes the 2-ref one's ref1,
    ref2 and target byte for byte (the same genome, reference models and
    traffic), so that the two cells differ by the three weight-1
    references and ``n`` alone.  At 1/500 of the genome."""
    got = {}
    for name in ("celegans_2ref", "celegans_5ref"):
        cfg = _load("configs", name)
        cfg["chromosomes"] = {k: v // 500 for k, v in cfg["chromosomes"].items()}
        for ref in cfg["references"]:
            ref["bounds_shift_bp"] //= 500
            ref.pop("n_runs", None)
        out = tmp_path / name
        out.mkdir()
        gen.generate(cfg, _load("traffic", "sr_draft"), 2**31 + 77, str(out))
        got[name] = {fa: (out / fa).read_bytes() for fa in ("ref1.fa", "ref2.fa", "target.fa")}
    assert got["celegans_2ref"] == got["celegans_5ref"]


def test_long_read_draft_on_celegans():
    """``lr_draft`` on the whole ``celegans_2ref`` genome (the layout only):
    34-50 contigs over 200 seeds, so 33-50 here, none under the traffic's
    minimum, no gapped record."""
    cfg, tr = _load("configs", "celegans_2ref"), _load("traffic", "lr_draft")
    genome = np.zeros(sum(cfg["chromosomes"].values()), np.uint8)
    for seed in (1, 2**31 + 5, 2**33 + 3):
        _, summary = gen.draft(np.random.default_rng(seed), genome, cfg["chromosomes"], tr)
        assert 33 <= summary["records"] == len(summary["contig_lengths"]) <= 50
        assert min(summary["contig_lengths"]) >= tr["contig_min_bp"]
        assert summary["scaffolds"] == 0


READERS = ("unique_s", "scaffold_index_s", "scaffold_filter_ns_per_edge")


def _five_reference_cell(seed: int) -> dict:
    """A traced run of the tiny cell with five references weighted
    ``2 2 1 1 1`` at ``n=2`` (the third reference gapped, the fourth's
    bounds shifted back) through the port's ``backend=torch device=cpu``:
    each job's verdict, the run's words, the three readers' numbers and the
    ``unique:<fa>`` spans of the first job."""
    import copy
    import time

    from conftest import CPU_WORDS, TINY_CONFIG, TINY_TRAFFIC

    cfg, tr = copy.deepcopy(TINY_CONFIG), copy.deepcopy(TINY_TRAFFIC)
    cfg["words"].update(reference_weights="2 2 1 1 1", n="2")
    cfg["references"] += [
        {"file": "ref3.fa", "snp_rate": 0.003, "bounds_shift_bp": 0,
         "n_runs": {"scattered_bp": 3000, "scattered_run_bp": [500, 1500]}},
        {"file": "ref4.fa", "snp_rate": 0.003, "bounds_shift_bp": -10000},
        {"file": "ref5.fa", "snp_rate": 0.003, "bounds_shift_bp": 0}]
    # the jobs print their count lines to the file behind fd 1, their log:
    # pytest's own capture of sys.stdout would keep them from it
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    try:
        run = harness.run_cell(cfg, tr, seed, 0.0, True, time.perf_counter(),
                               need_cuda=False, extra_words=CPU_WORDS)
    finally:
        sys.stdout, sys.stderr = saved
    return {"ok": [j["ok"] for j in run["jobs"]], "words": run["words"],
            "read": {name: harness.load_reader(name)(run) for name in READERS},
            "unique": [name for name in run["jobs"][0]["trace_counts"]["spans"]
                       if name.startswith("unique:")]}


def test_five_reference_cell_on_the_cpu():
    """The tiny five-reference cell at ``n=2`` through the harness: the job
    is correct against the plain reference and each of the three readers
    gives a number.  The run is made in a fresh interpreter: CUDA started
    in this process (by an earlier card test) breaks CUDA in a forked job."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        got = pool.apply(_five_reference_cell, (2**32 + 23,))
    assert got["ok"] and all(got["ok"])
    assert "reference_weights=2 2 1 1 1" in got["words"] and "n=2" in got["words"]
    for name in READERS:
        assert isinstance(got["read"][name], float) and got["read"][name] > 0, name
    assert len(got["unique"]) == 6
