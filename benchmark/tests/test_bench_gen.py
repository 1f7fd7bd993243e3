"""The generator's properties for a seed."""
import json
import os

import numpy as np
import pytest

from njbench import gen
from njref.fasta import read_fasta

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(kind, name):
    with open(os.path.join(BENCH_DIR, kind, name + ".json"), encoding="utf-8") as fh:
        return json.load(fh)


def _n50(lengths):
    x = np.sort(np.asarray(lengths))[::-1]
    return int(x[np.searchsorted(np.cumsum(x), x.sum() / 2)])


@pytest.mark.parametrize("config,traffic,tol", [("celegans_2ref", "sr_draft", 0.03),
                                                ("human_chr1_2ref", "lr_draft", 0.10)])
def test_draft_lengths(config, traffic, tol):
    """The contig lengths' N50 lies within ``tol`` of the traffic's, at the
    configuration's genome size (only the layout: no sequence is made).  A
    long-read draft has ~85 contigs, so which few of the lengths fall off a
    chromosome's end moves its N50 more."""
    cfg, tr = _load("configs", config), _load("traffic", traffic)
    genome = np.zeros(sum(cfg["chromosomes"].values()), np.uint8)
    for seed in (1, 2**33 + 3):
        recs, summary = gen.draft(np.random.default_rng(seed), genome, cfg["chromosomes"], tr)
        assert abs(_n50(summary["contig_lengths"]) / tr["contig_n50_bp"] - 1) < tol
        assert min(summary["contig_lengths"]) >= tr["contig_min_bp"]
        assert abs(summary["reversed"] / summary["records"] - tr["reverse_share"]) < 0.1
        if config == "celegans_2ref":  # the count this draft gives
            assert 3800 < summary["records"] < 4200 and 7800 < len(summary["contig_lengths"]) < 8300
            assert abs(summary["scaffolds"] / summary["records"] - 0.2 * 0.98) < 0.03


def test_same_bytes_for_same_seed(tmp_path, tiny):
    cfg, tr = tiny
    digests = []
    for i, seed in enumerate((7, 7, 8)):
        out = tmp_path / str(i)
        out.mkdir()
        gen.generate(cfg, tr, seed, str(out))
        digests.append({p.name: p.read_bytes() for p in out.iterdir()})
    assert digests[0] == digests[1]
    assert digests[0]["target.fa"] != digests[2]["target.fa"]


def test_inputs_follow_the_model(tmp_path, tiny):
    """Repeat share, the N-run layout of the gapped reference, the gapless
    other one, the draft's gapped records and reversed share."""
    cfg, tr = tiny
    s = gen.generate(cfg, tr, 2**31 + 11, str(tmp_path))
    total = sum(cfg["chromosomes"].values())
    assert s["repeat_bases"] == round(cfg["repeats"]["share"] * total)
    ref1 = b"".join(seq for _, seq in read_fasta(str(tmp_path / "ref1.fa")))
    ref2 = b"".join(seq for _, seq in read_fasta(str(tmp_path / "ref2.fa")))
    assert len(ref1) == len(ref2) == total and b"N" not in ref2
    codes = np.frombuffer(ref1, np.uint8) == ord("N")
    want = np.zeros(total, bool)
    for a, b in s["n_runs"]["ref1.fa"]:
        want[a:b] = True
    assert (codes == want).all()
    assert want[:1000].all() and want[-1000:].all() and want[60000:65000].all()
    assert abs(int(want.sum()) - (2000 + 5000 + 3000)) <= 3000  # runs may overlap
    target = read_fasta(str(tmp_path / "target.fa"))
    gapped = sum(b"N" in seq for _, seq in target)
    assert gapped == s["scaffolds"] > 0
    assert len(target) == s["records"]
    # the two references differ by their SNPs: about 2e-3 of the bases
    diff = np.count_nonzero(np.frombuffer(ref1, np.uint8)[~want] != np.frombuffer(ref2, np.uint8)[~want])
    assert 0.001 < diff / total < 0.003


def test_repeats_are_copies(tiny):
    """Most bases sit in the families' copies at the configured share, and
    the unique part is random: a genome with repeats has more repeated
    32-mers than one without."""
    cfg, _ = tiny
    rng = np.random.default_rng(5)
    genome, rep = gen.repeat_genome(rng, 400_000, {**cfg["repeats"], "share": 0.45})
    assert rep == 180_000 and genome.max() < 4

    def dup_kmers(g):
        kmers = np.lib.stride_tricks.sliding_window_view(g, 16)[::4]
        packed = (kmers.astype(np.uint64) << (2 * np.arange(16, dtype=np.uint64))).sum(1)
        _, counts = np.unique(packed, return_counts=True)
        return int((counts > 1).sum())

    assert dup_kmers(genome) > 100 * max(1, dup_kmers(rng.integers(0, 4, 400_000, dtype=np.uint8)))
