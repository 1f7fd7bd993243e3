"""The benchmark's one input generator: a cell's FASTA files from its
configuration, its traffic mix and a seed.

A configuration (``configs/<name>.json``) states the genome (chromosome
lengths, the share of it in repeat families), each reference assembly (its
SNP rate, the shift of its chromosome bounds, its N runs) and the target's
error rate.  A traffic mix (``traffic/<name>.json``) states the target draft:
contig lengths (log-normal, by N50 and a minimum), the spacing of adjacent
contigs on the genome (below 0: they overlap), the share of records that are
scaffolds of several contigs joined by N runs, and the share reversed.  The
contig lengths are fixed quantiles, so every seed drafts the same set of
lengths, in another order; everything else comes from ``--seed``.
``Inputs`` writes them in a child process.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
from statistics import NormalDist

import numpy as np

from njbench import proc

LETTERS = np.frombuffer(b"ACGTN", dtype=np.uint8)
N_CODE = 4
LINE = 80  # bases a FASTA line


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *key]))


def repeat_genome(rng: np.random.Generator, length: int, rep: dict) -> tuple[np.ndarray, int]:
    """Random bases (codes 0-3) with ``rep["share"]`` of them in copies of
    ``rep["families"]`` random units (lengths uniform in ``unit_bp``), each
    family's copies diverged from its unit by substitutions at a rate drawn
    in ``divergence``, half of them reversed, spread between unique runs.
    Returns (genome, bases in copies)."""
    fams = int(rep["families"])
    unit = rng.integers(rep["unit_bp"][0], rep["unit_bp"][1] + 1, size=fams)
    div = rng.uniform(rep["divergence"][0], rep["divergence"][1], size=fams)
    cons_off = np.zeros(fams + 1, dtype=np.int64)
    np.cumsum(unit, out=cons_off[1:])
    cons = rng.integers(0, 4, size=int(cons_off[-1]), dtype=np.uint8)
    want = int(round(rep["share"] * length))
    guess = int(want / unit.mean() * 1.5) + 16
    fam = rng.integers(0, fams, size=guess)
    lens = unit[fam]
    count = int(np.searchsorted(np.cumsum(lens), want)) + 1
    fam, lens = fam[:count], lens[:count]
    lens[-1] -= int(lens.sum()) - want  # the last copy ends at the share
    copy_at = np.zeros(count, dtype=np.int64)
    np.cumsum(lens[:-1], out=copy_at[1:])
    offset = np.arange(want, dtype=np.int64) - np.repeat(copy_at, lens)
    rev = np.repeat(rng.random(count) < 0.5, lens)
    first = np.repeat(cons_off[fam], lens)
    last = np.repeat(cons_off[fam] + lens - 1, lens)
    bases = cons[np.where(rev, last - offset, first + offset)]
    bases[rev] = 3 - bases[rev]
    hit = np.flatnonzero(rng.random(want, dtype=np.float32) < np.repeat(div[fam], lens))
    bases[hit] = (bases[hit] + rng.integers(1, 4, size=hit.shape[0], dtype=np.uint8)) % 4
    # copy i goes after the cut[i]-th unique base
    cut = np.sort(rng.integers(0, length - want + 1, size=count))
    in_copy = np.repeat(cut + copy_at, lens) + offset
    genome = np.empty(length, dtype=np.uint8)
    genome[in_copy] = bases
    unique = np.ones(length, dtype=bool)
    unique[in_copy] = False
    genome[unique] = rng.integers(0, 4, size=length - want, dtype=np.uint8)
    return genome, want


def substitute(rng: np.random.Generator, seq: np.ndarray, rate: float) -> np.ndarray:
    """A copy of ``seq`` with ``round(rate * len)`` substitutions."""
    out = seq.copy()
    at = rng.integers(0, seq.shape[0], size=int(round(rate * seq.shape[0])))
    out[at] = (out[at] + rng.integers(1, 4, size=at.shape[0], dtype=np.uint8)) % 4
    return out


def n_runs(rng: np.random.Generator, length: int, spec: dict) -> list[tuple[int, int]]:
    """(start, end) of the N runs ``spec`` lays out: ``ends_bp`` at each
    end, each ``blocks`` entry (start, length), and runs of ``scattered_run_bp``
    totalling ``scattered_bp`` at random starts."""
    ends = int(spec.get("ends_bp", 0))
    runs = [(0, ends), (length - ends, length)] if ends else []
    runs += [(int(a), int(a) + int(n)) for a, n in spec.get("blocks", [])]
    left = int(spec.get("scattered_bp", 0))
    lo, hi = spec.get("scattered_run_bp", [0, 0])
    while left > 0:
        n = min(left, int(rng.integers(lo, hi + 1)))
        a = int(rng.integers(0, length - n))
        runs.append((a, a + n))
        left -= n
    return sorted(runs)


def chrom_bounds(chroms: dict, shift: int = 0) -> np.ndarray:
    """Record bounds on the genome: the chromosome bounds, the inner ones
    moved by ``shift`` bases."""
    bounds = np.zeros(len(chroms) + 1, dtype=np.int64)
    np.cumsum(list(chroms.values()), out=bounds[1:])
    bounds[1:-1] = np.clip(bounds[1:-1] + shift, 1, bounds[-1] - 1)
    return bounds


def contig_lengths(traffic: dict, total: int) -> np.ndarray:
    """Log-normal lengths whose length-weighted median (N50) is
    ``contig_n50_bp``, none under ``contig_min_bp``: the distribution's
    quantiles at evenly spaced levels, as many as cover ``total`` bases and
    a tenth more.  The same for every seed."""
    sigma = float(traffic["length_sigma"])
    mu = math.log(traffic["contig_n50_bp"]) - sigma * sigma
    unit = NormalDist()
    p0 = unit.cdf((math.log(traffic["contig_min_bp"]) - mu) / sigma)

    def quantiles(m: int) -> np.ndarray:
        p = p0 + (1 - p0) * (np.arange(m) + 0.5) / m
        return np.exp(mu + sigma * np.array([unit.inv_cdf(x) for x in p])).astype(np.int64)

    m = 64
    while quantiles(m).sum() < 1.1 * total:
        m *= 2
    lo, hi = m // 2, m
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if quantiles(mid).sum() < 1.1 * total else (lo, mid)
    return quantiles(hi)


def draft(rng: np.random.Generator, genome: np.ndarray, chroms: dict, traffic: dict):
    """The target's records: (name, codes) in file order, and a summary."""
    bounds = chrom_bounds(chroms)
    lengths = rng.permutation(contig_lengths(traffic, genome.shape[0]))
    lo_gap, hi_gap = traffic["contig_spacing_bp"]
    contigs = []  # (chromosome, start, end) in genome order
    li = 0
    for c in range(len(chroms)):
        pos, end_c = int(bounds[c]), int(bounds[c + 1])
        while end_c - pos >= traffic["contig_min_bp"]:
            end = min(pos + int(lengths[li % lengths.shape[0]]), end_c)
            li += 1
            if end_c - end < traffic["contig_min_bp"]:
                end = end_c  # no tail shorter than a contig may be
            contigs.append((c, pos, end))
            pos = max(pos + 1, end + int(rng.integers(lo_gap, hi_gap + 1)))
    records, i = [], 0
    n_scaffolds = 0
    k_lo, k_hi = traffic.get("scaffold_contigs", [1, 1])
    g_lo, g_hi = traffic.get("scaffold_gap_bp", [0, 0])
    while i < len(contigs):
        m = 1
        if rng.random() < traffic["scaffold_share"]:
            m = int(rng.integers(k_lo, k_hi + 1))
        group = [contigs[i]]
        while len(group) < m and i + len(group) < len(contigs) \
                and contigs[i + len(group)][0] == contigs[i][0]:
            group.append(contigs[i + len(group)])
        parts = []
        for j, (_, a, b) in enumerate(group):
            if j:
                parts.append(np.full(int(rng.integers(g_lo, g_hi + 1)), N_CODE, np.uint8))
            parts.append(genome[a:b])
        n_scaffolds += len(group) > 1
        records.append(np.concatenate(parts) if len(parts) > 1 else parts[0])
        i += len(group)
    rev = rng.random(len(records)) < traffic["reverse_share"]
    order = rng.permutation(len(records))
    out = []
    for j, r in enumerate(order):
        seq = records[r]
        if rev[r]:
            seq = np.where(seq < 4, 3 - seq, seq)[::-1]
        out.append((f"tig{j:06d}", seq))
    summary = {"contig_lengths": [b - a for _, a, b in contigs], "records": len(records),
               "scaffolds": n_scaffolds, "reversed": int(rev.sum())}
    return out, summary


def write_fasta(path: str, records: list[tuple[str, np.ndarray]]) -> int:
    """FASTA of lines of 80 bases; returns the bases written."""
    total = 0
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(b">" + name.encode() + b"\n")
            seq = LETTERS[codes]
            full = seq.shape[0] // LINE
            rows = np.empty((full, LINE + 1), dtype=np.uint8)
            rows[:, :LINE] = seq[: full * LINE].reshape(full, LINE)
            rows[:, LINE] = ord("\n")
            fh.write(rows.tobytes())
            if seq.shape[0] > full * LINE:
                fh.write(seq[full * LINE:].tobytes() + b"\n")
            total += seq.shape[0]
    return total


def generate(config: dict, traffic: dict, seed: int, out_dir: str) -> dict:
    """Write the cell's assemblies into ``out_dir``; returns the summary:
    each file's records and bases, the repeat bases, the N runs, the
    draft's contigs."""
    chroms = config["chromosomes"]
    total = int(sum(chroms.values()))
    genome, repeat_bases = repeat_genome(_rng(seed, 0), total, config["repeats"])
    files, runs = {}, {}
    for r, ref in enumerate(config["references"]):
        rng = _rng(seed, 1, r)
        seq = substitute(rng, genome, ref["snp_rate"])
        if "n_runs" in ref:
            runs[ref["file"]] = n_runs(rng, total, ref["n_runs"])
            for a, b in runs[ref["file"]]:
                seq[a:b] = N_CODE
        bounds = chrom_bounds(chroms, int(ref.get("bounds_shift_bp", 0)))
        recs = [(name, seq[bounds[i]:bounds[i + 1]]) for i, name in enumerate(chroms)]
        bases = write_fasta(os.path.join(out_dir, ref["file"]), recs)
        files[ref["file"]] = {"records": len(recs), "bases": bases}
        del seq, recs
    rng = _rng(seed, 2)
    target = substitute(rng, genome, config["target"]["error_rate"])
    del genome
    recs, summary = draft(rng, target, chroms, traffic)
    name = config["target"]["file"]
    files[name] = {"records": len(recs), "bases": write_fasta(os.path.join(out_dir, name), recs)}
    return {"files": files, "genome_bases": total, "repeat_bases": repeat_bases,
            "n_runs": runs, "target": name, "references": [r["file"] for r in config["references"]],
            **summary}


class Inputs:
    """The cell's inputs, written from the seed by a child that starts at
    once, in a fresh directory under ``TMPDIR``; ``close`` ends the child
    where it still runs and removes the directory."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.work = tempfile.mkdtemp(prefix="njbench-")
        self.dir = os.path.join(self.work, "inputs")
        os.makedirs(self.dir)
        self.child = proc.Child(lambda: generate(config, traffic, seed, self.dir))

    def close(self) -> None:
        self.child.stop()
        shutil.rmtree(self.work, ignore_errors=True)
