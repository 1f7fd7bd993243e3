"""ntJoin's multi-reference mode in the port: five references weighted
``2 2 1 1 1``, a target weighted 1, ``n=2``.

The test writes six tiny assemblies of one seeded random genome.  The
weight-1 references disagree with the genome's order (one swaps the arms of
its two chromosomes, one reverses a segment), so the global weight filter
drops the edges they alone support; one weight-2 reference reverses a
segment too, so its junction edges pass the global filter and make branch
nodes that the escalating branch filter resolves.  The port's ``assemble``
(``backend=torch device=cpu``, both index backends) is held byte for byte
against the JAX package's (``ntjoin_tpu.cli``, its own host layers) and
against the benchmark's plain reference (``benchmark/njref``); its edges
after each filter against the JAX package's, and after the global filter
against a tally written here."""
import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

from ntjoin_tpu_torch import cli
from ntjoin_tpu_torch.core import scaffolder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))

from njref.pipeline import artifacts  # noqa: E402

K, W, N = 32, 200, 2
REFS = ["ref1.fa", "ref2.fa", "ref3.fa", "ref4.fa", "ref5.fa"]
WEIGHTS = {"ref1.fa": 2, "ref2.fa": 2, "ref3.fa": 1, "ref4.fa": 1, "ref5.fa": 1, "target.fa": 1}
WORDS = {"target": "target.fa", "references": " ".join(REFS), "reference_weights": "2 2 1 1 1",
         "target_weight": "1", "k": str(K), "w": str(W), "n": str(N), "g": "20", "G": "0",
         "overlap": "True", "mkt": "False"}
PREFIX = f"out.k{K}.w{W}.n{N}"
SCAFFOLDS = f"target.fa.k{K}.w{W}.n{N}"


def _write(path, records):
    with open(path, "w", encoding="ascii") as fh:
        for name, codes in records:
            fh.write(f">{name}\n{np.frombuffer(b'ACGT', np.uint8)[codes].tobytes().decode()}\n")


def _inputs(d):
    """Two chromosomes of 110 and 90 kbp; each assembly with its own SNPs."""
    rng = np.random.default_rng(20261018)
    c1 = rng.integers(0, 4, 110_000, dtype=np.uint8)
    c2 = rng.integers(0, 4, 90_000, dtype=np.uint8)

    def snps(seq, rate):
        out = seq.copy()
        at = rng.integers(0, seq.shape[0], int(rate * seq.shape[0]))
        out[at] = (out[at] + rng.integers(1, 4, at.shape[0], dtype=np.uint8)) % 4
        return out

    def invert(seq, a, b):
        return np.concatenate([seq[:a], (3 - seq[a:b])[::-1], seq[b:]])

    asm = {
        "ref1.fa": [("c1", snps(c1, 1e-3)), ("c2", snps(c2, 1e-3))],
        "ref2.fa": [("c1", snps(c1, 1e-3)), ("c2", invert(snps(c2, 1e-3), 20_000, 35_000))],
        "ref3.fa": [("c1", snps(np.concatenate([c1[:60_000], c2[45_000:]]), 3e-3)),
                    ("c2", snps(np.concatenate([c2[:45_000], c1[60_000:]]), 3e-3))],
        "ref4.fa": [("c1", invert(snps(c1, 3e-3), 30_000, 50_000)), ("c2", snps(c2, 3e-3))],
        "ref5.fa": [("c1", snps(c1, 3e-3)), ("c2", snps(c2, 3e-3))],
    }
    for name, records in asm.items():
        _write(d / name, records)
    contigs = []
    for chrom in (snps(c1, 1e-4), snps(c2, 1e-4)):
        pos = 0
        while pos < chrom.shape[0]:
            end = min(pos + int(rng.integers(4_000, 12_000)), chrom.shape[0])
            piece = chrom[pos:end]
            contigs.append((3 - piece)[::-1] if rng.random() < 0.3 else piece)
            pos = end + int(rng.integers(-100, 300))
    order = rng.permutation(len(contigs))
    _write(d / "target.fa", [(f"tig{i}", contigs[j]) for i, j in enumerate(order)])


def _assemble(main, module, d, words) -> dict:
    """``main(["assemble", ...])`` in ``d``, with ``module.find_paths``
    spied on: the graph as ``find_paths`` got it (after the global weight
    filter) and left it (after the branch filter), and what was printed."""
    seen, real = {}, module.find_paths

    def spy(graph, shared, n_min, *args, **kw):
        seen.update(graph=graph, shared=shared, kept=graph.alive.copy())
        out = real(graph, shared, n_min, *args, **kw)
        seen["after_branch"] = graph.alive.copy()
        return out

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(d)
        mp.setattr(module, "find_paths", spy)
        assert main(["assemble", "-B", *(f"{k}={v}" for k, v in WORDS.items()), *words]) == 0
    seen.update(dir=d, stdout=out.getvalue())
    return seen


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiref_inputs")
    _inputs(d)
    return d


def _copy_of(inputs, tmp_path_factory, name):
    d = tmp_path_factory.mktemp(name)
    for fa in WEIGHTS:
        shutil.copy(inputs / fa, d / fa)
    return d


@pytest.fixture(scope="module", params=["auto", "host"])
def job(request, inputs, tmp_path_factory):
    """One traced ``assemble`` of the port with each index backend
    (``auto`` runs the graph passes as torch ops on the CPU), and its
    ``trace_counts`` line."""
    d = _copy_of(inputs, tmp_path_factory, f"multiref_{request.param}")
    seen = _assemble(cli.main, scaffolder, d, ["backend=torch", "device=cpu",
                                               f"index_backend={request.param}", "time=True"])
    line = next(x for x in seen["stdout"].splitlines() if x.startswith("trace_counts\t"))
    seen["trace"] = json.loads(line.partition("\t")[2])
    return seen


@pytest.fixture(scope="module")
def jax_job(inputs, tmp_path_factory):
    """The same words through the JAX package's ``assemble`` (its NumPy
    sketcher and its own host index, graph, filters and paths)."""
    from ntjoin_tpu import cli as jax_cli
    from ntjoin_tpu.core import scaffolder as jax_scaffolder

    d = _copy_of(inputs, tmp_path_factory, "multiref_jax")
    return _assemble(jax_cli.main, jax_scaffolder, d, ["backend=numpy", "index_backend=host"])


@pytest.fixture(scope="module")
def reference(job):
    return artifacts(str(job["dir"]), WORDS, "cpu")


@pytest.mark.parametrize("part", [*REFS, "target.fa", "path", "assigned", "unassigned", "all"])
def test_artifacts_match_plain_reference(job, reference, part):
    """Each minimizer TSV, the ``.path`` and the scaffold FASTAs, byte for
    byte against ``njref.pipeline.artifacts`` of the same words."""
    d = job["dir"]
    if part in WEIGHTS:
        want = "".join(f"{name}\t{' '.join(toks)}\n" for name, toks in reference["tsv"][part])
        got = (d / f"{part}.k{K}.w{W}.tsv").read_text()
    elif part == "path":
        want, got = reference["path"], (d / f"{PREFIX}.path").read_text()
    else:
        want = reference["assigned"] + reference["unassigned"] if part == "all" \
            else reference[part]
        got = (d / f"{SCAFFOLDS}.{part}.scaffolds.fa").read_text()
    assert got == want
    if part == "path":
        assert want.count("\n") > 1  # some contigs were joined


ARTIFACTS = [*(f"{fa}.k{K}.w{W}.tsv" for fa in WEIGHTS), *(f"{fa}.fai" for fa in WEIGHTS),
             f"{PREFIX}.path", f"{PREFIX}.mx.dot", f"{PREFIX}.target.fa.k{K}.w{W}.tsv.unassigned.bed",
             *(f"{SCAFFOLDS}.{part}.scaffolds.fa" for part in ("assigned", "unassigned", "all"))]


def test_port_writes_the_jax_packages_artifacts(job, jax_job):
    """Beside its inputs, the port writes the files the JAX package writes,
    and no other (the ``time=True`` stage files aside)."""
    def made(d):
        return sorted(p.name for p in d.iterdir() if p.name not in WEIGHTS
                      and not p.name.endswith(".time"))

    assert made(jax_job["dir"]) == sorted(ARTIFACTS)
    assert made(job["dir"]) == sorted(ARTIFACTS)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifacts_match_jax_package(job, jax_job, name):
    """Each TSV, ``.fai``, the ``.path``, the ``.mx.dot``, the unassigned
    BED and the scaffold FASTAs, byte for byte against the JAX package's for the same words."""
    assert (job["dir"] / name).read_bytes() == (jax_job["dir"] / name).read_bytes()


def _edges(seen, stage: str) -> dict[frozenset, float]:
    """The edges alive at ``stage`` (``kept``: after the global weight
    filter; ``after_branch``: after the branch filter) as hash pairs and
    their weights."""
    g, node, alive = seen["graph"], seen["shared"].node_hash, seen[stage]
    return {frozenset((int(node[s]), int(node[t]))): float(wt)
            for s, t, wt in zip(g.src[alive], g.dst[alive], g.weight[alive])}


@pytest.mark.parametrize("stage", ["kept", "after_branch"])
def test_filtered_edges_match_jax_package(job, jax_job, stage):
    """After the global weight filter and after the escalating branch
    filter, the port's graph holds the JAX package's edges with their
    weights, out of the same graph."""
    assert job["graph"].src.shape[0] == jax_job["graph"].src.shape[0]
    assert _edges(job, stage) == _edges(jax_job, stage)


def _tally(d) -> dict[frozenset, int]:
    """Edge -> weight from the TSVs: minimizers that occur once in each
    assembly and in all of them; an edge joins two such that are adjacent
    in a record of an assembly, weighing the sum of the weights of the
    assemblies where they are; kept where that reaches ``N``."""
    streams = {}
    for fa, wt in WEIGHTS.items():
        records = []
        for line in (d / f"{fa}.k{K}.w{W}.tsv").read_text().splitlines():
            rest = line.partition("\t")[2]
            records.append([int(tok.split(":")[0]) for tok in rest.split()] if rest else [])
        streams[fa] = records
    shared = None
    for records in streams.values():
        seen, dup = set(), set()
        for h in (h for rec in records for h in rec):
            (dup if h in seen else seen).add(h)
        shared = (seen - dup) if shared is None else shared & (seen - dup)
    weight = {}
    for fa, records in streams.items():
        edges = set()
        for rec in records:
            nodes = [h for h in rec if h in shared]
            edges.update(frozenset(p) for p in zip(nodes, nodes[1:]))
        for e in edges:
            weight[e] = weight.get(e, 0) + WEIGHTS[fa]
    return {e: wt for e, wt in weight.items() if wt >= N}


def test_weight_filter_matches_tally(job):
    """The edges that pass the port's global weight filter, and their
    weights, are the tally's; the filter dropped some edges."""
    assert _edges(job, "kept") == _tally(job["dir"])
    assert 0 < int(job["kept"].sum()) < job["graph"].src.shape[0]


def test_branch_filter_drops_edges(job):
    """The weight-2 reference's inversion leaves branch nodes after the
    global filter; the escalating branch filter drops their weaker edges."""
    assert int(job["after_branch"].sum()) < int(job["kept"].sum())
    assert not (job["after_branch"] & ~job["kept"]).any()


def test_trace_counts_hold_the_filters(job):
    """``time=True`` records the two filters' spans, each once, in their
    stages, and ``graph_edges``: every edge before either filter."""
    spans, counters = job["trace"]["spans"], job["trace"]["counters"]
    assert spans["scaffold/graph/filter"]["n"] == 1
    assert spans["scaffold/graph/filter"]["parent"] == "scaffold/graph"
    assert spans["scaffold/paths/branch"]["n"] == 1
    assert spans["scaffold/paths/branch"]["parent"] == "scaffold/paths"
    assert counters["graph_edges"] == job["graph"].src.shape[0] > 0
