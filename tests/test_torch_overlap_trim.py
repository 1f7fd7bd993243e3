"""The overlap trim's sketch of the two ends it keeps (``segment_piece``,
``sketch_segment_ends``) against the sketch of the whole masked segment
(``sketch_segment``), which the trim computed before: the same minimizers
in the same order at the same positions, the same cut points, the same
``segments.fa`` where ``keep_segments_fa`` keeps it, and the counter
``trim_sketch_bases``."""
import copy

import numpy as np
import pytest

from ntjoin_tpu_torch.core import overlap_trim as ot
from ntjoin_tpu_torch.core.config import ScaffoldConfig
from ntjoin_tpu_torch.core.pathnode import PathNode
from ntjoin_tpu_torch.core.scaffolder import Scaffolder
from ntjoin_tpu_torch.io.fasta import FastaStore, reverse_complement
from ntjoin_tpu_torch.utils import timers

K, W = 15, 10  # ScaffoldConfig's overlap_k, overlap_w
_RC = str.maketrans("ACGTacgt", "TGCAtgca")


def _seq(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _masked(store, node: PathNode, lo: int, hi: int) -> str:
    """The masked segment as the trim built it from the whole segment."""
    seq = store.subseq(node.contig, node.start, node.end)
    if node.ori == "-":
        seq = reverse_complement(seq)
    core = (seq + "N" * node.gap_size)[: node.aligned_length]
    return core[:lo] + "N" * (hi - lo) + core[hi:]


def _both_ways(store, nodes: list[PathNode], k: int = K, w: int = W):
    """Each node's (mxs, infos) from the masked segment and from its ends;
    asserts the ends are the masked segment's bytes."""
    coords = ot.valid_mask_coords(nodes, k, w)
    whole, ends = ({}, {}), ({}, {})
    for ct, (node, (lo, hi)) in enumerate(zip(nodes, coords)):
        masked = _masked(store, node, lo, hi)
        head = ot.segment_piece(store, node, 0, lo)
        tail = ot.segment_piece(store, node, hi, node.aligned_length)
        assert head + "N" * (hi - lo) + tail == masked
        whole[0][ct], whole[1][ct] = ot.sketch_segment(masked, ct, nodes, k, w)
        ends[0][ct], ends[1][ct] = ot.sketch_segment_ends(head, tail, lo, hi, ct, nodes, k, w)
    return coords, whole, ends


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Contigs with lowercase runs and natural Ns near both ends."""
    rng = np.random.default_rng(20)
    a = _seq(rng, 3000)
    a = a[:40] + "NNNN" + a[44:100] + a[100:160].lower() + a[160:2900] + "N" * 7 + a[2907:]
    b = _seq(rng, 2000)
    b = b[:1950].lower() + b[1950:]
    c = _seq(rng, 20)
    path = tmp_path_factory.mktemp("trim") / "t.fa"
    path.write_text(f">a\n{a}\n>b\n{b}\n>c\n{c}\n")
    st = FastaStore(str(path))
    yield st
    st.close()


def _node(contig, ori, start, end, raw, gap=0, size=3000):
    return PathNode(contig, ori, start, end, size, 0, 0, gap_size=gap, raw_gap_size=raw)


# A three-node path for each case; the middle node is the one the case names.
_CASES = {
    f"{ori}-{side}": (ori, side) for ori in "+-" for side in ("left", "right", "both", "neither")
}


def _case_path(ori: str, side: str) -> list[PathNode]:
    left = -300 if side in ("left", "both") else 25
    right = -250 if side in ("right", "both") else 30
    return [_node("b", "+", 100, 1900, left, gap=25, size=2000),
            _node("a", ori, 20, 2990, right, gap=30),
            _node("b", "-", 0, 1990, 0, size=2000)]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ends_sketch_as_the_masked_segment(store, case):
    ori, side = _CASES[case]
    nodes = _case_path(ori, side)
    coords, whole, ends = _both_ways(store, nodes)
    assert ends == whole
    lo, hi = coords[1]
    assert (lo > 0) == (side in ("left", "both"))
    assert (hi < nodes[1].aligned_length) == (side in ("right", "both"))
    if side != "neither":
        assert whole[0][1]  # the kept ends gave minimizers


@pytest.mark.parametrize("ori", "+-")
def test_ends_that_meet(store, ori):
    """``hi == lo``: nothing is masked, and the node is all ends."""
    nodes = [_node("a", "+", 0, 500, -40), _node("a", ori, 1000, 1100, -35),
             _node("b", "+", 0, 400, 0, size=2000)]
    coords, whole, ends = _both_ways(store, nodes)
    assert coords[1][0] == coords[1][1] and ends == whole and whole[0][1]


@pytest.mark.parametrize("ori", "+-")
def test_ends_shorter_than_k_plus_w(store, ori):
    """Short nodes, whose ends hold fewer than ``w`` valid k-mers: no
    minimizer either way."""
    nodes = [_node("a", "+", 0, 500, -3), _node("a", ori, 1000, 1020, -2),
             _node("a", ori, 2000, 2022, 0), _node("c", ori, 0, 20, 0, size=20)]
    coords, whole, ends = _both_ways(store, nodes)
    assert ends == whole
    assert whole[0][1] == [] and whole[0][2] == []


@pytest.mark.parametrize("ori", "+-")
def test_natural_ns_and_lowercase_in_the_ends(store, ori):
    """Ends that hold the contig's own N runs and lowercase bases."""
    nodes = [_node("b", "+", 0, 1000, -200, size=2000), _node("a", ori, 0, 3000, -180),
             _node("b", "+", 1000, 2000, 0, size=2000)]
    coords, whole, ends = _both_ways(store, nodes)
    assert ends == whole and whole[0][1]
    lo, hi = coords[1]
    ends_text = _masked(store, nodes[1], lo, hi)
    assert "NNNN" in ends_text[:lo] + ends_text[hi:] and any(c.islower() for c in ends_text)


@pytest.mark.parametrize("ori", "+-")
def test_node_past_its_contig(store, ori):
    """A node whose ``end`` lies past its contig: ``subseq`` clamps it, and
    the gap Ns fill the segment's frame."""
    nodes = [_node("a", "+", 0, 600, -100, gap=0), _node("b", ori, 1700, 2100, -60, gap=150,
                                                           size=2000),
             _node("a", "+", 100, 900, 0)]
    coords, whole, ends = _both_ways(store, nodes)
    assert ends == whole and whole[0][1]
    assert len(_masked(store, nodes[1], *coords[1])) == nodes[1].aligned_length


def _overlapping_draft(rng, n_pieces: int):
    """A genome cut into pieces that overlap their neighbours, some stored
    reversed: the contigs' text and one path through them."""
    genome = _seq(rng, 1500 * n_pieces + 500)
    contigs, nodes, b = {}, [], 0
    for i in range(n_pieces):
        ln = int(rng.integers(300, 2500))
        ov = int(rng.integers(30, 300)) if i < n_pieces - 1 else 0
        text = genome[b : b + ln + ov]
        ori = "-" if rng.random() < 0.4 else "+"
        if ori == "-":
            text = text[::-1].translate(_RC)
        if rng.random() < 0.3:
            j = int(rng.integers(0, len(text) - 10))
            text = text[:j] + "N" * int(rng.integers(1, 10)) + text[j + 10 :][: len(text) - j - 10]
            text = text[: ln + ov]
        contigs[f"p{i}"] = text
        nodes.append(PathNode(f"p{i}", ori, 0, len(text), len(text), 0, 0,
                              gap_size=int(rng.integers(0, 40)), raw_gap_size=-ov))
        b += ln
    return contigs, nodes


def test_random_paths_cut_at_the_same_points(tmp_path):
    """Over seeded random drafts: the same sketch either way and the same
    ``start_adjust``/``end_adjust`` from ``trim_overlapping_path``."""
    rng = np.random.default_rng(77)
    cut = 0
    for trial in range(12):
        contigs, nodes = _overlapping_draft(rng, int(rng.integers(2, 7)))
        path = tmp_path / f"d{trial}.fa"
        path.write_text("".join(f">{n}\n{t}\n" for n, t in contigs.items()))
        st = FastaStore(str(path))
        try:
            _, whole, ends = _both_ways(st, nodes)
        finally:
            st.close()
        assert ends == whole
        got = []
        for mxs, infos in (whole, ends):
            trimmed = copy.deepcopy(nodes)
            ot.trim_overlapping_path(trimmed, mxs, infos)
            got.append([(n.start_adjust, n.end_adjust) for n in trimmed])
        assert got[0] == got[1]
        cut += sum(a != 0 or b != 0 for a, b in got[0])
    assert cut > 10


def _scaffolder(tmp_path, store_path, keep: bool) -> Scaffolder:
    cfg = ScaffoldConfig(target="t.tsv", references=["r.tsv"], reference_weights=[2.0],
                         prefix=str(tmp_path / "out"), overlap=True, keep_segments_fa=keep,
                         verbose=False)
    s = Scaffolder(cfg, device="cpu")
    s.scaffolds = FastaStore(store_path)
    return s


@pytest.mark.parametrize("keep", [False, True])
def test_trim_counts_the_bases_it_sketches(store, tmp_path, keep):
    """``trim_sketch_bases`` is the bases of the kept ends; ``segments.fa``
    is written only where it is kept, as the masked segments."""
    paths = [[_node("a", "+", 0, 1500, -120), _node("b", "-", 0, 2000, -90, size=2000),
              _node("a", "-", 1500, 3000, 0)],
             [_node("a", "+", 0, 3000, 0), _node("b", "+", 0, 2000, 0, size=2000)],
             [_node("c", "+", 0, 20, 0, size=20)]]
    s = _scaffolder(tmp_path, store._path, keep)
    want = 0
    records = []
    for nodes in paths[:2]:
        for node, (lo, hi) in zip(nodes, ot.valid_mask_coords(nodes, K, W)):
            masked = _masked(store, node, lo, hi)
            want += node.aligned_length - (hi - lo)
            records.append(f">{node.contig}_{node.start}_{node.end} {node.raw_gap_size}\n"
                           f"{masked}\n")
    try:
        with timers.recording(True):
            s._trim_overlaps(copy.deepcopy(paths))
            got = dict(timers.COUNTERS)
    finally:
        s.scaffolds.close()
    assert got["trim_sketch_bases"] == want
    assert 0 < want < sum(n.aligned_length for n in paths[0]) // 4
    seg = tmp_path / "out.segments.fa"
    assert seg.exists() == keep
    if keep:
        assert seg.read_text() == "".join(records)

