"""Overlap detection and trimming between adjacent joined segments.

When gap estimation yields a negative raw gap, the two flanking segments are
re-sketched at small (k, w), their overlap ends intersected, and a pairwise
mini minimizer-graph picks a cut minimizer; the cut positions become
``end_adjust``/``start_adjust`` on the two path nodes.  Reproduces reference
``ntjoin_overlap.py`` and the driving logic at
``ntjoin_assemble.py:468-516`` — including the as-implemented quirks that the
byte-equivalence contract depends on:

* ``get_dist_from_end`` always receives an integer segment index where an
  orientation string is expected, so it always returns ``-pos``
  (``ntjoin_overlap.py:53-58,145-149``),
* target-end validity is tested against the *source* node's raw gap
  (``ntjoin_overlap.py:126-129``),
* candidate ordering compares the middle minimizer as a decimal *string*
  (``ntjoin_overlap.py:78-79``), as does endpoint normalisation (:38-40).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ntjoin_tpu_torch.core.pathnode import PathNode
from ntjoin_tpu_torch.io.fasta import reverse_complement
from ntjoin_tpu_torch.io.native import sketch_seq_host as sketch_seq


def valid_mask_coords(nodes: list[PathNode], k: int, w: int) -> list[tuple[int, int]]:
    """Interior-masking coordinates per node (ref ``get_valid_regions:98-114``).

    Everything inside (l, r) is hard-masked before re-sketching so only the
    overlap ends (with a k+w margin) produce minimizers.
    """
    coords = []
    for i, node in enumerate(nodes):
        if i > 0 and nodes[i - 1].raw_gap_size < 0:
            l_coord = -nodes[i - 1].raw_gap_size + k + w
        else:
            l_coord = 0
        if node.raw_gap_size < 0:
            r_coord = node.aligned_length + node.raw_gap_size - k - w
        else:
            r_coord = node.aligned_length
        coords.append((l_coord, max(l_coord, r_coord)))
    return coords


def segment_piece(store, node: PathNode, a: int, b: int) -> str:
    """``core[a:b]`` of a node's trim segment, fetching only those bases:
    ``core`` is the node's oriented region (``store.subseq``'s clamped
    range, reverse-complemented for ``-``) followed by its ``gap_size`` Ns,
    cut to ``aligned_length``."""
    length = store.length(node.contig)
    start = max(0, min(node.start, length))
    end = max(start, min(node.end, length))
    m = end - start
    b = min(b, node.aligned_length)
    x, y = a, min(b, m)
    if x >= y:
        bases = ""
    elif node.ori == "-":
        bases = reverse_complement(store.subseq(node.contig, end - y, end - x))
    else:
        bases = store.subseq(node.contig, start + x, start + y)
    return bases + "N" * max(0, min(b, m + node.gap_size) - max(a, m))


def _in_valid_region(pos: int, index: int, nodes: list[PathNode]) -> bool:
    """ref ``is_in_valid_region:90-96``"""
    if index > 0 and pos < -nodes[index - 1].raw_gap_size:
        return True
    return pos >= nodes[index].aligned_length + nodes[index].raw_gap_size


def _keep(
    hashes: list[int], positions: list[int], index: int, nodes: list[PathNode]
) -> tuple[list[int], dict[int, int]]:
    """In-valid-region, non-duplicate minimizers: (ordered mx list,
    mx -> position); semantics of reference
    ``tally_minimizers_overlap:501-516``."""
    order: list[int] = []
    info: dict[int, int] = {}
    dups: set[int] = set()
    for h, pos in zip(hashes, positions):
        if not _in_valid_region(pos, index, nodes):
            continue
        if h in info:
            dups.add(h)
        else:
            info[h] = pos
            order.append(h)
    if dups:
        info = {h: p for h, p in info.items() if h not in dups}
        order = [h for h in order if h not in dups]
    return order, info


def sketch_segment(
    seq: str, index: int, nodes: list[PathNode], k: int, w: int
) -> tuple[list[int], dict[int, int]]:
    """Sketch one masked segment; keep in-valid-region, non-duplicate mx.

    Returns (ordered mx list, mx -> position).
    """
    sk = sketch_seq(seq, k, w)
    return _keep(sk.hashes.tolist(), sk.positions.tolist(), index, nodes)


def sketch_segment_ends(
    head: str, tail: str, lo: int, hi: int, index: int, nodes: list[PathNode], k: int, w: int
) -> tuple[list[int], dict[int, int]]:
    """``sketch_segment`` of the masked segment ``head + "N" * (hi - lo) +
    tail`` (``head`` its bases before ``lo``, ``tail`` those from ``hi``),
    sketching only the two ends.

    The sketch's windows slide over valid k-mers and step over any k-mer
    that covers an N, so one N in place of the run gives the same hashes in
    the same order; a position past ``lo`` in the short string lies
    ``hi - lo - 1`` further on in the masked one.
    """
    masked = int(hi > lo)  # hi == lo: nothing masked, the ends are the segment
    sk = sketch_seq(head + "N" * masked + tail, k, w)
    pos = np.where(sk.positions > lo, sk.positions + (hi - lo - masked), sk.positions)
    return _keep(sk.hashes.tolist(), pos.tolist(), index, nodes)


@dataclass
class _Candidate:
    mapped_region_length: float
    mid_mx: int
    median_length_from_end: float

    def sort_key(self):
        # mid_mx compared as decimal string, replicating the reference
        return (self.mapped_region_length, self.median_length_from_end, str(self.mid_mx))


def _mini_graph_components(src_list, tgt_list):
    """Pairwise mini graph: adjacency supported by BOTH segments.

    Equivalent to reference build_graph with weights {1,1} followed by a
    global weight>=2 filter (``ntjoin_overlap.py:27-29``): an edge survives
    iff the unordered pair is consecutive in both lists.
    """
    pair_count: dict[tuple[int, int], int] = {}
    for lst in (src_list, tgt_list):
        for a, b in zip(lst, lst[1:]):
            key = (a, b) if a <= b else (b, a)
            pair_count[key] = pair_count.get(key, 0) + 1
    adj: dict[int, list[int]] = {mx: [] for mx in src_list}
    for mx in tgt_list:
        adj.setdefault(mx, [])
    for (a, b), cnt in pair_count.items():
        if cnt >= 2 and a != b:
            adj[a].append(b)
            adj[b].append(a)
    # connected components via BFS
    seen: set[int] = set()
    comps: list[list[int]] = []
    for mx in adj:
        if mx in seen:
            continue
        comp = [mx]
        seen.add(mx)
        q = deque([mx])
        while q:
            cur = q.popleft()
            for nbr in adj[cur]:
                if nbr not in seen:
                    seen.add(nbr)
                    comp.append(nbr)
                    q.append(nbr)
        comps.append(comp)
    return adj, comps


def _bfs_path(adj, s, t):
    parent = {s: s}
    q = deque([s])
    while q:
        cur = q.popleft()
        if cur == t:
            break
        for nbr in adj[cur]:
            if nbr not in parent:
                parent[nbr] = cur
                q.append(nbr)
    path = [t]
    while path[-1] != s:
        path.append(parent[path[-1]])
    return path[::-1]


def merge_overlapping_pair(
    mxs: dict[int, list[int]],
    infos: dict[int, dict[int, int]],
    source: int,
    target: int,
    nodes: list[PathNode],
) -> bool:
    """Pick cut points for one overlapping junction (ref ``merge_overlapping:20-88``)."""
    src_info, tgt_info = infos[source], infos[target]
    raw = nodes[source].raw_gap_size

    # end-validity filter; both ends keyed off the source node's raw gap (quirk)
    src_list = [
        mx
        for mx in mxs[source]
        if src_info[mx] >= nodes[source].aligned_length + raw
    ]
    tgt_list = [mx for mx in mxs[target] if tgt_info[mx] < -raw]
    # intersection across the two segments
    shared = set(src_list) & set(tgt_list)
    src_list = [mx for mx in src_list if mx in shared]
    tgt_list = [mx for mx in tgt_list if mx in shared]

    adj, comps = _mini_graph_components(src_list, tgt_list)
    candidates: list[_Candidate] = []
    for comp in comps:
        ends = [mx for mx in comp if len(adj[mx]) == 1]
        singles = [mx for mx in comp if len(adj[mx]) == 0]
        if len(ends) == 2:
            a, b = ends
            if str(a) > str(b):
                a, b = b, a
            path = _bfs_path(adj, a, b)
            start_mx, end_mx = path[0], path[-1]
            src_align = abs(src_info[start_mx] - src_info[end_mx])
            tgt_align = abs(tgt_info[start_mx] - tgt_info[end_mx])
            mid = path[len(path) // 2]
            candidates.append(
                _Candidate(
                    mapped_region_length=(src_align + tgt_align) / 2.0,
                    mid_mx=mid,
                    median_length_from_end=(-src_info[mid] + -tgt_info[mid]) / 2.0,
                )
            )
        elif singles:
            assert len(singles) == 1
            mid = singles[0]
            candidates.append(
                _Candidate(
                    mapped_region_length=1.0,
                    mid_mx=mid,
                    median_length_from_end=(-src_info[mid] + -tgt_info[mid]) / 2.0,
                )
            )
        else:
            print(f"NOTE: non-singleton, {len(ends)} source nodes")
    if not candidates:
        return False
    best = sorted(candidates, key=_Candidate.sort_key, reverse=True)[0]
    nodes[source].end_adjust = src_info[best.mid_mx]
    nodes[target].start_adjust = tgt_info[best.mid_mx]
    return True


def trim_overlapping_path(
    path: list[PathNode],
    mxs: dict[int, list[int]],
    infos: dict[int, dict[int, int]],
) -> None:
    """Apply cut-point selection at every negative-raw-gap junction."""
    for i in range(len(path) - 1):
        if path[i].raw_gap_size < 0:
            merge_overlapping_pair(mxs, infos, i, i + 1, path)
