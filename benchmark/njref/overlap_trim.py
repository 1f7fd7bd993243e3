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

from njref.pathnode import PathNode
from njref.nthash_np import sketch_seq


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


def _in_valid_region(pos: int, index: int, nodes: list[PathNode]) -> bool:
    """ref ``is_in_valid_region:90-96``"""
    if index > 0 and pos < -nodes[index - 1].raw_gap_size:
        return True
    return pos >= nodes[index].aligned_length + nodes[index].raw_gap_size


def sketch_segment(
    core: str, lo: int, hi: int, index: int, nodes: list[PathNode], k: int, w: int
) -> tuple[list[int], dict[int, int]]:
    """Sketch one segment with bases [lo, hi) masked; keep in-valid-region,
    non-duplicate mx.

    Returns (ordered mx list, mx -> position); semantics of reference
    ``tally_minimizers_overlap:501-516``.  The masked run is sketched as one
    N: no valid k-mer touches it either way, windows run over valid k-mers
    only, and a k-mer's hash does not depend on its position, so only the
    positions right of the run move, by its length less one.
    """
    if hi > lo:
        sk = sketch_seq(core[:lo] + "N" + core[hi:], k, w)
        shift = (sk.positions > lo) * (hi - lo - 1)
        positions = (sk.positions + shift).tolist()
    else:
        sk = sketch_seq(core, k, w)
        positions = sk.positions.tolist()
    order: list[int] = []
    info: dict[int, int] = {}
    dups: set[int] = set()
    for h, pos in zip(sk.hashes.tolist(), positions):
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
