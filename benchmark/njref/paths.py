"""Path formatting: minimizer paths -> oriented contig regions with gaps.

Implements the scaffolding-engine core of the reference
(``ntjoin_assemble.py``): grouping a minimizer path into target-contig runs,
orientation, region coordinates, gap estimation, relocation merging, the
``no_cut`` adjustment and intersecting-region bookkeeping.  Cited line ranges
mark the behaviour each function reproduces.
"""
from __future__ import annotations

from njref.assembly import SharedIndex
from njref.orientation import determine_orientations
from njref.pathnode import Bed, PathNode
from njref.graph_paths import SubGraphView


class PathBuilder:
    """Converts graph paths into PathNode lists for the target assembly."""

    def __init__(
        self,
        shared: SharedIndex,
        target_idx: int,
        scaffold_lengths: dict[str, int],
        mx_extremes: dict[int, tuple[int, int]],
        *,
        k: int,
        g_min: int,
        g_max: int,
        m_percent: float,
    ):
        self.shared = shared
        self.target_idx = target_idx
        self.scaffold_lengths = scaffold_lengths
        self.mx_extremes = mx_extremes
        self.k = k
        self.g_min = g_min
        self.g_max = g_max
        self.m_percent = m_percent
        self.contig_names = shared.assemblies[target_idx].contig_names

    # -- region coordinates (reference ntjoin_assemble.py:52-64) --

    def _start_coord(self, positions, ctg_idx) -> int:
        lo = min(positions)
        return 0 if lo == self.mx_extremes[ctg_idx][0] else lo

    def _end_coord(self, positions, ctg_idx, ctg_len) -> int:
        hi = max(positions)
        return ctg_len if hi == self.mx_extremes[ctg_idx][1] else hi + self.k

    # -- gap estimation (reference ntjoin_assemble.py:67-113) --

    def _gap_size(self, u: PathNode, v: PathNode, view: SubGraphView):
        if u.ori == "?" or v.ori == "?":
            return 0, 0
        u_mx, v_mx = u.terminal_mx, v.first_mx
        mx_path = view.shortest_path(u_mx, v_mx)
        support = ~0
        for mask in view.path_support_masks(mx_path):
            support &= mask
        if support == 0:
            return self.g_min, self.g_min

        pos = self.shared.pos
        distances = [
            abs(int(pos[a, v_mx]) - int(pos[a, u_mx]))
            for a in range(len(self.shared.assemblies))
            if support & (1 << a)
        ]
        mean_dist = int(sum(distances) / len(distances)) - self.k

        tpos = pos[self.target_idx]
        if u.ori == "+":
            a_over = u.end - int(tpos[u_mx]) - self.k
        else:
            a_over = int(tpos[u_mx]) - u.start
        if v.ori == "+":
            b_over = int(tpos[v_mx]) - v.start
        else:
            b_over = v.end - int(tpos[v_mx]) - self.k
        if a_over < 0 or b_over < 0:
            raise ValueError(
                "Gap distance estimation less than 0: "
                f"{u} {v} positions {int(tpos[u_mx])} {int(tpos[v_mx])} "
                f"estimated {mean_dist}"
            )
        raw = mean_dist - a_over - b_over
        gap = max(raw, self.g_min)
        if self.g_max > 0:
            gap = min(gap, self.g_max)
        return gap, raw

    # -- path -> PathNode conversion (reference ntjoin_assemble.py:175-218) --

    def format_path(self, mx_path: list[int], view: SubGraphView) -> list[PathNode]:
        t = self.target_idx
        ctg_of = self.shared.ctg[t]
        pos_of = self.shared.pos[t]

        # collect the path's contig runs first, then orient them as one batch
        runs: list[tuple[int, list[int], int, int]] = []
        cur_ctg = None
        positions: list[int] = []
        first_mx = prev_mx = None
        for mx in mx_path:
            c = int(ctg_of[mx])
            p = int(pos_of[mx])
            if cur_ctg is not None and c == cur_ctg:
                positions.append(p)
            else:
                if cur_ctg is not None:
                    runs.append((cur_ctg, positions, first_mx, prev_mx))
                cur_ctg = c
                positions = [p]
                first_mx = mx
            prev_mx = mx
        if cur_ctg is not None:
            runs.append((cur_ctg, positions, first_mx, prev_mx))

        oris = determine_orientations([r[1] for r in runs], self.m_percent)
        out: list[PathNode] = []
        for (ctg_idx, positions, first_mx, last_mx), ori in zip(runs, oris):
            if ori == "?":
                continue
            name = self.contig_names[ctg_idx]
            length = self.scaffold_lengths[name]
            out.append(
                PathNode(
                    contig=name,
                    ori=ori,
                    start=self._start_coord(positions, ctg_idx),
                    end=self._end_coord(positions, ctg_idx, length),
                    contig_size=length,
                    first_mx=first_mx,
                    terminal_mx=last_mx,
                )
            )

        for u, v in zip(out, out[1:]):
            gap, raw = self._gap_size(u, v, view)
            u.gap_size = gap
            u.raw_gap_size = raw
        return out


# -- relocation merging (reference ntjoin_assemble.py:115-172) --


def _new_region_overlaps(start, end, node_i, node_j, segments: set[Bed]) -> bool:
    for seg in segments:
        if (
            start <= seg.end
            and seg.start <= end
            and (seg.start != node_i.start and seg.end != node_i.end)
            and (seg.start != node_j.start and seg.end != node_j.end)
        ):
            return True
    return False


def merge_relocations(
    path: list[PathNode], incorporated: dict[str, set[Bed]]
) -> list[PathNode]:
    """Merge adjacent collinear intervals of the same contig in a path."""
    if len(path) < 2:
        return path
    merged = [path[0]]
    for node_i, node_j in zip(path, path[1:]):
        if node_i.contig != node_j.contig:
            merged.append(node_j)
            continue
        segs = incorporated[node_i.contig]
        last = merged[-1]
        if node_i.ori == "+" == node_j.ori and node_i.end <= node_j.start:
            if _new_region_overlaps(node_i.start, node_j.end, node_i, node_j, segs):
                merged.append(node_j)
                continue
            segs.add(Bed(last.contig, last.start, node_j.end))
            segs.remove(Bed(last.contig, last.start, last.end))
            segs.remove(Bed(node_j.contig, node_j.start, node_j.end))
            last.end = node_j.end
            last.terminal_mx = node_j.terminal_mx
            last.gap_size = node_j.gap_size
        elif node_i.ori == "-" == node_j.ori and node_i.start >= node_j.end:
            if _new_region_overlaps(node_j.start, node_i.end, node_i, node_j, segs):
                merged.append(node_j)
                continue
            segs.add(Bed(last.contig, node_j.start, last.end))
            segs.remove(Bed(last.contig, last.start, last.end))
            segs.remove(Bed(node_j.contig, node_j.start, node_j.end))
            last.start = node_j.start
            last.first_mx = node_j.first_mx
            last.gap_size = node_j.gap_size
        else:
            merged.append(node_j)
    return merged


def tally_incorporated(incorporated: dict[str, set[Bed]], path: list[PathNode]):
    """Track contig segments used by multi-node paths (ref :220-230)."""
    if len(path) < 2:
        return
    for node in path:
        incorporated.setdefault(node.contig, set()).add(node.bed())


# -- no_cut path adjustment (reference ntjoin_assemble.py:233-305) --


def _is_best_region(nodes_same_ctg: list[PathNode], query: PathNode) -> bool:
    best_len, best = 0, None
    for node in nodes_same_ctg:
        if node.aligned_length > best_len:
            best_len, best = node.aligned_length, node
    return (
        query.aligned_length == best_len
        and best is not None
        and best.terminal_mx == query.terminal_mx
    )


def _is_subsumed(i: int, path: list[PathNode], regions) -> bool:
    if i == 0 or i >= len(path) - 1:
        return False
    prev_n, next_n = path[i - 1], path[i + 1]
    return (
        prev_n.contig == next_n.contig
        and prev_n.ori == next_n.ori
        and min(prev_n.start, next_n.start) == 0
        and max(prev_n.end, next_n.end) == prev_n.contig_size
        and len(regions[prev_n.contig]) == 2
    )


def adjust_paths_no_cut(
    paths: list[list[PathNode]],
    scaffold_lengths: dict[str, int],
    incorporated: dict[str, set[Bed]],
    g_max: int,
) -> list[list[PathNode]]:
    """Avoid cutting contigs: keep each contig whole in its best path."""
    regions: dict[str, list[PathNode]] = {}
    for path in paths:
        for node in path:
            regions.setdefault(node.contig, []).append(node)

    intermediate = []
    for path in paths:
        kept = [n for i, n in enumerate(path) if not _is_subsumed(i, path, regions)]
        intermediate.append(merge_relocations(kept, incorporated))

    new_paths = []
    for path in intermediate:
        new_path: list[PathNode] = []
        for i, node in enumerate(path):
            same = regions[node.contig]
            if (len(same) > 1 and _is_best_region(same, node)) or (
                len(same) == 1
                and node.aligned_length < scaffold_lengths[node.contig]
            ):
                node.start = 0
                node.end = scaffold_lengths[node.contig]
                new_path.append(node)
            elif len(same) > 1 and not _is_best_region(same, node):
                if 0 < i < len(path) - 1 and new_path:
                    new_path[-1].gap_size += node.aligned_length
                    if g_max > 0:
                        new_path[-1].gap_size = min(g_max, new_path[-1].gap_size)
            else:
                new_path.append(node)
        new_paths.append(new_path)
    return new_paths


# -- intersecting-region removal in final emission (ref :450-466) --


def remove_overlapping_regions(
    path: list[PathNode], intersecting: dict[str, dict[Bed, Bed | None]]
) -> list[PathNode]:
    new_path = []
    for node in path:
        fixes = intersecting.get(node.contig)
        if fixes is not None:
            bed = node.bed()
            if bed in fixes:
                new_bed = fixes[bed]
                if new_bed is None:
                    continue
                if new_bed != bed:
                    node.start = new_bed.start
                    node.end = new_bed.end
        new_path.append(node)
    return new_path


def zero_terminal_gap(path: list[PathNode]) -> None:
    """Force the last oriented node's gap to 0 (ref :441-448)."""
    for node in reversed(path):
        if node.ori != "?":
            node.gap_size = 0
            break
