"""Linear path extraction from the minimizer graph.

Replaces the reference's per-component ``multiprocessing.Pool`` loop
(``ntjoin.py:137-176``) with a single vectorized escalation over all
components in lockstep:

* each component raises its branch-edge weight threshold independently until
  its subgraph is linear (reference ``filter_graph`` + while loop,
  ``ntjoin.py:70-78,143-146``); running every component's iteration ``s`` in
  the same array pass is equivalent because a component's threshold is always
  ``n + (iterations it has executed)``,
* circular components get one edge broken by the reference's rule
  (``ntjoin.py:115-135``),
* the final walks and validations happen per subcomponent on small adjacency
  views (reference ``ntjoin.py:147-161``).

With a torch ``device`` (the default, ``index_backend=device``) the
graph-scale passes of ``find_paths`` - connected components (``ops/cc.py``),
the escalating branch filter and the list ranking of every simple chain
(``ops/device_paths.py``) - run there, with no host route: a failure on the
device is an error.  ``device=None`` runs the host passes of this module.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ntjoin_tpu_torch.core.assembly import SharedIndex
from ntjoin_tpu_torch.graph.mingraph import MinimizerGraph
from ntjoin_tpu_torch.ops.cc import connected_components
from ntjoin_tpu_torch.ops.device_paths import escalate_filter_device, make_rank_walker
from ntjoin_tpu_torch.utils import timers


@dataclass
class SubGraphView:
    """A subcomponent: adjacency in edge-insertion order + edge attributes.

    Carried along with each extracted path because gap estimation later walks
    shortest paths and intersects per-edge assembly support on this exact
    filtered subgraph (reference ``ntjoin_assemble.py:78-83``).
    """

    graph: MinimizerGraph
    nodes: list[int]
    adj: dict[int, list[tuple[int, int]]] = field(default_factory=dict)
    num_edges: int = 0

    def add_edge(self, eid: int) -> None:
        s = int(self.graph.src[eid])
        d = int(self.graph.dst[eid])
        self.adj.setdefault(s, []).append((d, eid))
        self.adj.setdefault(d, []).append((s, eid))
        self.num_edges += 1

    def remove_edge(self, u: int, v: int) -> None:
        self.adj[u] = [(n, e) for n, e in self.adj[u] if n != v]
        self.adj[v] = [(n, e) for n, e in self.adj[v] if n != u]
        self.num_edges -= 1

    def degree(self, node: int) -> int:
        return len(self.adj.get(node, []))

    def shortest_path(self, s: int, t: int) -> list[int]:
        """BFS shortest path (unweighted), neighbor order = edge order."""
        if s == t:
            return [s]
        parent: dict[int, int] = {s: s}
        q: deque[int] = deque([s])
        while q:
            cur = q.popleft()
            for nbr, _ in self.adj.get(cur, []):
                if nbr not in parent:
                    parent[nbr] = cur
                    if nbr == t:
                        path = [t]
                        while path[-1] != s:
                            path.append(parent[path[-1]])
                        return path[::-1]
                    q.append(nbr)
        return []

    def edge_id(self, u: int, v: int) -> int | None:
        for nbr, eid in self.adj.get(u, []):
            if nbr == v:
                return eid
        return None

    def path_support_masks(self, path: list[int]) -> list[int]:
        masks = []
        for a, b in zip(path, path[1:]):
            eid = self.edge_id(a, b)
            masks.append(int(self.graph.support_mask[eid]))
        return masks


def escalating_branch_filter(
    graph: MinimizerGraph, comp: np.ndarray, n_min: float, max_weight: float
) -> None:
    """Per-component lockstep branch-edge filtering until linear (in place)."""
    ncomp = int(comp.max()) + 1 if comp.size else 0
    if ncomp == 0:
        return
    comp_maxdeg = np.zeros(ncomp, dtype=np.int64)

    def refresh_done():
        comp_maxdeg[:] = 0
        np.maximum.at(comp_maxdeg, comp, graph.degrees())
        return comp_maxdeg <= 2

    done = refresh_done()
    threshold = n_min
    while (~done).any() and threshold <= max_weight:
        deg = graph.degrees()
        branch = deg > 2
        ecomp = comp[graph.src]
        rm = (
            graph.alive
            & ~done[ecomp]
            & (graph.weight < threshold)
            & (branch[graph.src] | branch[graph.dst])
        )
        graph.alive &= ~rm
        done = refresh_done()
        threshold += 1


def _break_circular(
    view: SubGraphView, shared: SharedIndex, weights: np.ndarray
) -> list[int]:
    """Break one edge of an all-degree-2 (circular) subcomponent.

    Rule from reference ``check_circularity`` (``ntjoin.py:115-135``): anchor
    at the minimum-position vertex in the *first* maximum-weight assembly and
    cut towards its highest-position neighbour.
    """
    if not all(view.degree(n) == 2 for n in view.nodes):
        return []
    a_hi = int(np.argmax(weights))  # first max-weight assembly (stable)
    pos = shared.pos[a_hi]
    v = min(view.nodes, key=lambda n: (int(pos[n]), n))
    nbrs = [n for n, _ in view.adj[v]]
    # stable sort descending by position -> first among ties in edge order
    hi_nbr = sorted(nbrs, key=lambda n: -int(pos[n]))[0]
    view.remove_edge(v, hi_nbr)
    return [v, hi_nbr]


def _pick_endpoints(
    sources: list[int], shared: SharedIndex, weights: np.ndarray
) -> tuple[int, int]:
    """Choose walk direction from the *last* maximum-weight assembly.

    Reference ``determine_source_vertex`` (``ntjoin.py:91-104``) pops the last
    max-weight assembly and the last position-extreme vertex; replicated.
    """
    max_w = weights.max()
    a_max = max(i for i, w in enumerate(weights) if w == max_w)
    pos = shared.pos[a_max]
    min_pos = min(int(pos[s]) for s in sources)
    max_pos = max(int(pos[s]) for s in sources)
    source = [s for s in sources if int(pos[s]) == min_pos][-1]
    target = [s for s in sources if int(pos[s]) == max_pos][-1]
    return source, target


class ChainView:
    """Gap-estimation view over a validated simple chain.

    The walked order makes shortest paths trivial slices; matches the
    ``SubGraphView`` surface used by ``PathBuilder._gap_size``.
    """

    def __init__(self, graph: MinimizerGraph, order_nodes, step_eids):
        self.graph = graph
        self.order = order_nodes
        self.step_eids = step_eids
        self._index: dict[int, int] | None = None

    def shortest_path(self, s: int, t: int) -> list[int]:
        if self._index is None:
            self._index = {int(n): i for i, n in enumerate(self.order)}
        i, j = self._index[s], self._index[t]
        if i <= j:
            return [int(n) for n in self.order[i : j + 1]]
        return [int(n) for n in self.order[j : i + 1]][::-1]

    def path_support_masks(self, path: list[int]) -> list[int]:
        i = self._index[path[0]]
        j = self._index[path[-1]]
        lo, hi = (i, j) if i <= j else (j, i)
        return [int(self.graph.support_mask[e]) for e in self.step_eids[lo:hi]]


def _walk_chain(n1, n2, e1, e2, source: int, length: int):
    """Chain walk via the native library, python fallback otherwise."""
    out_nodes = np.empty(length, dtype=np.int32)
    out_eids = np.empty(max(length - 1, 1), dtype=np.int32)
    from ntjoin_tpu_torch.io import native as native_lib

    lib = native_lib._load()
    if lib is not None:
        got = lib.nj_walk_chain(
            n1.ctypes.data, n2.ctypes.data, e1.ctypes.data, e2.ctypes.data,
            source, length, out_nodes.ctypes.data, out_eids.ctypes.data,
        )
        return out_nodes[:got], out_eids[: max(got - 1, 0)]
    prev, cur = -1, source
    ln = 0
    while cur >= 0 and ln < length:
        out_nodes[ln] = cur
        a, b = int(n1[cur]), int(n2[cur])
        nxt, eid = (a, int(e1[cur])) if a != prev else (b, int(e2[cur]))
        if ln + 1 < length and nxt >= 0:
            out_eids[ln] = eid
        prev, cur = cur, nxt
        ln += 1
    return out_nodes[:ln], out_eids[: max(ln - 1, 0)]


def find_paths(
    graph: MinimizerGraph, shared: SharedIndex, n_min: float,
    device: str | torch.device | None = "cuda",
) -> tuple[list[tuple[list[int], SubGraphView | ChainView]], int]:
    """Extract validated simple paths from every component.

    Returns (paths, total component count).  Path order is deterministic:
    components by smallest member node id (node ids are hash-sorted), matching
    no particular reference order — the reference's own order is python-set
    nondeterministic (``ntjoin_utils.py:94,121``).

    Simple chains (the overwhelmingly common case) are walked over flat
    two-neighbour arrays; only branchy leftovers and circular subcomponents
    build python adjacency views.

    On a torch ``device`` the graph-scale passes are torch ops: component
    labelling, the escalating branch filter as masked scatter-add degree
    passes, and ALL simple chains at once via half-edge pointer-jumping list
    ranking (``ops/device_paths.py``) — results identical to the host
    passes, which ``device=None`` runs (natively walked chains).
    """
    weights = np.array([a.weight for a in shared.assemblies])
    if graph.num_nodes == 0:
        return [], 0

    def components() -> np.ndarray:
        if device is None:
            return graph.components()
        return connected_components(graph.num_nodes, graph.src[graph.alive],
                                    graph.dst[graph.alive], device)

    comp = components()
    ncomp = int(comp.max()) + 1 if comp.size else 0

    with timers.span("branch"):
        if device is None:
            escalating_branch_filter(graph, comp, n_min, float(weights.sum()))
        else:
            graph.alive = escalate_filter_device(graph, comp, n_min, float(weights.sum()), device)

    sub = components()
    deg = graph.degrees()

    # node lists per subcomponent, ids ascending
    order = np.argsort(sub, kind="stable")
    sub_sorted = sub[order]
    starts = np.flatnonzero(
        np.concatenate([[True], sub_sorted[1:] != sub_sorted[:-1]])
    )
    bounds = np.append(starts, sub_sorted.shape[0])
    label_of = {int(sub_sorted[starts[si]]): si for si in range(starts.shape[0])}

    # per-subcomponent alive-edge lists (grouped once)
    alive_e = np.flatnonzero(graph.alive)
    esub = sub[graph.src[alive_e]]
    eorder = np.argsort(esub, kind="stable")
    e_sorted = alive_e[eorder]
    esub_sorted = esub[eorder]
    e_starts = np.searchsorted(esub_sorted, np.arange(int(sub.max()) + 1 if sub.size else 0))
    e_bounds = np.append(e_starts, esub_sorted.shape[0])

    # two-neighbour arrays in edge-id order (degrees <= 2 after filtering for
    # chain nodes; higher-degree nodes keep only their first two slots and are
    # never walked natively)
    ends = np.concatenate([graph.src[alive_e], graph.dst[alive_e]])
    other = np.concatenate([graph.dst[alive_e], graph.src[alive_e]])
    eid2 = np.concatenate([alive_e, alive_e])
    aorder = np.lexsort((eid2, ends))
    ends_s, other_s, eid_s = ends[aorder], other[aorder], eid2[aorder]
    same_prev = np.concatenate([[False], ends_s[1:] == ends_s[:-1]])
    # position within each node's adjacency run (edge-id order within node)
    run_start = np.flatnonzero(~same_prev)
    run = np.arange(ends_s.shape[0]) - np.repeat(
        run_start, np.diff(np.append(run_start, ends_s.shape[0]))
    )
    n1 = np.full(graph.num_nodes, -1, dtype=np.int32)
    n2 = np.full(graph.num_nodes, -1, dtype=np.int32)
    e1 = np.full(graph.num_nodes, -1, dtype=np.int32)
    e2 = np.full(graph.num_nodes, -1, dtype=np.int32)
    m0 = run == 0
    m1 = run == 1
    n1[ends_s[m0]] = other_s[m0]
    e1[ends_s[m0]] = eid_s[m0]
    n2[ends_s[m1]] = other_s[m1]
    e2[ends_s[m1]] = eid_s[m1]

    walker = None if device is None else make_rank_walker(n1, n2, e1, e2, device)

    # deterministic order: (parent component min node, subcomponent min node)
    labels = sorted(
        label_of,
        key=lambda lb: (
            int(comp[order[bounds[label_of[lb]]]]),
            int(order[bounds[label_of[lb]]]),
        ),
    )

    results: list[tuple[list[int], SubGraphView | ChainView]] = []
    for lb in labels:
        si = label_of[lb]
        members = order[bounds[si] : bounds[si + 1]]
        degs = deg[members]
        d1 = members[degs == 1]
        if d1.shape[0] == 2 and (degs <= 2).all():
            # simple chain: ranked or natively walked, no python adjacency
            s, t = _pick_endpoints([int(x) for x in d1], shared, weights)
            if walker is not None:
                nodes_o, eids_o = walker.walk(s)
            else:
                nodes_o, eids_o = _walk_chain(
                    n1, n2, e1, e2, s, members.shape[0]
                )
            if nodes_o.shape[0] == members.shape[0] and int(nodes_o[-1]) == t:
                view = ChainView(graph, nodes_o, eids_o)
                results.append(([int(x) for x in nodes_o], view))
            continue

        # branchy leftovers / circular subcomponents: python view
        view = SubGraphView(graph, [int(m) for m in members])
        for eid in e_sorted[e_bounds[lb] : e_bounds[lb + 1]]:
            view.add_edge(int(eid))
        sources = [n for n in view.nodes if view.degree(n) == 1]
        if not sources:
            sources = _break_circular(view, shared, weights)
        if len(sources) != 2:
            continue
        s, t = _pick_endpoints(sources, shared, weights)
        path = view.shortest_path(s, t)
        if (
            len(path) == len(view.nodes)
            and len(path) - 1 == view.num_edges
            and len(path) == len(set(path))
        ):
            results.append((path, view))
    return results, ncomp
