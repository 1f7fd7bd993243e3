"""Linear path extraction with the graph-scale passes on a torch device.
Port of ``ntjoin_tpu/graph/paths.py::find_paths`` with ``device=True``:
connected components (``ops/cc.py``), the escalating branch filter and the
list ranking of every simple chain (``ops/device_paths.py``) run on the
device, with no host route: a failure there is an error.  The per-component
walks and validations reuse the JAX package's host helpers.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu.core.assembly import SharedIndex
from ntjoin_tpu.graph.mingraph import MinimizerGraph
from ntjoin_tpu.graph.paths import ChainView, SubGraphView, _break_circular, _pick_endpoints
from ntjoin_tpu_torch.ops.cc import connected_components
from ntjoin_tpu_torch.ops.device_paths import escalate_filter_device, make_rank_walker


def _components(graph: MinimizerGraph, device) -> np.ndarray:
    return connected_components(graph.num_nodes, graph.src[graph.alive],
                                graph.dst[graph.alive], device)


def find_paths(
    graph: MinimizerGraph, shared: SharedIndex, n_min: float,
    device: str | torch.device = "cuda",
) -> tuple[list[tuple[list[int], SubGraphView | ChainView]], int]:
    """Validated simple paths of every component, and the component count;
    equal to ``ntjoin_tpu.graph.paths.find_paths(graph, shared, n_min)``,
    including its update of ``graph.alive``.

    Path order: components by smallest member node id, then subcomponents
    by theirs.  Simple chains come from the device ranking; branchy
    leftovers and circular subcomponents build host adjacency views.
    """
    weights = np.array([a.weight for a in shared.assemblies])
    if graph.num_nodes == 0:
        return [], 0
    comp = _components(graph, device)
    ncomp = int(comp.max()) + 1 if comp.size else 0
    graph.alive = escalate_filter_device(graph, comp, n_min, float(weights.sum()), device)

    sub = _components(graph, device)
    deg = graph.degrees()

    # node lists per subcomponent, ids ascending
    order = np.argsort(sub, kind="stable")
    sub_sorted = sub[order]
    starts = np.flatnonzero(np.concatenate([[True], sub_sorted[1:] != sub_sorted[:-1]]))
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

    # two-neighbour arrays in edge-id order (chain nodes have degree <= 2;
    # higher-degree nodes keep their first two slots and are never ranked)
    ends = np.concatenate([graph.src[alive_e], graph.dst[alive_e]])
    other = np.concatenate([graph.dst[alive_e], graph.src[alive_e]])
    eid2 = np.concatenate([alive_e, alive_e])
    aorder = np.lexsort((eid2, ends))
    ends_s, other_s, eid_s = ends[aorder], other[aorder], eid2[aorder]
    same_prev = np.concatenate([[False], ends_s[1:] == ends_s[:-1]])
    run_start = np.flatnonzero(~same_prev)
    run = np.arange(ends_s.shape[0]) - np.repeat(
        run_start, np.diff(np.append(run_start, ends_s.shape[0])))
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
    walker = make_rank_walker(n1, n2, e1, e2, device)

    # deterministic order: (parent component min node, subcomponent min node)
    labels = sorted(
        label_of,
        key=lambda lb: (int(comp[order[bounds[label_of[lb]]]]), int(order[bounds[label_of[lb]]])),
    )

    results: list = []
    for lb in labels:
        si = label_of[lb]
        members = order[bounds[si] : bounds[si + 1]]
        degs = deg[members]
        d1 = members[degs == 1]
        if d1.shape[0] == 2 and (degs <= 2).all():
            s, t = _pick_endpoints([int(x) for x in d1], shared, weights)
            nodes_o, eids_o = walker.walk(s)
            if nodes_o.shape[0] == members.shape[0] and int(nodes_o[-1]) == t:
                results.append(([int(x) for x in nodes_o], ChainView(graph, nodes_o, eids_o)))
            continue

        # branchy leftovers / circular subcomponents: host adjacency view
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
