"""Minimizer graph as flat arrays (edge-list + masks), built vectorized.

Re-design of the reference's igraph-based graph core (reference
``ntjoin_utils.build_graph:83-141``): instead of per-pair dict insertions and
an igraph C object, adjacent-minimizer pairs from every assembly stream are
generated as arrays and grouped with a single lexsort.  Semantics preserved:

* an edge is an unordered hash pair that is adjacent in >= 1 assembly,
* its support is the list of supporting assemblies in first-seen order
  (assembly iteration order), kept here as a bitmask over assembly indices,
* its weight is the sum of supporting assemblies' weights,
* edge order and (src, dst) orientation follow first occurrence, matching the
  reference's insertion-ordered dict so DOT dumps line up.

The ``alive`` mask supports the downstream edge filters without copying
(reference copies the whole graph per filter, ``ntjoin.py:76-77``).
"""
from __future__ import annotations

import numpy as np

from njref.assembly import SharedIndex

try:  # scipy's C union-find when available; numpy pointer-jumping otherwise
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _scipy_cc
except ImportError:  # pragma: no cover
    _scipy_cc = None


class MinimizerGraph:
    """Undirected multigraph-free edge list over SharedIndex node ids."""

    def __init__(self, num_nodes, src, dst, weight, support_mask,
                 node_hash=None):
        self.num_nodes = int(num_nodes)
        self.src = src
        self.dst = dst
        self.weight = weight
        self.support_mask = support_mask
        self.alive = np.ones(src.shape[0], dtype=bool)
        # ascending minimizer hash per node id (the SharedIndex universe);
        # lets incremental extension translate between id spaces
        self.node_hash = node_hash

    @property
    def num_edges(self) -> int:
        return int(self.alive.sum())

    def degrees(self, edge_mask: np.ndarray | None = None) -> np.ndarray:
        mask = self.alive if edge_mask is None else edge_mask
        deg = np.bincount(self.src[mask], minlength=self.num_nodes)
        deg += np.bincount(self.dst[mask], minlength=self.num_nodes)
        return deg

    def components(self, edge_mask: np.ndarray | None = None) -> np.ndarray:
        """Connected-component label per node (isolated nodes included)."""
        mask = self.alive if edge_mask is None else edge_mask
        s, d = self.src[mask], self.dst[mask]
        if _scipy_cc is not None:
            m = coo_matrix(
                (np.ones(s.shape[0], dtype=np.int8), (s, d)),
                shape=(self.num_nodes, self.num_nodes),
            )
            _, labels = _scipy_cc(m, directed=False)
            return labels
        return _pointer_jump_cc(self.num_nodes, s, d)

    def global_weight_filter(self, n_min: float, min_assembly_weight: float) -> None:
        """Drop edges below the global weight floor.

        Skipped entirely when ``n <= min(weights)``, matching reference
        ``filter_graph_global`` (``ntjoin.py:80-89``).
        """
        if n_min <= min_assembly_weight:
            return
        self.alive &= self.weight >= n_min


def _pointer_jump_cc(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Union-find-free connected components: hook minima + pointer doubling.

    O(E log N) vectorized iterations; the torch version is ``ops/cc.py``.
    """
    parent = np.arange(n, dtype=np.int64)
    while True:
        ps, pd = parent[src], parent[dst]
        lo = np.minimum(ps, pd)
        hi = np.maximum(ps, pd)
        np.minimum.at(parent, hi, lo)
        changed = (parent[src] != parent[dst]).any() if src.size else False
        # pointer doubling to full compression
        while True:
            nxt = parent[parent]
            if (nxt == parent).all():
                break
            parent = nxt
        if not changed:
            break
    # relabel to dense ids
    _, labels = np.unique(parent, return_inverse=True)
    return labels


def build_graph(shared: SharedIndex) -> MinimizerGraph:
    """Generate the weighted minimizer adjacency graph from assembly streams."""
    n_asm = len(shared.assemblies)
    us, vs, asm_ids = [], [], []
    for a in range(n_asm):
        ids, ctgs = shared.streams[a]
        if ids.shape[0] < 2:
            continue
        same_ctg = ctgs[1:] == ctgs[:-1]
        us.append(ids[:-1][same_ctg])
        vs.append(ids[1:][same_ctg])
        asm_ids.append(np.full(int(same_ctg.sum()), a, dtype=np.int32))
    if not us:
        e = np.empty(0, dtype=np.int32)
        return MinimizerGraph(
            shared.num_nodes, e, e, np.empty(0), np.empty(0, dtype=np.int64),
            node_hash=shared.node_hash,
        )
    u = np.concatenate(us)
    v = np.concatenate(vs)
    asm = np.concatenate(asm_ids)
    occ = np.arange(u.shape[0], dtype=np.int64)

    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    order = np.lexsort((occ, hi, lo))
    lo_s, hi_s, occ_s = lo[order], hi[order], occ[order]
    u_s, v_s, asm_s = u[order], v[order], asm[order]

    new_group = np.empty(lo_s.shape[0], dtype=bool)
    new_group[0] = True
    new_group[1:] = (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])
    starts = np.flatnonzero(new_group)

    weights = np.array([a.weight for a in shared.assemblies])
    grp_weight = np.add.reduceat(weights[asm_s], starts)
    grp_mask = np.bitwise_or.reduceat(
        (np.int64(1) << asm_s.astype(np.int64)), starts
    )
    # first occurrence fixes orientation and edge ordering
    first_order = np.argsort(occ_s[starts], kind="stable")
    return MinimizerGraph(
        shared.num_nodes,
        u_s[starts][first_order].astype(np.int32),
        v_s[starts][first_order].astype(np.int32),
        grp_weight[first_order],
        grp_mask[first_order],
        node_hash=shared.node_hash,
    )
