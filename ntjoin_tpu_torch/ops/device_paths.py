"""Path-extraction passes on a torch device.  Port of
``ntjoin_tpu/ops/device_paths.py``.

* :func:`escalate_filter_device`: the per-component escalating branch-edge
  filter (reference ``filter_graph`` and its while loop,
  ``ntjoin.py:70-78,143-146``) as a loop of scatter-add degree passes, one
  threshold step per iteration and one sync each.  Weights and thresholds
  compare in float64, as the host pass (``graph.paths
  .escalating_branch_filter``) does, so every weight takes this path.
* :func:`chain_ranks_device`: every simple chain walked at once by pointer
  jumping over directed half-edges (half-edge ``2*u + j`` leaves ``u`` by its
  ``j``-th neighbour slot); ``RankWalker`` then slices each chain on the
  host.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu_torch.ops.device_index import _count


def _degrees(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor, n: int) -> torch.Tensor:
    a = alive.to(torch.int64)
    return (torch.zeros(n, dtype=torch.int64, device=src.device)
            .scatter_add_(0, src, a).scatter_add_(0, dst, a))


def escalate_filter_device(graph, comp: np.ndarray, n_min: float, max_weight: float,
                           device: str | torch.device = "cuda") -> np.ndarray:
    """The new alive mask after the escalating branch filter, equal to
    ``graph.paths.escalating_branch_filter(graph, comp, n_min, max_weight)``
    (which updates ``graph.alive`` in place): while a component has a node
    of degree > 2 and the threshold is at most ``max_weight``, its alive
    edges lighter than the threshold that touch a branch node die, and the
    threshold rises by 1."""
    dev = torch.device(device)
    _count("escalate", dev)
    n = graph.num_nodes
    alive = torch.from_numpy(np.asarray(graph.alive, dtype=bool).copy()).to(dev)
    if comp.size == 0:
        return alive.cpu().numpy()
    src = torch.from_numpy(np.asarray(graph.src, dtype=np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(graph.dst, dtype=np.int64)).to(dev)
    weight = torch.from_numpy(np.asarray(graph.weight, dtype=np.float64)).to(dev)
    comp_t = torch.from_numpy(np.asarray(comp, dtype=np.int64)).to(dev)
    ecomp = comp_t[src]
    ncomp = int(comp.max()) + 1

    def refresh():
        deg = _degrees(src, dst, alive, n)
        comp_max = torch.zeros(ncomp, dtype=torch.int64, device=dev).scatter_reduce_(
            0, comp_t, deg, reduce="amax")
        return deg, comp_max <= 2

    deg, done = refresh()
    threshold = n_min
    while threshold <= max_weight and not bool(done.all()):
        branch = deg > 2
        rm = alive & ~done[ecomp] & (weight < threshold) & (branch[src] | branch[dst])
        alive &= ~rm
        deg, done = refresh()
        threshold += 1
    return alive.cpu().numpy()


def chain_ranks_device(n1: np.ndarray, n2: np.ndarray,
                       device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """(terminal, remain) per half-edge h = 2*u + j, which points from u to
    its neighbour in slot j (n1, n2; -1 for none): the half-edge its
    direction ends with, and the nodes from u to the chain's end, counting
    u and not the last half-edge's head (remain = 1 on the last half-edge).
    Dead slots are their own terminal with remain 0; cycles never end, and
    their remain is clamped at 2^30."""
    dev = torch.device(device)
    _count("rank", dev)
    n = n1.shape[0]
    rounds = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    a1 = torch.from_numpy(np.asarray(n1, dtype=np.int64)).to(dev)
    a2 = torch.from_numpy(np.asarray(n2, dtype=np.int64)).to(dev)
    u = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(2)
    v = torch.stack([a1, a2], dim=1).reshape(-1)
    live = v >= 0
    vs = v.clamp(min=0)
    # the successor at v is the slot that does not lead back to u (parallel
    # edges never survive the build; a degree-1 v has its only slot in n1)
    succ = 2 * vs + (a1[vs] == u).to(torch.int64)
    nxt_slot = torch.where(succ % 2 == 0, a1[vs], a2[vs])
    terminal_here = ~live | (nxt_slot < 0)
    h = torch.arange(2 * n, dtype=torch.int64, device=dev)
    # two pointers (Wyllie): ptr_r ends in -1 and drives the rank sums (each
    # rank absorbed once); ptr_t ends in a self-loop and converges to the
    # terminal itself, the chain's group key
    ptr_t = torch.where(terminal_here, h, succ)
    ptr_r = torch.where(terminal_here, -1, succ)
    remain = live.to(torch.int64)
    for _ in range(rounds):
        mask = ptr_r >= 0
        idx = ptr_r.clamp(min=0)
        remain = (remain + torch.where(mask, remain[idx], 0)).clamp_(max=1 << 30)
        ptr_r = torch.where(mask, ptr_r[idx], -1)
        ptr_t = ptr_t[ptr_t]
    return ptr_t.cpu().numpy(), remain.cpu().numpy()


class RankWalker:
    """Per-source chain walks from one ranking pass.

    Grouping by terminal happens once; ``walk(source)`` then returns the
    chain's (nodes, eids) exactly like the sequential walk
    (``graph.paths._walk_chain``): nodes in walk order, the i-th eid joining
    nodes i and i+1.
    """

    def __init__(self, term, remain, n1, n2, e1, e2):
        self.term, self.remain = term, remain
        self.n1, self.n2 = n1, n2
        n = n1.shape[0]
        self.he_u = np.repeat(np.arange(n, dtype=np.int64), 2)
        self.he_e = np.stack([e1.astype(np.int64), e2.astype(np.int64)], axis=1).reshape(-1)
        # group half-edges by terminal (each chain direction = one group),
        # descending remain within a group = ascending walk order
        self.order = np.lexsort((-remain, term))
        term_s = term[self.order]
        starts = np.flatnonzero(np.concatenate([[True], term_s[1:] != term_s[:-1]]))
        self.bounds = np.append(starts, term_s.shape[0])
        self.group_of = {int(term_s[starts[i]]): i for i in range(starts.shape[0])}

    def walk(self, s: int) -> tuple[np.ndarray, np.ndarray]:
        h0 = 2 * int(s)  # degree-1 source: its only neighbour is in n1
        gi = self.group_of.get(int(self.term[h0]))
        if gi is None:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        grp = self.order[self.bounds[gi] : self.bounds[gi + 1]]
        nodes = self.he_u[grp]
        eids = self.he_e[grp]
        last = int(grp[-1])
        u_last = int(self.he_u[last])
        v_last = int(self.n1[u_last] if last % 2 == 0 else self.n2[u_last])
        return np.append(nodes, v_last), eids


def make_rank_walker(n1, n2, e1, e2, device: str | torch.device = "cuda") -> RankWalker:
    """One ranking pass on ``device``, then a host chain walker."""
    term, remain = chain_ranks_device(n1, n2, device)
    return RankWalker(term, remain, n1, n2, e1, e2)
