"""Shared index and minimizer graph built on a torch device.  Port of
``ntjoin_tpu/ops/device_index.py``, equal to the host pipeline
(``core/assembly.SharedIndex``, ``graph/mingraph.build_graph``):

* a hash survives iff it occurs exactly once in every assembly (within-
  assembly uniqueness and the all-assembly intersection in one predicate),
  so one sort by (hash, assembly) leaves the survivors as runs of exactly
  ``n_asm`` elements, and their compacted order is the (node, assembly)
  shared index;
* the edge tally groups consecutive same-contig pairs by their unordered
  node pair; each group keeps its first occurrence (edge order and
  orientation) and exact per-assembly support counts.

Hashes are int64 holding the uint64 bits; unsigned order is ``h ^ (1 << 63)``.
Positions stay int64 and counts are an int32 (edges, assemblies) matrix, so
the JAX package's int32-position, 4-bit-count and 32-assembly host routes
have no counterpart here.  Edge weights are summed on the host from the
counts in the host builder's order, so they match it float for float.

Graph ops count their runs in ``COUNTS`` and the device type they ran on in
``DEVICES`` (``ops/cc.py`` and ``ops/device_paths.py`` count here too);
``COUNTS["cc_rounds"]`` counts the hooking rounds of connected components,
one sync each.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu_torch.core.assembly import SharedIndex

GRAPH_OPS = ("shared_filter", "edge_tally", "cc", "escalate", "rank")
COUNTS: dict[str, int] = {}
DEVICES: dict[str, str] = {}
_SIGN = -(1 << 63)  # int64 bits of 1 << 63


def reset_counts() -> None:
    COUNTS.clear()
    DEVICES.clear()
    COUNTS.update(dict.fromkeys(GRAPH_OPS, 0), cc_rounds=0)


reset_counts()


def _count(name: str, device: torch.device) -> None:
    COUNTS[name] += 1
    DEVICES[name] = device.type


def counts_report() -> dict:
    """{op: {"launches": n, "device": type of its last device or None}},
    and the hooking rounds under "cc_rounds"."""
    out: dict = {op: {"launches": COUNTS[op], "device": DEVICES.get(op)} for op in GRAPH_OPS}
    out["cc_rounds"] = COUNTS["cc_rounds"]
    return out


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by the last key, ties by the one before, ...
    (``np.lexsort`` order), from stable sorts, least significant key
    first."""
    order = None
    for key in keys:
        k = key if order is None else key[order]
        _, o = torch.sort(k, stable=True)
        order = o if order is None else order[o]
    return order


def _shift(x: torch.Tensor, fill) -> torch.Tensor:
    """x moved one place later, ``fill`` in front."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def survive_verdict_sorted(h: torch.Tensor, asm: torch.Tensor, dead: torch.Tensor,
                           n_asm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, survive): the sort by (dead, unsigned hash, assembly) and,
    along it, whether the element's hash occurs exactly once in every
    assembly (dead elements never survive)."""
    n = h.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=h.device), dead.clone()
    order = _lexsort(asm, h ^ _SIGN, dead.to(torch.int8))
    s_h, s_asm, s_dead = h[order], asm[order], dead[order]
    same_hash = torch.cat([torch.zeros(1, dtype=torch.bool, device=h.device),
                           s_h[1:] == s_h[:-1]])
    same_group = same_hash & ~s_dead & _shift(~s_dead, True)
    gid = (~same_group).cumsum(0) - 1
    seg_size = torch.zeros(n, dtype=torch.int64, device=h.device).scatter_add_(
        0, gid, torch.ones_like(gid))
    dup_adj = same_group & (s_asm == _shift(s_asm, -1))
    seg_dup = torch.zeros(n, dtype=torch.int8, device=h.device).scatter_reduce_(
        0, gid, dup_adj.to(torch.int8), reduce="amax")
    survive_g = (seg_size == n_asm) & (seg_dup == 0)
    return order, survive_g[gid] & ~s_dead


def _shared_filter(h, asm, ctg, pos, dead, n_asm: int):
    """Uniqueness and intersection over the assemblies' streams, joined in
    assembly order.  Returns the (node, assembly) tables of hash, contig and
    position, each (num_nodes, n_asm), and each element's node id in the
    original order (-1 where the hash did not survive)."""
    _count("shared_filter", h.device)
    order, survive = survive_verdict_sorted(h, asm, dead, n_asm)
    sel = order[survive]  # survivor rank = node * n_asm + assembly
    nid = torch.full_like(h, -1)
    nid[sel] = torch.arange(sel.shape[0], device=h.device) // n_asm
    return (h[sel].view(-1, n_asm), ctg[sel].view(-1, n_asm), pos[sel].view(-1, n_asm), nid)


def _edge_tally_exact(nid, ctg, asm, num_nodes: int, n_asm: int):
    """Edges of the shared streams (node ids, contigs and assemblies in
    stream order, assembly-major): an unordered pair of nodes adjacent
    within one contig.  Returns (src, dst, counts) in order of first
    occurrence, oriented as it, with counts (edges, n_asm) int32 the pair's
    adjacencies in each assembly."""
    dev = nid.device
    _count("edge_tally", dev)
    alive = (asm[1:] == asm[:-1]) & (ctg[1:] == ctg[:-1])
    occ = torch.nonzero(alive).flatten()
    if occ.shape[0] == 0:
        e = torch.empty(0, dtype=torch.int64, device=dev)
        return e, e, torch.empty((0, n_asm), dtype=torch.int32, device=dev)
    u, v, a = nid[occ], nid[occ + 1], asm[occ]
    key = torch.minimum(u, v) * (num_nodes + 1) + torch.maximum(u, v)
    key_s, perm = torch.sort(key, stable=True)  # stable: a group starts at its first occurrence
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), key_s[1:] != key_s[:-1]])
    seg = new_group.cumsum(0) - 1
    starts = torch.nonzero(new_group).flatten()
    ne = starts.shape[0]
    counts = torch.zeros(ne * n_asm, dtype=torch.int32, device=dev).scatter_add_(
        0, seg * n_asm + a[perm], torch.ones(perm.shape[0], dtype=torch.int32, device=dev))
    first, fo = torch.sort(perm[starts])
    return u[first], v[first], counts.view(ne, n_asm)[fo]


def _stream_tensors(arrays, device: torch.device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(arrays).astype(dtype, copy=False)).to(device)


def shared_index_device(assemblies, device: str | torch.device = "cuda") -> SharedIndex:
    """``SharedIndex(assemblies)`` computed on ``device``: a SharedIndex
    whose arrays came off the device, equal to the host one."""
    if not assemblies:
        raise ValueError("need at least one assembly")
    dev = torch.device(device)
    n_asm = len(assemblies)
    lens = [a.hash.shape[0] for a in assemblies]
    h = _stream_tensors([a.hash.view(np.int64) for a in assemblies], dev, np.int64)
    asm = torch.from_numpy(np.repeat(np.arange(n_asm, dtype=np.int64), lens)).to(dev)
    ctg = _stream_tensors([a.ctg for a in assemblies], dev, np.int32)
    pos = _stream_tensors([a.pos for a in assemblies], dev, np.int64)
    dead = torch.zeros(h.shape[0], dtype=torch.bool, device=dev)
    t_h, t_ctg, t_pos, nid = _shared_filter(h, asm, ctg, pos, dead, n_asm)

    shared = SharedIndex.__new__(SharedIndex)
    shared.assemblies = assemblies
    shared.node_hash = t_h[:, 0].cpu().numpy().view(np.uint64)
    shared.pos = t_pos.t().contiguous().cpu().numpy()
    shared.ctg = t_ctg.t().contiguous().cpu().numpy()
    nid_np = nid.cpu().numpy()
    shared.streams = []
    cursor = 0
    for a, m in enumerate(lens):
        ids = nid_np[cursor : cursor + m]
        keep = ids >= 0
        shared.streams.append((ids[keep].astype(np.int32), assemblies[a].ctg[keep]))
        cursor += m
    return shared


def build_graph_device(shared: SharedIndex, device: str | torch.device = "cuda"):
    """``graph.mingraph.build_graph(shared)`` with the edge tally on
    ``device``: equal edges, orientation, order, weights and support.  The
    graph labels its components on the same device."""
    from ntjoin_tpu_torch.graph.mingraph import DeviceMinimizerGraph

    dev = torch.device(device)
    n_asm = len(shared.assemblies)
    lens = [ids.shape[0] for ids, _ in shared.streams]
    src, dst, counts = _edge_tally_exact(
        _stream_tensors([ids for ids, _ in shared.streams], dev, np.int64),
        _stream_tensors([c for _, c in shared.streams], dev, np.int32),
        torch.from_numpy(np.repeat(np.arange(n_asm, dtype=np.int64), lens)).to(dev),
        shared.num_nodes, n_asm,
    )
    src = src.cpu().numpy().astype(np.int32)
    dst = dst.cpu().numpy().astype(np.int32)
    counts = counts.cpu().numpy().astype(np.int64)
    ne = counts.shape[0]

    # weights: the host builder's np.add.reduceat over each edge's supporting
    # assemblies in ascending order, replayed from the counts (reduceat's
    # float association is not plain left to right, so the reduction itself
    # is replayed)
    weights = np.array([a.weight for a in shared.assemblies])
    if ne:
        seq = np.repeat(np.tile(weights, ne), counts.ravel())
        starts = np.concatenate([[0], np.cumsum(counts.sum(axis=1))[:-1]]).astype(np.int64)
        weight = np.add.reduceat(seq, starts)
    else:
        weight = np.zeros(0)
    support = np.zeros(ne, np.int64)
    for a in range(n_asm):
        support |= np.where(counts[:, a] > 0, np.int64(1) << a, 0)
    return DeviceMinimizerGraph(shared.num_nodes, src, dst, weight, support,
                                node_hash=shared.node_hash, device=dev)
