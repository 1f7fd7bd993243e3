"""Minimizer filters and the edge tally as torch ops on any device: the
counterpart of ``ntjoin_tpu/ops/filters_jax.py``.

* ``unique_mask``: within-assembly uniqueness (drop every hash occurring
  more than once; reference ``read_minimizers``, ``ntjoin_utils.py:182-192``),
* ``member_mask``: cross-assembly intersection (keep hashes present in the
  reference set; reference ``filter_minimizers``, ``ntjoin_utils.py:152-165``),
* ``edge_tally``: adjacency pairs with per-assembly support (reference
  ``build_graph``, ``ntjoin_utils.py:83-141``).

Hashes are int64 holding the uint64 bits, sorted unsigned as
``h ^ (1 << 63)``; the JAX package's uint32 lo/hi lanes have no
counterpart.  The support bitmask is int64, so up to 63 assemblies.  The
product path's exact tally is ``ops/device_index.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu_torch.ops.device_index import _lexsort

_SIGN = -(1 << 63)  # int64 bits of 1 << 63
_MAX_ASSEMBLIES = 63  # bits of the int64 support mask below its sign


def _scatter_back(order: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(sorted_vals).index_put_((order,), sorted_vals)


def unique_mask(h: torch.Tensor) -> torch.Tensor:
    """keep[i] = hash i occurs exactly once in ``h`` (original order)."""
    if h.numel() == 0:
        return torch.zeros(0, dtype=torch.bool, device=h.device)
    s, order = torch.sort(h ^ _SIGN, stable=True)
    same_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=h.device), s[1:] == s[:-1]])
    same_next = torch.cat([same_prev[1:], torch.zeros(1, dtype=torch.bool, device=h.device)])
    return _scatter_back(order, ~(same_prev | same_next))


def member_mask(q: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """mask[i] = query hash i is present in the reference hashes."""
    if ref.numel() == 0 or q.numel() == 0:
        return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    r, _ = torch.sort(ref ^ _SIGN)
    key = q ^ _SIGN
    at = torch.searchsorted(r, key).clamp_(max=r.shape[0] - 1)
    return r[at] == key


def edge_tally(node_ids, ctg_ids, asm_ids, weights, num_nodes: int):
    """Unordered adjacency pairs with summed weights and support bitmasks.

    Inputs are the concatenated per-assembly shared-minimizer streams (node
    id, contig id, assembly index per minimizer, in stream order).  Returns
    per consecutive-pair slot, grouped by sort, (lo, hi, weight, support,
    valid): a group's node pair, its float32 weight sum (a pair adjacent
    twice in one assembly counts twice), the bitmask of its supporting
    assemblies (each once), and whether the slot holds a group of live
    pairs (pairs crossing contig or assembly boundaries are dead).

    Weight exactness: the float32 scatter-add is unordered, so only integer
    weights with a total under 2^24 are exact; others raise, as in the JAX
    package.
    """
    w_np = np.asarray(weights, dtype=np.float64)
    n = int(np.shape(node_ids)[0])
    if w_np.size and (np.any(w_np != np.rint(w_np))
                      or np.abs(w_np).max() * max(n, 1) >= 2**24):
        raise ValueError(
            "edge_tally's unordered f32 weight sum is only byte-exact for "
            "small integer weights; use the host build_graph or the "
            "device_index exact tally for fractional weights"
        )
    n_asm = w_np.shape[0]
    if n_asm > _MAX_ASSEMBLIES:
        raise ValueError(
            f"device edge_tally supports at most {_MAX_ASSEMBLIES} assemblies (got {n_asm}):"
            " the support bitmask is an int64 lane — use the host"
            " graph.mingraph.build_graph path (unlimited) instead"
        )
    node_ids, ctg_ids, asm_ids = (torch.as_tensor(x).long() for x in (node_ids, ctg_ids, asm_ids))
    dev = node_ids.device
    nseg = max(n - 1, 0)
    if nseg == 0:
        e = torch.empty(0, dtype=torch.int64, device=dev)
        return e, e, torch.empty(0, dtype=torch.float32, device=dev), e, e.bool()
    u, v = node_ids[:-1], node_ids[1:]
    same = (ctg_ids[1:] == ctg_ids[:-1]) & (asm_ids[1:] == asm_ids[:-1])
    # dead slots sort last under the sentinel pair; the assembly as third key
    # puts a pair's repeats in one assembly next to each other, so that its
    # bit is added once
    lo = torch.where(same, torch.minimum(u, v), num_nodes)
    hi = torch.where(same, torch.maximum(u, v), num_nodes)
    a_all = asm_ids[:-1]
    order = _lexsort(a_all, hi, lo)
    lo_s, hi_s, a_s = lo[order], hi[order], a_all[order]
    alive = lo_s < num_nodes
    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_group = torch.cat([first, (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])])
    seg = new_group.long().cumsum(0) - 1  # group id per element
    w = torch.as_tensor(w_np, dtype=torch.float32, device=dev)[a_s]
    weight = torch.zeros(nseg, dtype=torch.float32, device=dev).index_add_(
        0, seg, torch.where(alive, w, 0.0))
    first_of_asm = new_group | torch.cat([first, a_s[1:] != a_s[:-1]])
    support = torch.zeros(nseg, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.where(alive & first_of_asm, torch.ones_like(a_s) << a_s, 0))
    # every element of a group shares its pair: the first one's stands for it
    starts = torch.nonzero(new_group).flatten()
    g_lo = torch.full((nseg,), num_nodes, dtype=torch.int64, device=dev)
    g_hi = g_lo.clone()
    g_lo[: starts.shape[0]] = lo_s[starts]
    g_hi[: starts.shape[0]] = hi_s[starts]
    valid = g_lo < num_nodes
    return g_lo, g_hi, weight, support, valid
