"""Connected components on a torch device: min-hooking plus pointer
doubling.  Port of ``ntjoin_tpu/ops/cc_jax.py``.

Each round hooks the larger parent of every edge's ends onto the smaller one
(``scatter_reduce_`` amin), then compresses by pointer doubling.  Parents
only decrease and start at the node itself, so ``parent[x] <= x`` always,
every chain of parents falls strictly, and ceil(log2 n) doublings compress it
fully; a root is its component's smallest node id.  One sync per round asks
whether an edge still joins two roots.  Dense labels from ``torch.unique``
therefore ascend with the component's smallest node, as the host's
(``MinimizerGraph.components``) do.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu_torch.utils import timers


def connected_components(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """Dense component label per node (isolated nodes included), int64,
    identical to ``MinimizerGraph.components`` on the same edges."""
    dev = torch.device(device)
    timers.count("graph:cc@" + dev.type)
    if num_nodes == 0:
        return np.empty(0, dtype=np.int64)
    s = torch.from_numpy(np.asarray(src, dtype=np.int64)).to(dev)
    d = torch.from_numpy(np.asarray(dst, dtype=np.int64)).to(dev)
    parent = torch.arange(num_nodes, dtype=torch.int64, device=dev)
    doublings = max(1, (num_nodes - 1).bit_length())
    while s.shape[0]:
        ps, pd = parent[s], parent[d]
        parent.scatter_reduce_(0, torch.maximum(ps, pd), torch.minimum(ps, pd), reduce="amin")
        for _ in range(doublings):
            parent = parent[parent]
        timers.count("graph:cc_rounds")
        if not bool((parent[s] != parent[d]).any()):
            break
    return torch.unique(parent, return_inverse=True)[1].cpu().numpy()
