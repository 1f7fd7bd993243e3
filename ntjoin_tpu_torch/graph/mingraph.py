"""The minimizer graph of the port: the host ``MinimizerGraph`` whose
components are labelled on a torch device (``ops/cc.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu.graph.mingraph import MinimizerGraph
from ntjoin_tpu_torch.ops.cc import connected_components


class DeviceMinimizerGraph(MinimizerGraph):
    """``MinimizerGraph`` with ``components`` computed on ``device``; the
    labels are identical to the host's."""

    def __init__(self, num_nodes, src, dst, weight, support_mask, node_hash=None,
                 device: str | torch.device = "cuda"):
        super().__init__(num_nodes, src, dst, weight, support_mask, node_hash=node_hash)
        self.device = torch.device(device)

    def components(self, edge_mask: np.ndarray | None = None) -> np.ndarray:
        mask = self.alive if edge_mask is None else edge_mask
        return connected_components(self.num_nodes, self.src[mask], self.dst[mask], self.device)
