"""The port's connected components (torch ops on the CPU) against the JAX
package's device components and ``MinimizerGraph.components``.  Labels are
integers: the comparison is exact (tolerance zero)."""
import numpy as np
import pytest

from ntjoin_tpu.graph.mingraph import MinimizerGraph, _pointer_jump_cc
from ntjoin_tpu.ops.cc_jax import connected_components_device
from ntjoin_tpu_torch.graph.mingraph import DeviceMinimizerGraph
from ntjoin_tpu_torch.ops import device_index as di
from ntjoin_tpu_torch.ops.cc import connected_components


@pytest.mark.parametrize("seed", [3, 4])
def test_random_sparse_graph(seed):
    """50,000 nodes, 60,000 random edges: many components, some deep."""
    rng = np.random.default_rng(seed)
    n, m = 50_000, 60_000
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    host = MinimizerGraph(n, src, dst, np.ones(m), np.ones(m, np.int64)).components()
    di.reset_counts()
    got = connected_components(n, src, dst, "cpu")
    assert di.COUNTS["cc"] == 1 and di.DEVICES["cc"] == "cpu" and di.COUNTS["cc_rounds"] >= 2
    assert got.tolist() == host.tolist()
    assert got.tolist() == connected_components_device(n, src, dst).tolist()
    assert got.tolist() == _pointer_jump_cc(n, src, dst).tolist()


def test_chains_and_isolated_nodes():
    src = np.array([0, 1, 5, 6], np.int32)
    dst = np.array([1, 2, 6, 7], np.int32)
    got = connected_components(9, src, dst, "cpu")
    assert got.tolist() == [0, 0, 0, 1, 2, 3, 3, 3, 4]
    assert got.tolist() == connected_components_device(9, src, dst).tolist()


def test_long_reversed_chain():
    """A path whose ids fall along it: the deepest parent chains."""
    n = 4097
    src = np.arange(n - 1, 0, -1, dtype=np.int32)
    dst = src - 1
    assert connected_components(n, src, dst, "cpu").tolist() == [0] * n


@pytest.mark.parametrize("n", [0, 1, 5])
def test_no_edges(n):
    e = np.empty(0, np.int32)
    assert connected_components(n, e, e, "cpu").tolist() == list(range(n))


def test_graph_components_use_the_port():
    """``DeviceMinimizerGraph.components`` runs the port's op, masks
    included."""
    src = np.array([0, 1, 3], np.int32)
    dst = np.array([1, 2, 4], np.int32)
    g = DeviceMinimizerGraph(6, src, dst, np.ones(3), np.ones(3, np.int64), device="cpu")
    di.reset_counts()
    assert g.components().tolist() == [0, 0, 0, 1, 1, 2]
    g.alive[1] = False
    assert g.components().tolist() == [0, 0, 1, 2, 2, 3]
    assert g.components(np.zeros(3, bool)).tolist() == list(range(6))
    assert di.COUNTS["cc"] == 3
