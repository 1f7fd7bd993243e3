"""The port's path passes (torch ops on the CPU) against the JAX package's
device passes and the host oracle: the escalating branch filter, the chain
ranking walker and ``find_paths``.  Masks, node lists and ranks are exact
(tolerance zero); weights compare in float64 as the host does."""
import copy

import numpy as np
import pytest

from ntjoin_tpu.graph.mingraph import MinimizerGraph
from ntjoin_tpu.graph.paths import _walk_chain, escalating_branch_filter
from ntjoin_tpu.graph.paths import find_paths as host_find_paths
from ntjoin_tpu.ops import device_paths as jax_paths
from ntjoin_tpu_torch.graph.paths import find_paths
from ntjoin_tpu_torch.ops import device_paths as dp
from ntjoin_tpu_torch.utils import timers


def _random_graph(rng, n_nodes, n_edges, n_asm=2):
    """Random simple undirected graph (tests/test_device_paths.py)."""
    pairs = set()
    src, dst = [], []
    while len(src) < n_edges:
        a, b = rng.integers(0, n_nodes, 2)
        if a == b or (min(a, b), max(a, b)) in pairs:
            continue
        pairs.add((min(a, b), max(a, b)))
        src.append(int(a))
        dst.append(int(b))
    weight = rng.integers(1, 6, len(src)).astype(np.float64)
    support = rng.integers(1, 1 << n_asm, len(src)).astype(np.int64)
    return MinimizerGraph(n_nodes, np.array(src, np.int64), np.array(dst, np.int64),
                          weight, support)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_escalate_filter_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    g_host = _random_graph(rng, 400, 700)
    comp = g_host.components()
    g_port = copy.deepcopy(g_host)
    jax_alive = jax_paths.escalate_filter_device(copy.deepcopy(g_host), comp, 2.0, 5.0)
    escalating_branch_filter(g_host, comp, 2.0, 5.0)
    with timers.recording(True):
        alive = dp.escalate_filter_device(g_port, comp, 2.0, 5.0, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["graph:escalate@cpu"] == 1
    assert alive.dtype == bool and np.array_equal(alive, g_host.alive)
    assert np.array_equal(alive, jax_alive)
    assert 0 < int(alive.sum()) < alive.shape[0]


@pytest.mark.parametrize("scale", [0.1, 0.3])
def test_escalate_filter_fractional_weights(scale):
    """Weights not exact in float32 (the JAX pass raises on them): the port
    compares in float64 and matches the host, with no route and no raise."""
    rng = np.random.default_rng(9)
    g_host = _random_graph(rng, 300, 520)
    g_host.weight = g_host.weight * scale
    g_port = copy.deepcopy(g_host)
    comp = g_host.components()
    with pytest.raises(ValueError):
        jax_paths.escalate_filter_device(copy.deepcopy(g_host), comp, scale, 5 * scale)
    escalating_branch_filter(g_host, comp, scale, 5 * scale)
    alive = dp.escalate_filter_device(g_port, comp, scale, 5 * scale, "cpu")
    assert np.array_equal(alive, g_host.alive)


def _chain_forest():
    # chains 0-1-2-3-4, 5-6, 7 alone, 8-9-10; cycle 11-12-13-11
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (5, 6), (8, 9), (9, 10),
             (11, 12), (12, 13), (13, 11)]
    n = 14
    n1, n2, e1, e2 = (np.full(n, -1, np.int32) for _ in range(4))
    for eid, (a, b) in enumerate(edges):
        for u, v in ((a, b), (b, a)):
            if n1[u] < 0:
                n1[u], e1[u] = v, eid
            elif n2[u] < 0:
                n2[u], e2[u] = v, eid
    return n1, n2, e1, e2


def test_rank_walker_matches_walk_chain():
    n1, n2, e1, e2 = _chain_forest()
    with timers.recording(True):
        walker = dp.make_rank_walker(n1, n2, e1, e2, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["graph:rank@cpu"] == 1
    for source, length in [(0, 5), (4, 5), (5, 2), (6, 2), (8, 3), (10, 3)]:
        ref_nodes, ref_eids = _walk_chain(n1, n2, e1, e2, source, length)
        got_nodes, got_eids = walker.walk(source)
        assert got_nodes.tolist() == ref_nodes.tolist(), source
        assert got_eids.tolist() == ref_eids.tolist(), source


def test_chain_ranks_match_jax():
    n1, n2, _, _ = _chain_forest()
    term, remain = dp.chain_ranks_device(n1, n2, "cpu")
    j_term, j_remain = jax_paths.chain_ranks_device(n1, n2)
    assert term.tolist() == np.asarray(j_term).tolist()
    assert remain.tolist() == np.asarray(j_remain).tolist()


class _Asm:
    def __init__(self, weight):
        self.weight = weight


class _Shared:
    """What find_paths reads of a SharedIndex: assembly weights and
    positions."""

    def __init__(self, rng, n_nodes, weights):
        self.assemblies = [_Asm(w) for w in weights]
        self.pos = [rng.permutation(n_nodes).astype(np.int64) for _ in weights]


@pytest.mark.parametrize("seed,weights,n_min", [
    (3, (2.0, 1.0), 2.0),
    (4, (2.0, 1.0), 2.0),
    (5, (0.1, 0.3), 0.1),
])
def test_find_paths_matches_host_and_jax(seed, weights, n_min):
    """Chains, branches and circular components; equal paths, component
    count and alive mask."""
    rng = np.random.default_rng(seed)
    n_nodes = 300
    g = _random_graph(rng, n_nodes, 360)
    g.weight = g.weight * weights[1]
    shared = _Shared(rng, n_nodes, weights)
    g_host, g_jax, g_port = (copy.deepcopy(g) for _ in range(3))
    host_paths, host_n = host_find_paths(g_host, shared, n_min, device=False)
    jax_paths_, jax_n = host_find_paths(g_jax, shared, n_min, device=True)
    with timers.recording(True):
        got, n = find_paths(g_port, shared, n_min, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["graph:cc@cpu"] == 2 and counts["graph:escalate@cpu"] == 1 and counts["graph:rank@cpu"] == 1
    assert n == host_n == jax_n
    assert [p for p, _ in got] == [p for p, _ in host_paths] == [p for p, _ in jax_paths_]
    assert np.array_equal(g_port.alive, g_host.alive)
    assert len(got) > 3
    for (p, view), (_, host_view) in zip(got, host_paths):
        assert view.shortest_path(p[0], p[-1]) == host_view.shortest_path(p[0], p[-1]) == p
        assert view.path_support_masks(p) == host_view.path_support_masks(p)
