"""The port's shared index and graph build (torch ops on the CPU) against the
JAX package's device index and the host ``SharedIndex``/``build_graph``.
Integer and float outputs alike: comparisons are exact (tolerance zero)."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
from ntjoin_tpu.graph import mingraph
from ntjoin_tpu.ops import device_index as jax_index
from ntjoin_tpu_torch.graph.mingraph import DeviceMinimizerGraph
from ntjoin_tpu_torch.ops import device_index as di
from ntjoin_tpu_torch.utils import timers


def _mk_assemblies(seed, n_asm=3, n_ctg=4, per_ctg=200, dup_frac=0.1):
    """Random assemblies over a shared hash pool with planted duplicates
    (the construction of tests/test_device_index.py), some hashes with the
    top bit set so that unsigned order matters."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**63, size=per_ctg * n_ctg * 4, dtype=np.uint64)
    pool = np.unique(pool)[: per_ctg * n_ctg * 2]
    pool[::7] |= np.uint64(1 << 63)
    assemblies = []
    for a in range(n_asm):
        hs, ps, cs = [], [], []
        for c in range(n_ctg):
            m = per_ctg + int(rng.integers(-50, 50))
            h = rng.choice(pool, size=m, replace=False)
            ndup = int(m * dup_frac)
            if ndup:
                h[rng.choice(m, ndup, replace=False)] = rng.choice(h, ndup)
            p = np.sort(rng.choice(10**6, size=m, replace=False))
            hs.append(h)
            ps.append(p)
            cs.append(np.full(m, c, np.int32))
        assemblies.append(AssemblySketch.from_stream(
            f"asm{a}", float(a + 1), [f"c{c}" for c in range(n_ctg)],
            np.concatenate(hs), np.concatenate(ps), np.concatenate(cs),
        ))
    return assemblies


def _same_index(got, want):
    assert got.node_hash.dtype == want.node_hash.dtype
    assert np.array_equal(got.node_hash, want.node_hash)
    assert got.pos.dtype == want.pos.dtype and np.array_equal(got.pos, want.pos)
    assert got.ctg.dtype == want.ctg.dtype and np.array_equal(got.ctg, want.ctg)
    assert len(got.streams) == len(want.streams)
    for (gi, gc), (wi, wc) in zip(got.streams, want.streams):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert np.array_equal(gc, wc)


def _same_graph(got, want):
    assert got.num_nodes == want.num_nodes
    assert got.src.dtype == want.src.dtype and np.array_equal(got.src, want.src)
    assert got.dst.dtype == want.dst.dtype and np.array_equal(got.dst, want.dst)
    assert got.weight.dtype == want.weight.dtype
    assert np.array_equal(got.weight, want.weight)  # float64, bit for bit
    assert np.array_equal(got.support_mask, want.support_mask)
    assert np.array_equal(got.node_hash, want.node_hash)


@contextlib.contextmanager
def _no_host_route():
    """Fail if the code inside reaches the host index or graph builder;
    the port's counters recorded."""
    def refuse(*a, **kw):
        raise AssertionError("host route taken")

    with timers.recording(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(SharedIndex, "__init__", refuse)
        mp.setattr(mingraph, "build_graph", refuse)
        yield


def _host(assemblies):
    shared = SharedIndex(assemblies)
    return shared, mingraph.build_graph(shared)


def _port(assemblies):
    with _no_host_route():
        shared = di.shared_index_device(assemblies, "cpu")
        graph = di.build_graph_device(shared, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts == {"graph:shared_filter@cpu": 1, "graph:edge_tally@cpu": 1}
    assert isinstance(graph, DeviceMinimizerGraph)
    return shared, graph


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_and_host(seed):
    assemblies = _mk_assemblies(seed)
    host, host_g = _host(assemblies)
    shared, g = _port(assemblies)
    _same_index(shared, host)
    _same_graph(g, host_g)
    assert g.num_edges > 100

    jax_shared = jax_index.shared_index_device(assemblies)
    _same_index(shared, jax_shared)
    jax_g = jax_index.build_graph_device(jax_shared)
    for name in ("src", "dst", "weight", "support_mask"):
        assert np.array_equal(getattr(g, name), getattr(jax_g, name)), name


@pytest.mark.parametrize("seed", [0, 1])
def test_survive_verdict_matches_jax(seed):
    """The sorted survive verdict with dead entries and unsorted assemblies,
    against the JAX function on the same input."""
    rng = np.random.default_rng(seed)
    n, n_asm = 3000, 3
    h = rng.integers(0, 400, size=n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    asm = rng.integers(0, n_asm, size=n).astype(np.int32)
    dead = rng.random(n) < 0.1
    order, survive = di.survive_verdict_sorted(
        torch.from_numpy(h.view(np.int64)), torch.from_numpy(asm), torch.from_numpy(dead), n_asm)
    lo = jnp.asarray((h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((h >> np.uint64(32)).astype(np.uint32))
    j_order, j_survive = jax_index.survive_verdict_sorted(
        lo, hi, jnp.asarray(asm), jnp.asarray(dead), n_asm)
    assert np.array_equal(order.numpy(), np.asarray(j_order))
    assert np.array_equal(survive.numpy(), np.asarray(j_survive))
    assert 0 < int(survive.sum()) < n


def test_fractional_weights():
    """Weights 0.1 and 0.3 (not exact in binary): the sums match the host
    float for float."""
    assemblies = _mk_assemblies(4)
    for a, wt in zip(assemblies, (0.1, 0.3, 0.1)):
        a.weight = wt
    host, host_g = _host(assemblies)
    shared, g = _port(assemblies)
    _same_index(shared, host)
    _same_graph(g, host_g)
    assert not np.array_equal(g.weight, g.weight.astype(np.float32).astype(np.float64))


def test_pair_adjacent_twenty_times():
    """One pair adjacent 20 times in one assembly's stream (past the JAX
    package's 4-bit count): exact weight and support, no host route."""
    a0 = AssemblySketch.from_stream("a0", 0.3, ["c"], np.array([5, 7, 9], np.uint64),
                                    np.arange(3, dtype=np.int64), np.zeros(3, np.int32))
    a1 = AssemblySketch.from_stream("a1", 2.0, ["c", "d"], np.array([9, 7, 5], np.uint64),
                                    np.arange(3, dtype=np.int64), np.array([0, 0, 1], np.int32))
    shared = SharedIndex.__new__(SharedIndex)
    shared.assemblies = [a0, a1]
    shared.node_hash = np.array([5, 7, 9], np.uint64)
    ids = np.array([0, 1] * 10 + [0, 2], np.int32)  # 0-1 adjacent 20 times, then 0-2
    shared.streams = [(ids, np.zeros(ids.shape[0], np.int32)),
                      (np.array([2, 1, 0], np.int32), np.array([0, 0, 1], np.int32))]
    want = mingraph.build_graph(shared)
    with _no_host_route():
        got = di.build_graph_device(shared, "cpu")
        counts = timers.trace_counts()["counters"]
    _same_graph(got, want)
    assert counts == {"graph:edge_tally@cpu": 1}
    first = int(np.flatnonzero((got.src == 0) & (got.dst == 1))[0])
    assert got.weight[first] == want.weight[first] and got.support_mask[first] == 1


def test_position_past_2_31():
    def asm(name, pos0):
        return AssemblySketch.from_stream(
            name, 1.0, ["c"], np.array([11, 22, 33], dtype=np.uint64),
            np.array([pos0, pos0 + 100, pos0 + 200], dtype=np.int64), np.zeros(3, np.int32))

    assemblies = [asm("a", 2**31 + 5), asm("b", 0), asm("c", 2**40)]
    host, host_g = _host(assemblies)
    shared, g = _port(assemblies)
    _same_index(shared, host)
    _same_graph(g, host_g)
    assert int(shared.pos.max()) == 2**40 + 200


def test_empty_intersection():
    a0 = AssemblySketch.from_stream("a0", 1.0, ["c"], np.array([1, 2], np.uint64),
                                    np.array([0, 10], np.int64), np.zeros(2, np.int32))
    a1 = AssemblySketch.from_stream("a1", 1.0, ["c"], np.array([3, 4], np.uint64),
                                    np.array([0, 10], np.int64), np.zeros(2, np.int32))
    host, host_g = _host([a0, a1])
    shared, g = _port([a0, a1])
    assert shared.num_nodes == 0 and g.num_edges == 0
    _same_index(shared, host)
    _same_graph(g, host_g)
    assert g.components().shape == (0,)
