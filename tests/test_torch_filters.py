"""The port's filters and edge tally (``ntjoin_tpu_torch/ops/filters.py``) on
the CPU against ``ntjoin_tpu/ops/filters_jax.py`` and the host
build_graph: masks equal, the tally's five arrays equal, the same refusals, and
40 assemblies where the JAX op stops at 32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
from ntjoin_tpu.graph.mingraph import build_graph
from ntjoin_tpu.ops import filters_jax
from ntjoin_tpu_torch.ops import filters


def _pairs(vals):
    v = np.asarray(vals, dtype=np.uint64)
    return (jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


def _t(vals):
    return torch.from_numpy(np.asarray(vals, dtype=np.uint64).view(np.int64))


def _hashes(rng, n, distinct):
    """n uint64 hashes from ``distinct`` values, half of them with the top
    bit set (negative as int64)."""
    pool = rng.integers(0, 1 << 63, size=distinct, dtype=np.uint64)
    pool[::2] |= np.uint64(1 << 63)
    return pool[rng.integers(0, distinct, size=n)]


@pytest.mark.parametrize("n,distinct", [(300, 120), (1000, 900), (1, 1), (0, 1)])
def test_unique_mask_matches_jax(n, distinct):
    vals = _hashes(np.random.default_rng(n), n, distinct)
    got = filters.unique_mask(_t(vals)).numpy()
    u, c = np.unique(vals, return_counts=True)
    assert got.tolist() == np.isin(vals, u[c == 1]).tolist()
    if n:
        assert got.tolist() == np.asarray(filters_jax.unique_mask(*_pairs(vals))).tolist()


@pytest.mark.parametrize("nq,nr", [(150, 200), (40, 1), (30, 0)])
def test_member_mask_matches_jax(nq, nr):
    rng = np.random.default_rng(nq + nr)
    ref = _hashes(rng, nr, max(nr, 1))
    q = np.concatenate([ref[: nq // 3], _hashes(rng, nq - nq // 3, 500)])
    got = filters.member_mask(_t(q), _t(ref)).numpy()
    assert got.tolist() == np.isin(q, ref).tolist()
    if nr:
        assert got.tolist() == np.asarray(
            filters_jax.member_mask(*_pairs(q), *_pairs(ref))).tolist()


def _tally_dict(out):
    g_lo, g_hi, weight, support, valid = (np.asarray(x) for x in out)
    return {(int(a), int(b)): (float(wt), int(s))
            for a, b, wt, s in zip(g_lo[valid], g_hi[valid], weight[valid], support[valid])}


def _same_arrays(got, want):
    for g, r in zip(got, want):
        assert np.asarray(g).tolist() == np.asarray(r).tolist()


def test_edge_tally_repeated_same_assembly_adjacency():
    """A pair adjacent twice in one assembly sets that assembly's bit once
    (the case of ``tests/test_filters_jax.py``)."""
    ids, ctg, asm = [1, 2, 1, 1, 2], [0] * 5, [0, 0, 0, 1, 1]
    got = filters.edge_tally(torch.tensor(ids), torch.tensor(ctg), torch.tensor(asm),
                             np.array([2.0, 1.0]), 3)
    want = filters_jax.edge_tally(*(jnp.asarray(np.array(x, np.int32)) for x in (ids, ctg, asm)),
                                  np.array([2.0, 1.0]), 3)
    _same_arrays(got, want)
    assert _tally_dict(got) == {(1, 2): (5.0, 0b11)}


def _assemblies(n_asm, n_hash=100, seed=2):
    rng = np.random.default_rng(seed)
    hashes = rng.permutation(np.arange(n_hash, dtype=np.uint64) + 1000)

    def one(a):
        order = np.arange(n_hash) if a == 0 else np.concatenate(
            [np.arange(n_hash // 2), n_hash // 2 + rng.permutation(n_hash - n_hash // 2)])
        h = hashes[order]
        return AssemblySketch.from_stream(
            f"a{a}", float(1 + a % 2), ["c0", "c1"], h, np.arange(n_hash, dtype=np.int64) * 37,
            (np.arange(n_hash) >= n_hash // 2).astype(np.int32))

    shared = SharedIndex([one(a) for a in range(n_asm)])
    ids, ctgs, asms = [], [], []
    for a, (node_ids, ctg_ids) in enumerate(shared.streams):
        ids.append(node_ids)
        ctgs.append(ctg_ids)
        asms.append(np.full(len(node_ids), a, dtype=np.int32))
    streams = [np.concatenate(x) for x in (ids, ctgs, asms)]
    weights = np.array([a.weight for a in shared.assemblies])
    return shared, streams, weights


def _host_dict(shared):
    host = build_graph(shared)
    return {tuple(sorted((int(s), int(d)))): (float(wt), int(m))
            for s, d, wt, m in zip(host.src, host.dst, host.weight, host.support_mask)}


def test_edge_tally_matches_jax_and_host_graph():
    shared, streams, weights = _assemblies(2)
    got = filters.edge_tally(*(torch.from_numpy(x) for x in streams), weights, shared.num_nodes)
    want = filters_jax.edge_tally(*(jnp.asarray(x) for x in streams), weights, shared.num_nodes)
    _same_arrays(got, want)
    assert _tally_dict(got) == _host_dict(shared)


def test_edge_tally_forty_assemblies_against_the_host():
    """The int64 support mask holds 40 assemblies, where the JAX op's uint32
    lane refuses; 64 are refused in the same words."""
    shared, streams, weights = _assemblies(40)
    got = filters.edge_tally(*(torch.from_numpy(x) for x in streams), weights, shared.num_nodes)
    assert _tally_dict(got) == _host_dict(shared)
    assert max(s for _, s in _tally_dict(got).values()) >= 1 << 39
    with pytest.raises(ValueError, match="at most 32 assemblies"):
        filters_jax.edge_tally(*(jnp.asarray(x) for x in streams), weights, shared.num_nodes)
    with pytest.raises(ValueError, match=r"at most 63 assemblies \(got 64\)"):
        filters.edge_tally(*(torch.from_numpy(x) for x in streams), np.ones(64), shared.num_nodes)


@pytest.mark.parametrize("weights,n", [([0.1], 3), ([2.0], 1 << 23)])
def test_edge_tally_refuses_inexact_weights(weights, n):
    """Fractional weights, or a total of 2^24 or more, are refused by both."""
    ids = np.arange(n, dtype=np.int32)
    zeros = np.zeros(n, np.int32)
    for op, arr in ((filters.edge_tally, torch.from_numpy), (filters_jax.edge_tally, np.asarray)):
        with pytest.raises(ValueError, match="byte-exact"):
            op(arr(ids), arr(zeros), arr(zeros), np.array(weights), n)
