"""Multi-shard dry run of the port: the counterpart of
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n_devices, device)`` runs, on ``n_devices`` shards of one
device (``cuda`` for the kernels on a card, ``cpu`` for their plain
versions), each against an oracle, and raises at the first disagreement:

1. the sequence-parallel sketch of an N-rich record (N runs longer than the
   halo) against ``nthash_np.sketch_codes``;
2. ``distributed_unique_count`` over that sketch against ``np.unique``;
3. the hash-bucket verdict in one process over the shards (the exchange a
   local permutation) against the replicated one and a ``Counter`` oracle;
4. ``find_paths`` with the torch passes on the device against the host;
5. ``edge_tally`` on a chain.

    python -m ntjoin_tpu_torch.dryrun [n_devices] [device]
"""
from __future__ import annotations

import collections
import copy
import sys

import numpy as np
import torch

from ntjoin_tpu_torch.graph.mingraph import MinimizerGraph
from ntjoin_tpu_torch.graph.paths import find_paths
from ntjoin_tpu_torch.ops.filters import edge_tally
from ntjoin_tpu_torch.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.parallel.mesh import distributed_unique_count, make_mesh, sketch_sharded


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the multi-shard steps on ``n_devices`` shards of ``device``."""
    mesh = make_mesh([device] * n_devices)
    dev = mesh[0]

    # 1. the tiled sketch of an N-rich record
    k, w = 15, 10
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=2048 * n_devices).astype(np.uint8)
    for start in rng.integers(0, codes.size - 300, size=4):
        codes[start : start + 250] = 4  # N runs longer than the halo
    got = sketch_sharded(codes, k, w, mesh)
    ref = sketch_codes(codes, k, w)
    _check(np.array_equal(got.positions, ref.positions), "sharded sketch positions")
    _check(np.array_equal(got.hashes, ref.hashes), "sharded sketch hashes")

    # 2. the gathered distinct count over the sketch, one padded row a shard
    per = -(-len(got.hashes) // n_devices)
    vals = np.zeros(n_devices * per, dtype=np.uint64)
    vals[: len(got.hashes)] = got.hashes
    rows = torch.from_numpy(vals.view(np.int64).reshape(n_devices, per))
    uniq, total = distributed_unique_count(mesh, rows, torch.full((n_devices,), per))
    _check(bool((uniq == len(np.unique(vals))).all()), "distributed unique count")
    _check(bool((total == n_devices * per).all()), "distributed total count")

    # 3. the verdict of two assemblies by hash bucket, against the replicated
    #    one and the host
    width = 64
    rng2 = np.random.default_rng(1)
    n_el = n_devices * width
    half = n_el // 2
    lo = rng2.integers(0, 500, n_el)
    h = lo | ((lo % 7) << 32)  # a spread over the buckets
    asm = (np.arange(n_el) >= half).astype(np.int64)
    alive = np.ones(n_el, bool)
    t = [torch.from_numpy(x.reshape(n_devices, width)).to(dev) for x in (h, asm, alive)]
    bw = pd.bucket_width_for_rows(h.reshape(n_devices, width), alive.reshape(n_devices, width),
                                  n_devices)
    verdict = pd.distributed_survive_sharded(*t, n_asm=2, bucket_width=bw).reshape(-1).cpu()
    _check(torch.equal(verdict, pd.distributed_survive(*t, n_asm=2).cpu()),
           "sharded against replicated verdict")
    c0, c1 = collections.Counter(lo[:half].tolist()), collections.Counter(lo[half:].tolist())
    expect = np.array([c0[int(v)] == 1 and c1[int(v)] == 1 for v in lo])
    _check(np.array_equal(verdict.numpy(), expect), "verdict against the host")

    # 4. the path passes on the device against the host
    rngp = np.random.default_rng(5)
    nn = 200
    src, dst, seen = [], [], set()
    while len(src) < 240:
        a, b = (int(x) for x in rngp.integers(0, nn, 2))
        if a == b or (min(a, b), max(a, b)) in seen:
            continue
        seen.add((min(a, b), max(a, b)))
        src.append(a)
        dst.append(b)
    graph = MinimizerGraph(nn, np.array(src), np.array(dst),
                           rngp.integers(1, 5, len(src)).astype(np.float64),
                           np.ones(len(src), np.int64))

    class _Assembly:
        def __init__(self, weight):
            self.weight = weight

    class _Shared:
        assemblies = [_Assembly(2.0), _Assembly(1.0)]
        pos = [rngp.permutation(nn).astype(np.int64), rngp.permutation(nn).astype(np.int64)]

    host_paths, host_n = find_paths(copy.deepcopy(graph), _Shared(), 2.0, device=None)
    dev_paths, dev_n = find_paths(graph, _Shared(), 2.0, device=dev)
    _check(dev_n == host_n and [p for p, _ in dev_paths] == [p for p, _ in host_paths],
           "device path passes")

    # 5. the edge tally of one chain
    ids = torch.arange(len(got.hashes) % 97 + 16, device=dev)
    zeros = torch.zeros_like(ids)
    *_, valid = edge_tally(ids, zeros, zeros, np.array([2.0]), int(ids.max()) + 1)
    _check(int(valid.sum()) == len(ids) - 1, "edge tally")


if __name__ == "__main__":
    args = sys.argv[1:]
    dryrun_multichip(int(args[0]) if args else 8, args[1] if len(args) > 1 else "cuda")
    print("dryrun_multichip: ok")
