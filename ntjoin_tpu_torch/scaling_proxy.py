"""Shard balance of the multi-device sketch and the cost of the hash-bucket
verdict, on one device repeated as shards: the counterpart of
``scripts/scaling_proxy.py``.

    python -m ntjoin_tpu_torch.scaling_proxy [--device cuda|cpu] [--bases N]
        [--widths W,W,...]

A mesh of the port is a list of devices that may repeat one, so the shards
of ``nd`` = 1, 2, 4 and 8 are ``[device] * nd`` (default ``cuda``, which
needs a GPU; ``--device cpu`` runs the kernels' plain versions).  Measured:

* ``devices``: ``parallel/mesh.py`` ``sketch_sharded`` of one seeded record
  (``--bases``, default 4,000,000, k=32, w=250, six N runs of 2,500) held
  equal to ``ops/nthash_np.sketch_codes``; the windows each shard owns
  (``_tile_record``), their max over their mean, and the least wall of
  three calls;
* ``filter``: ``parallel/distributed.py`` ``distributed_survive_sharded``
  against the replicated ``distributed_survive`` in one process of 8 shards
  on 8 x 4,096 seeded entries (three assemblies, ``verdict_inputs``): verdicts equal, each
  shard's buffer against the replicated one, both walls (host clock around
  a synchronised call, the least of three after one warm-up) and, on
  a card, the verdict's device time (counter ``dist:verdict_us``);
* ``crossover``: the same at every width of ``--widths`` (entries a
  shard), and the first width at which the sharded verdict is no slower
  than the replicated one, or null if it is slower at every width.

The shards share one device, so the walls are partitioning overhead, not a
speedup; balance and buffer sizes do not depend on the hardware.  Prints one
JSON line.  Without a CUDA device and without ``--device cpu`` it exits 1
with "no CUDA device" on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ntjoin_tpu_torch.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.parallel.mesh import _tile_record, make_mesh, sketch_sharded
from ntjoin_tpu_torch.utils import timers

K, W = 32, 250
N_SHARDS = 8
N_ASM = 3
SHARD_COUNTS = (1, 2, 4, 8)
REPS = 3
WIDTHS = (4096, 16_384, 65_536, 262_144, 1_048_576, 4_194_304)
CAVEAT = ("the shards share one {device}: wall is partitioning overhead, not a "
          "speedup; the balance and buffer columns are the hardware-independent "
          "scaling signal")


def proxy_codes(n: int, seed: int = 5) -> np.ndarray:
    """The original's record: n random bases with six interior N runs of
    2,500, which the stream split must keep exact."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for s in rng.integers(0, n - 3000, 6):
        codes[s : s + 2500] = 4
    return codes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _walls(fn, device: torch.device) -> list[float]:
    """Sorted host-clock seconds of ``REPS`` synchronised calls after a
    warm-up call."""
    fn()
    out = []
    for _ in range(REPS):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append(time.perf_counter() - t0)
    return sorted(out)


def _verdict_ms(fn, ms: list[float]):
    """``fn`` recording each call's ``dist:verdict_us``, on a card, into
    ``ms`` as milliseconds."""
    def call():
        with timers.recording(True):
            fn()
        if "dist:verdict_us" in timers.COUNTERS:
            ms.append(timers.COUNTERS["dist:verdict_us"] / 1e3)
    return call


def balance_table(codes: np.ndarray, device: str) -> dict:
    """Per shard count: the sharded sketch's least wall, each shard's owned
    windows and max over mean; each sketch held equal to the host
    sketcher's."""
    ref = sketch_codes(codes, K, W)
    out = {}
    for nd in SHARD_COUNTS:
        mesh = make_mesh([device] * nd)
        got = sketch_sharded(codes, K, W, mesh)
        if not (np.array_equal(got.positions, ref.positions)
                and np.array_equal(got.hashes, ref.hashes)):
            raise RuntimeError(f"sketch_sharded over {nd} shard(s) differs from sketch_codes")
        walls = _walls(lambda: sketch_sharded(codes, K, W, mesh), mesh[0])
        own = _tile_record(codes, nd, K, W)[2].astype(np.int64)
        out[nd] = {"wall_s": walls[0], "wall_median_s": walls[len(walls) // 2],
                   "windows_per_shard": own.tolist(),
                   "balance_max_over_mean": float(own.max() / max(own.mean(), 1e-9))}
    return out


def verdict_inputs(width: int, seed: int = 5, n_shards: int = N_SHARDS):
    """(hashes as int64 bits, assemblies, alive), each (n_shards, width):
    64-bit hashes drawn from a pool a third as large as the entries, so
    that a hash recurs across the three assemblies as a shared minimizer
    does and some survive (the original's all-distinct hashes leave no
    survivor); every entry alive."""
    rng = np.random.default_rng(seed)
    n_el = n_shards * width
    pool = rng.integers(0, 1 << 63, max(1, n_el // N_ASM), dtype=np.int64)
    pool ^= rng.integers(0, 2, pool.size, dtype=np.int64) << 63  # the top bit too
    h = pool[rng.integers(0, pool.size, n_el)]
    asm = rng.integers(0, N_ASM, n_el).astype(np.int32)
    alive = np.ones(n_el, dtype=bool)
    return tuple(x.reshape(n_shards, width) for x in (h, asm, alive))


def verdict_cell(width: int, device: str) -> dict:
    """The sharded and the replicated verdict of one process's 8 shards on
    ``device``: equal verdicts, buffers, walls and device times."""
    h, asm, alive = verdict_inputs(width)
    dev = make_mesh([device])[0]
    bw = pd.bucket_width_for_rows(h, alive, N_SHARDS)
    rows = [torch.from_numpy(x).to(dev) for x in (h, asm, alive)]
    sharded = pd.distributed_survive_sharded(*rows, N_ASM, bw).reshape(-1)
    replicated = pd.distributed_survive(*rows, N_ASM)
    if not torch.equal(sharded.cpu(), replicated.cpu()):
        raise RuntimeError(f"sharded and replicated verdicts differ at width {width}")
    sharded_ms, replicated_ms = [], []
    sharded_walls = _walls(_verdict_ms(
        lambda: pd.distributed_survive_sharded(*rows, N_ASM, bw), sharded_ms), dev)
    replicated_walls = _walls(_verdict_ms(
        lambda: pd.distributed_survive(*rows, N_ASM), replicated_ms), dev)
    n_el = h.size
    return {
        "total_entries": n_el,
        "per_device_buffer_sharded": N_SHARDS * bw,
        "per_device_buffer_replicated": n_el,
        "memory_ratio": N_SHARDS * bw / n_el,
        "sharded_wall_s": sharded_walls[0],
        "sharded_wall_median_s": sharded_walls[len(sharded_walls) // 2],
        "replicated_wall_s": replicated_walls[0],
        "replicated_wall_median_s": replicated_walls[len(replicated_walls) // 2],
        "sharded_verdict_ms": min(sharded_ms) if sharded_ms else "not measured (no card)",
        "replicated_verdict_ms": min(replicated_ms) if replicated_ms else "not measured (no card)",
        "survivors": int(sharded.sum()),
        "verdicts_equal": True,
    }


def crossover(cells: list[dict]) -> int | None:
    """Entries a shard at the first cell where the sharded verdict's wall
    is no longer than the replicated one's, or None."""
    for c in cells:
        if c["sharded_wall_s"] <= c["replicated_wall_s"]:
            return c["total_entries"] // N_SHARDS
    return None


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ntjoin_tpu_torch.scaling_proxy")
    ap.add_argument("--device", default="cuda", help="the device every shard is on")
    ap.add_argument("--bases", type=int, default=4_000_000)
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)),
                    help="entries a shard of the crossover sweep, comma separated")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    widths = [int(x) for x in args.widths.split(",")]
    name = torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu"
    out = {"bases": args.bases, "k": K, "w": W, "device": name,
           "devices": balance_table(proxy_codes(args.bases), args.device)}
    sweep = [verdict_cell(wd, args.device) for wd in widths]
    out["filter"] = (sweep[widths.index(4096)] if 4096 in widths
                     else verdict_cell(4096, args.device))
    out["crossover"] = {"widths": widths, "cells": sweep,
                        "sharded_no_slower_from_width": crossover(sweep)}
    out["caveat"] = CAVEAT.format(device=name)
    return out


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("scaling_proxy: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs the plain versions", file=sys.stderr)
        return 1
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
