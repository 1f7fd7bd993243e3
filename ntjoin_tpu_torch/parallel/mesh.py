"""Sequence-parallel minimizer sketch across a list of torch devices: the
counterpart of ``ntjoin_tpu/parallel/mesh.py``.

A mesh is a list of ``torch.device``, one a shard, and it may name one
device several times: several shards on one card, or on the CPU, where the
kernels' plain versions run.  ``make_mesh`` never puts the CPU in place of a
card it cannot find.

A record is tiled along its *valid-k-mer stream*, not its bases (the JAX
arithmetic of ``_tile_record``): shard d owns the stream windows
[d*tw, (d+1)*tw) and takes one extra window on the left for d > 0 (the lead
window, ``ws - 1``, owned by shard d-1).  Its tile is exactly the bases
``codes[base_lo:base_hi]`` of its stream ranks ``lo_rank .. hi_rank``, so an
interior N run of any length shards exactly and no tile needs padding.

Each device sketches all of its tiles in one ``sketch_records_torch`` call,
one batch (the CUDA kernels on a card, the plain versions on the CPU); where
the mesh names more than one device, each device's call runs in a thread of
its own on a CUDA stream of its own.  Records split into tiles count in
``mesh:sharded_records``, their tiles in ``mesh:tiles`` and the calls in
``mesh:device_calls`` (counters of ``utils/timers.py``).

Seam rule.  A tile's emission list is the per-window rule "emit the first
window, then where the argmin moved" over exactly its ``lead + own``
windows.  Because the tile starts on a valid k-mer, those windows are the
global windows ``ws - lead .. ws + own - 1``, and the rule gives the global
list's emissions for them, except that the tile's first window always
emits.  For d > 0 that first emission belongs to the lead window: it is
dropped, and the positions are shifted by the tile's ``base_lo``.  Within
this rule the shards' lists concatenate to the record's list (held by
``tests/test_torch_mesh.py`` against the host sketcher and the JAX package).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ntjoin_tpu_torch.constants import CODE_INVALID
from ntjoin_tpu_torch.ops.nthash_np import Sketch
from ntjoin_tpu_torch.ops.sketch_records import sketch_records_torch
from ntjoin_tpu_torch.utils import timers

# Bases of records planned before their tiles are sketched (each device's
# tiles in one call), the JAX package's in-flight bound; the same whatever
# the devices.
MAX_INFLIGHT_BASES = 256_000_000
_SIGN = -(1 << 63)  # int64 bits of 1 << 63: x ^ _SIGN sorts as unsigned
_EMPTY = Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh over ``devices`` (names or ``torch.device``; one may repeat),
    every CUDA device by default.  Raises for a card that is not there."""
    n_cuda = torch.cuda.device_count()
    if devices is None:
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "(e.g. ['cpu'] * 4 for the plain versions)")
        devices = [f"cuda:{i}" for i in range(n_cuda)]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            index = d.index if d.index is not None else (
                torch.cuda.current_device() if n_cuda else 0)
            if index >= n_cuda:
                raise RuntimeError(f"make_mesh: {d} is not available "
                                   f"({n_cuda} CUDA device(s))")
            d = torch.device("cuda", index)
        elif d.type != "cpu":
            raise ValueError(f"make_mesh: no kernel or plain version for device {d}")
        mesh.append(d)
    if not mesh:
        raise ValueError("make_mesh: no device")
    return mesh


def _valid_kmer_runs(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The valid-k-mer stream as runs of consecutive starts: (first start,
    k-mers) of each stretch without an invalid base that holds a k-mer.
    Memory goes with the invalid bases, not the record's length (the JAX
    package's ``_valid_kmer_starts`` holds int64 arrays of the record's
    length)."""
    bad = np.flatnonzero(codes >= CODE_INVALID)
    lo = np.concatenate([[0], bad + 1])
    cnt = np.concatenate([bad, [codes.shape[0]]]) - lo - k + 1
    keep = cnt > 0
    return lo[keep], cnt[keep]


def _kmer_at(runs: tuple[np.ndarray, np.ndarray], ranks: np.ndarray) -> np.ndarray:
    """Start positions of the valid k-mers of the given stream ranks."""
    lo, cnt = runs
    ends = np.cumsum(cnt)
    run = np.searchsorted(ends, ranks, side="right")
    return lo[run] + ranks - (ends[run] - cnt[run])


def _tile_record(codes: np.ndarray, n_shards: int, k: int, w: int):
    """(base_lo, base_hi, own) per shard along the valid stream, each
    (n_shards,) int64: shard d's tile is ``codes[base_lo[d]:base_hi[d]]``
    and it owns ``own[d]`` windows (0: no tile); None for fewer than w valid
    k-mers."""
    runs = _valid_kmer_runs(codes, k)
    n_valid = int(runs[1].sum())
    ns = n_valid - w + 1  # global stream windows
    if ns <= 0:
        return None
    tw = -(-ns // n_shards)  # windows per shard
    d = np.arange(n_shards, dtype=np.int64)
    ws = d * tw
    own = np.clip(ns - ws, 0, tw)
    lead = (d > 0).astype(np.int64)  # extra left window for the seam
    has = own > 0
    lo_rank = np.where(has, ws - lead, 0)
    hi_rank = np.where(has, np.minimum(n_valid - 1, ws + own - 1 + w - 1), 0)
    base_lo = np.where(has, _kmer_at(runs, lo_rank), 0)
    base_hi = np.where(has, _kmer_at(runs, hi_rank) + k, 0)
    return base_lo, base_hi, own


def _plan(codes: np.ndarray, k: int, w: int, mesh: list[torch.device]):
    """What one record needs: None (no window), or a list of pieces
    (shard, tile codes, base_lo); one piece on shard 0 for a record too
    small to shard."""
    n = codes.shape[0]
    if k > n or w > n - k + 1:
        return None
    halo = w + k - 2
    if len(mesh) == 1 or n <= 4 * (halo + len(mesh)):
        return [(0, codes, 0)]  # too small to shard: whole on the first device
    tiles = _tile_record(codes, len(mesh), k, w)
    if tiles is None:  # fewer than w valid k-mers in the whole record
        return None
    base_lo, base_hi, own = tiles
    pieces = [(d, codes[base_lo[d] : base_hi[d]], int(base_lo[d]))
              for d in range(len(mesh)) if own[d] > 0]
    timers.count("mesh:sharded_records")
    timers.count("mesh:tiles", len(pieces))
    return pieces


def _sketch_on(dev: torch.device, codes: list[np.ndarray], k: int, w: int) -> list[Sketch]:
    if dev.type == "cuda":
        with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
            return sketch_records_torch(codes, k, w, dev)
    return sketch_records_torch(codes, k, w, dev)


def _run(plans: list, k: int, w: int, mesh: list[torch.device]) -> list[Sketch]:
    """Sketch the planned records' pieces, each device's in one call, and
    join each record's tiles by the seam rule."""
    work: dict[torch.device, list[np.ndarray]] = {}
    for plan in plans:
        for shard, tile, _ in plan or ():
            work.setdefault(mesh[shard], []).append(tile)
    timers.count("mesh:device_calls", len(work))
    if len(work) > 1:
        with ThreadPoolExecutor(len(work)) as ex:
            futs = {dev: ex.submit(_sketch_on, dev, tiles, k, w) for dev, tiles in work.items()}
            done = {dev: iter(f.result()) for dev, f in futs.items()}
    else:
        done = {dev: iter(_sketch_on(dev, tiles, k, w)) for dev, tiles in work.items()}
    out = []
    for plan in plans:
        if plan is None:
            out.append(_EMPTY)
            continue
        pos, hsh = [], []
        for shard, _, base_lo in plan:
            sk = next(done[mesh[shard]])
            drop = 1 if shard > 0 else 0  # the lead window's emission
            pos.append(sk.positions[drop:] + base_lo)
            hsh.append(sk.hashes[drop:])
        out.append(Sketch(positions=np.concatenate(pos), hashes=np.concatenate(hsh)))
    return out


def sketch_records_sharded(codes_list, k: int, w: int, mesh=None,
                           max_inflight_bases: int = MAX_INFLIGHT_BASES) -> list[Sketch]:
    """Minimizer sketches of many records, each tiled across the mesh
    (every CUDA device by default), bit-identical to
    ``ops.nthash_np.sketch_codes`` on each.  Records are planned until more
    than ``max_inflight_bases`` bases are held, then every device sketches
    its share of them in one call."""
    mesh = make_mesh(mesh)
    out: list[Sketch] = []
    plans: list = []
    inflight = 0
    for c in codes_list:
        c = np.asarray(c)
        plans.append(_plan(c, k, w, mesh))
        inflight += c.shape[0]
        if inflight > max_inflight_bases:
            out += _run(plans, k, w, mesh)
            plans, inflight = [], 0
    return out + _run(plans, k, w, mesh)


def sketch_sharded(codes: np.ndarray, k: int, w: int, mesh=None) -> Sketch:
    """Exact minimizer sketch of one record, tiled across the mesh."""
    return sketch_records_sharded([codes], k, w, mesh)[0]


def distributed_unique_count(mesh, hashes, counts) -> tuple[torch.Tensor, torch.Tensor]:
    """Every shard gathers all shards' minimizer hashes and counts them:
    (distinct gathered hashes, summed counts), each (n_shards,) int64 on the
    CPU, the same in every shard.  ``hashes`` holds one int64 row a shard
    (uint64 bits); the rows are gathered once on each distinct device and
    sorted unsigned."""
    mesh = make_mesh(mesh)
    rows = [torch.as_tensor(r) for r in hashes]
    if len(rows) != len(mesh):
        raise ValueError(f"{len(rows)} rows of hashes for {len(mesh)} shards")
    total = int(torch.as_tensor(counts).sum())
    distinct: dict[torch.device, int] = {}
    for dev in mesh:
        if dev not in distinct:
            s, _ = torch.sort(torch.cat([r.to(dev) for r in rows]) ^ _SIGN)
            distinct[dev] = int((s[1:] != s[:-1]).sum()) + int(s.numel() > 0)
    return (torch.tensor([distinct[dev] for dev in mesh], dtype=torch.int64),
            torch.full((len(mesh),), total, dtype=torch.int64))
