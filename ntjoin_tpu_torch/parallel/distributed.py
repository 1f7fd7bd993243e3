"""Several processes, one verdict: the counterpart of
``ntjoin_tpu/parallel/distributed.py`` on ``torch.distributed``.

Each process holds ``local_device_count`` shards (default 1), all on its
device: ``cuda:(process_id % device_count)`` on a machine with cards, or
the CPU for the plain torch ops.  There are ``world * local_device_count``
shards in all, in process order.  A process's entries are rows
``(local shards, width)`` of int64 hashes (uint64 bits), int64 assembly
indices and a live mask.

The product verdict, ``distributed_survive_sharded``, exchanges entries by
hash bucket: shard b owns the hashes whose high 32 bits are b modulo the
shard count (the JAX package's ``hi % n_dev``, bit for bit).  The sorts, the
bucket scatter and the per-bucket verdict run on the process's device.  The
exchange between processes is one ``all_to_all_single`` over gloo, which
moves CPU tensors: the send and receive buffers cross the host, and that is
the transport, not a fallback (NCCL, with a card a process, would keep them
on the device).  With one process the exchange is a local permutation and
no collective runs.  ``COUNTS`` records the bytes each exchange sent to
other processes and the verdict's time on a card (CUDA events).

``distributed_survive`` is the replicated oracle: every process gathers
every entry and runs the same verdict.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ntjoin_tpu_torch.ops.device_index import survive_verdict_sorted
from ntjoin_tpu_torch.parallel.mesh import make_mesh

# A collective that waits longer than this fails instead of hanging.
TIMEOUT_S = 300

# exchanges: [collective, bytes this process sent to other processes], in
# order; verdict_ms: the per-bucket verdict's device time, on a card.
COUNTS: dict[str, list] = {}


def reset_counts() -> None:
    COUNTS.clear()
    COUNTS.update(exchanges=[], verdict_ms=[])


reset_counts()


def shard_device(process_id: int, device: str | torch.device = "cuda") -> torch.device:
    """The device of a process's shards: ``cuda:(process_id % device_count)``
    for ``cuda`` without an index, else ``device`` as named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device for the process's shards")
        dev = torch.device("cuda", process_id % n)
    return make_mesh([dev])[0]


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_device_count: int | None = None,
               device: str | torch.device = "cuda") -> list[torch.device]:
    """Join the process group (gloo, ``tcp://coordinator``) and return this
    process's shards: ``local_device_count`` (default 1) of them on
    ``shard_device(process_id, device)``."""
    shards = [shard_device(process_id, device)] * (local_device_count or 1)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return shards


def world() -> tuple[int, int]:
    """(processes, this process's rank); (1, 0) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _sent(op: str, nbytes: int) -> None:
    COUNTS["exchanges"].append([op, int(nbytes)])


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(processes, *x.shape) on the CPU: every process's ``x`` (same shape
    everywhere) in rank order."""
    n, _ = world()
    x = x.cpu().contiguous()
    if n == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    _sent("all_gather", x.nbytes * (n - 1))
    return torch.stack(parts)


def gather_ragged(x: torch.Tensor) -> torch.Tensor:
    """Every process's (P, m_p) columns joined in rank order: (P, sum m_p)
    on the CPU, dtypes and values unchanged (int64 positions of 2^31 and
    more included)."""
    sizes = all_gather(torch.tensor([x.shape[1]]))[:, 0].tolist()
    pad = torch.zeros((x.shape[0], max(sizes)), dtype=x.dtype)
    pad[:, : x.shape[1]] = x
    g = all_gather(pad)
    return torch.cat([g[r, :, :m] for r, m in enumerate(sizes)], dim=1)


def exchange(send: torch.Tensor) -> torch.Tensor:
    """The shard exchange.  ``send`` (local shards, shards, bw, P) holds
    what each local shard sends to each shard; returns (local shards,
    shards, bw, P) on the same device: what each shard sent to each local
    shard.  One ``all_to_all_single`` over the processes, whose slabs hold
    the local shards' rows in shard order; with one process a transpose."""
    n, _ = world()
    n_local, n_shards, bw, p = send.shape
    x = send.view(n_local, n, n_local, bw, p).transpose(0, 1)  # (process, src, dst, ...)
    if n > 1:
        xc = x.contiguous().cpu()
        y = torch.empty_like(xc)
        dist.all_to_all_single(y, xc)
        _sent("all_to_all", xc.nbytes // n * (n - 1))
        x = y.to(send.device)
    return x.permute(2, 0, 1, 3, 4).reshape(n_local, n_shards, bw, p)


def _timed_verdict(h, asm, dead, n_asm: int) -> torch.Tensor:
    """The verdict in place (the entries' order); its device time on a card
    goes to ``COUNTS["verdict_ms"]``."""
    on_card = h.device.type == "cuda"
    if on_card:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
    order, surv = survive_verdict_sorted(h, asm, dead, n_asm)
    verdict = torch.zeros_like(dead).index_put_((order,), surv)
    if on_card:
        b.record()
        b.synchronize()
        COUNTS["verdict_ms"].append(a.elapsed_time(b))
    return verdict


def distributed_survive(h: torch.Tensor, asm: torch.Tensor, alive: torch.Tensor,
                        n_asm: int) -> torch.Tensor:
    """Replicated oracle of the global verdict: every process gathers every
    shard's rows and derives the same verdict.  A hash survives iff it
    occurs exactly once in every assembly.  Returns the full verdict
    (shards * width,) in (shard, slot) order on ``h``'s device."""
    dev = h.device
    g = [all_gather(x).reshape(-1).to(dev) for x in (h, asm.long(), alive)]
    return _timed_verdict(g[0], g[1], ~g[2], n_asm)


def bucket_width_for_rows(h_rows, alive_rows, n_buckets: int) -> int:
    """The most live entries one of these rows sends to one bucket (at
    least 1); the global width is the most over the processes."""
    mx = 1
    for h, al in zip(np.asarray(h_rows), np.asarray(alive_rows)):
        b = ((h[al] >> 32) & 0xFFFFFFFF) % n_buckets
        if b.size:
            mx = max(mx, int(np.bincount(b, minlength=n_buckets).max()))
    return mx


def distributed_survive_sharded(h: torch.Tensor, asm: torch.Tensor, alive: torch.Tensor,
                                n_asm: int, bucket_width: int) -> torch.Tensor:
    """The global verdict by hash bucket, for this process's rows (local
    shards, width): sort each row by bucket (stable), rank within (shard,
    bucket), scatter into a (shards, bw) send buffer, exchange, verdict of
    each received bucket on the device, exchange back to the home slots.
    ``bucket_width`` is at least ``bucket_width_for_rows`` of every process
    (no overflow path).  Returns the verdict rows (local shards, width)."""
    n, _ = world()
    n_local, width = h.shape
    n_shards = n * n_local
    bw = max(1, int(bucket_width))
    cap = n_shards * bw
    dev = h.device
    bkt = ((h >> 32) & 0xFFFFFFFF) % n_shards
    key = torch.where(alive, bkt, n_shards)  # dead entries sort past the buckets
    key_s, sort_idx = torch.sort(key, dim=1, stable=True)
    iota = torch.arange(width, device=dev).expand(n_local, width)
    starts = torch.cat([torch.ones((n_local, 1), dtype=torch.bool, device=dev),
                        key_s[:, 1:] != key_s[:, :-1]], dim=1)
    rank = iota - torch.cummax(torch.where(starts, iota, 0), dim=1).values
    dest_s = torch.where(key_s < n_shards, key_s * bw + rank, cap)  # cap: dropped
    dest = torch.empty_like(dest_s).scatter_(1, sort_idx, dest_s)  # each slot's place
    send = torch.zeros((n_local, cap + 1, 3), dtype=torch.int64, device=dev)
    send[:, :, 1] = -1
    rows = torch.arange(n_local, device=dev)[:, None]
    send[rows, dest] = torch.stack([h, asm.long(), alive.long()], dim=-1)
    got = exchange(send[:, :cap].reshape(n_local, n_shards, bw, 3)).reshape(-1, 3)
    # equal hashes share a bucket, so the local shards' buckets are judged at once
    verdict = _timed_verdict(got[:, 0], got[:, 1], got[:, 2] == 0, n_asm)
    back = exchange(verdict.view(n_local, n_shards, bw, 1).to(torch.int8))
    return alive & back.reshape(n_local, cap).gather(1, dest.clamp(max=cap - 1)).bool()
