"""The multi-process scaffolding pipeline: the counterpart of
``ntjoin_tpu/parallel/pipeline.py``.

Record shard -> sketch -> global uniqueness and intersection verdict ->
survivor exchange -> process 0 scaffolds.  Every assembly's records are
dealt round-robin to the processes; each process reads the assembly once
(``io.native.FastaSource``) and sketches only its own records, encoded one
batch at a time, on its device (the CUDA kernels on its card unless the
caller passes another sketcher), and keeps no local dedup: uniqueness is
the global verdict's (``parallel/distributed.py``, by hash bucket).  The surviving entries,
a small share of the streams, are gathered with int64 hashes and positions,
and process 0 restores each assembly's stream order and runs the
``Scaffolder``.  Artifacts are byte-identical to a one-process run at any
process count (``tests/test_torch_distributed.py``).
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ntjoin_tpu_torch.core.assembly import AssemblySketch
from ntjoin_tpu_torch.core.config import ScaffoldConfig
from ntjoin_tpu_torch.core.scaffolder import Scaffolder
from ntjoin_tpu_torch.io.native import FastaSource
from ntjoin_tpu_torch.ops.sketch_records import Subset, sketch_records_torch
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.utils import timers
from ntjoin_tpu_torch.utils.atomic import atomic_write


@dataclass
class DistributedConfig:
    """Launch parameters of one process of a distributed run."""

    target: str
    references: list[str]
    reference_weights: list[float]
    prefix: str
    target_weight: float = 1.0
    k: int = 32
    w: int = 1000
    n: int = 1
    coordinator: str | None = None  # host:port of the process group
    num_processes: int = 1
    process_id: int = 0
    local_device_count: int | None = None  # shards of this process (1)
    device: str = "cuda"  # of the shards, the verdict and the scaffold's graph stages
    # scaffolding options forwarded to ScaffoldConfig
    scaffold_opts: dict = field(default_factory=dict)


def write_all_scaffolds(target: str, k: int, w: int, n: int) -> str:
    """Join the assigned and unassigned scaffold FASTAs of a run into the
    ``all`` one (atomically, by a streamed copy); returns its path."""
    base = f"{target}.k{k}.w{w}.n{n}"
    allf = f"{base}.all.scaffolds.fa"
    with atomic_write(allf, mode="wb") as out:
        for part in (f"{base}.assigned.scaffolds.fa", f"{base}.unassigned.scaffolds.fa"):
            if os.path.exists(part):
                with open(part, "rb") as fh:
                    shutil.copyfileobj(fh, out, length=16 << 20)
    return allf


def _pack_rows(x: np.ndarray, fill, n_rows: int, width: int) -> np.ndarray:
    buf = np.full(n_rows * width, fill, x.dtype)
    buf[: x.shape[0]] = x
    return buf.reshape(n_rows, width)


def distributed_assemble(cfg: DistributedConfig, sketch=None) -> None:
    """Run one process of the pipeline; process 0 writes the artifacts.
    ``sketch(source, k, w) -> list of Sketch`` sketches an assembly's
    share of records, a ``Subset`` of its ``FastaSource`` (default:
    ``sketch_records_torch`` on the shards' device, which encodes each of
    them into its batch buffer).  Joins the process group when
    ``num_processes > 1`` and leaves it on success and on error.  The
    shards of every process count in ``dist:shards@<device type>``, and
    what this process sketched and kept in ``dist:records``,
    ``dist:entries`` and ``dist:survivors``."""
    if cfg.num_processes > 1 and cfg.coordinator is None:
        raise ValueError("n_procs>1 needs coordinator=<host:port> (the process group's address)")
    joined = cfg.num_processes > 1
    if joined:
        shards = pd.initialize(cfg.coordinator, cfg.num_processes, cfg.process_id,
                               cfg.local_device_count, cfg.device)
    else:
        shards = [pd.shard_device(cfg.process_id, cfg.device)] * (cfg.local_device_count or 1)
    try:
        if sketch is None:
            def sketch(src, k, w):
                return sketch_records_torch(src, k, w, shards[0])
        _assemble(cfg, shards, sketch)
    finally:
        if joined:
            dist.destroy_process_group()


def _assemble(cfg: DistributedConfig, shards: list[torch.device], sketch) -> None:
    k, w = cfg.k, cfg.w
    dev, n_local = shards[0], len(shards)
    fastas = list(cfg.references) + [cfg.target]
    n_asm = len(fastas)
    names: dict[int, list[str]] = {}
    cols: list[np.ndarray] = []  # (hash, assembly, contig, position) per record
    n_records = 0
    for a, fa in enumerate(fastas):
        with FastaSource(fa) as src:
            names[a] = src.names
            mine = list(range(cfg.process_id, len(src), cfg.num_processes))
            sketches = sketch(Subset(src, mine), k, w)
        n_records += len(mine)
        for ri, sk in zip(mine, sketches):
            m = sk.hashes.shape[0]
            cols.append(np.stack([sk.hashes.view(np.int64), np.full(m, a), np.full(m, ri),
                                  sk.positions.astype(np.int64)]))
    h_l, asm_l, ctg_l, pos_l = np.concatenate(cols, axis=1) if cols else np.zeros((4, 0), np.int64)
    n_loc = h_l.shape[0]

    # agree on the per-shard width and the bucket width
    meta = pd.all_gather(torch.tensor([n_loc, n_local]))
    if (meta[:, 1] != n_local).any():
        raise ValueError(f"every process must hold as many shards: {meta[:, 1].tolist()}")
    n_shards = int(meta[:, 1].sum())
    width = max(64, -(-int(meta[:, 0].max()) // n_local))
    width = 1 << (width - 1).bit_length()
    alive = _pack_rows(np.ones(n_loc, bool), False, n_local, width)
    h_rows = _pack_rows(h_l, 0, n_local, width)
    bw = int(pd.all_gather(torch.tensor([pd.bucket_width_for_rows(h_rows, alive, n_shards)])).max())
    verdict = pd.distributed_survive_sharded(
        torch.from_numpy(h_rows).to(dev), torch.from_numpy(_pack_rows(asm_l, -1, n_local, width)).to(dev),
        torch.from_numpy(alive).to(dev), n_asm, bw)
    mine = verdict.reshape(-1)[:n_loc].cpu().numpy()

    # every process's surviving entries, to process 0
    h_g, asm_g, ctg_g, pos_g = pd.gather_ragged(
        torch.from_numpy(np.stack([h_l[mine], asm_l[mine], ctg_l[mine], pos_l[mine]]))).numpy()
    timers.count(f"dist:shards@{dev.type}", n_shards)
    timers.count("dist:records", n_records)
    timers.count("dist:entries", n_loc)
    timers.count("dist:survivors", int(mine.sum()))
    if cfg.process_id != 0:
        return

    tsvs = [f"{fa}.k{k}.w{w}.tsv" for fa in fastas]
    weights = list(cfg.reference_weights) + [cfg.target_weight]
    cache = {}
    for a, tsv in enumerate(tsvs):
        sel = asm_g == a
        # the assembly's stream order: positions ascend within a record
        order = np.lexsort((pos_g[sel], ctg_g[sel]))
        cache[tsv] = AssemblySketch.from_stream(
            tsv, weights[a], names[a], h_g[sel][order].view(np.uint64), pos_g[sel][order],
            ctg_g[sel][order].astype(np.int32))
    sc = ScaffoldConfig(references=tsvs[:-1], target=tsvs[-1], target_weight=cfg.target_weight,
                        reference_weights=list(cfg.reference_weights), prefix=cfg.prefix,
                        n=cfg.n, k=k, w=w, **cfg.scaffold_opts)
    Scaffolder(sc, sketch_cache=cache, device=dev).run()
    write_all_scaffolds(cfg.target, k, w, cfg.n)
