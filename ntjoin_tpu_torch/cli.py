"""Command line of the PyTorch port, the counterpart of ``ntjoin_tpu.cli``.

Usage::

    python -m ntjoin_tpu_torch.cli assemble -B target=scaf.fa references='ref.fa' \\
        reference_weights='2' k=32 w=1000 n=2 [backend=cuda] [agp=True] [time=True] ...

The key=value surface is the JAX package's.  Sketch backends:

* ``cuda`` (also ``auto``, the default): the CUDA kernels; needs a GPU.
* ``torch``: the kernels' plain PyTorch versions on ``device=`` (default cpu).
* ``native`` / ``numpy``: the host sketchers.

Index backends (``index_backend=``): ``device`` runs the shared index,
graph build, connected components and path passes as torch ops
(``core/scaffolder.py``) on the sketch's device (``cuda`` for
``backend=cuda|auto``, ``device=`` otherwise); ``host`` runs the port's
NumPy host layers (``core/assembly.py``, ``graph/``); ``auto`` (the
default) is ``device`` for the cuda and torch backends and ``host`` for
native and numpy, as ``ntjoin_tpu.cli`` resolves it for its device
backends.  Options whose device code is not ported yet are refused.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from ntjoin_tpu_torch.core.assembly import AssemblySketch
from ntjoin_tpu_torch.core.config import ScaffoldConfig
from ntjoin_tpu_torch.core.scaffolder import Scaffolder
from ntjoin_tpu_torch.emit.writers import write_minimizer_tsv
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.io.fasta import read_fasta, write_fai
from ntjoin_tpu_torch.ops import device_index, sketch_cuda
from ntjoin_tpu_torch.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.utils.atomic import atomic_write
from ntjoin_tpu_torch.utils.timers import StageTimers

USAGE = (
    "usage: python -m ntjoin_tpu_torch.cli assemble [-B] target=<fa> references='<fa> ...' "
    "reference_weights='<w> ...' [k=32] [w=1000] [n=1] [backend=cuda|torch|native|numpy] "
    "[index_backend=auto|device|host] [device=cpu] [agp=True] [time=True] ...  "
    "(keys as in ntjoin_tpu.cli)"
)

_DEFAULTS = {
    "target": "None",
    "references": "None",
    "reference_config": "None",
    "reference_weights": "None",
    "target_weight": "1",
    "w": "1000",
    "k": "32",
    "overlap": "True",
    "overlap_w": "10",
    "overlap_k": "15",
    "t": "4",
    "assemble_t": "1",
    "n": "1",
    "g": "20",
    "overlap_g": "",
    "G": "0",
    "mkt": "False",
    "agp": "False",
    "m": "90",
    "no_cut": "False",
    "time": "False",
    "gzip": "False",
    "prefix": "",
    "backend": "auto",
    # filter/graph stage: host | device | auto (see _index_backend)
    "index_backend": "auto",
    # the multi-process mode's keys: accepted, refused unless left at these
    "coordinator": "None",
    "n_procs": "1",
    "process_id": "0",
    "local_devices": "None",
}


def _parse_vars(words: list[str]) -> dict[str, str]:
    out = dict(_DEFAULTS)
    for word in words:
        if "=" not in word:
            raise SystemExit(f"ERROR: unrecognized argument {word!r}")
        key, val = word.split("=", 1)
        out[key] = val
    return out


def _truthy(val: str) -> bool:
    return val.strip().lower() in ("true", "1", "yes")


def _gzip_artifact(path: str, threads: int = 4) -> str:
    """Compress ``path`` in place to ``path.gz`` (pigz > gzip > stdlib)."""
    if shutil.which("pigz"):
        subprocess.run(["pigz", f"-p{threads}", "-f", path], check=True)
    elif shutil.which("gzip"):
        subprocess.run(["gzip", "-f", path], check=True)
    else:  # stdlib fallback so the rule works in tool-less images
        import gzip as _gz

        with open(path, "rb") as src, _gz.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)
    return path + ".gz"


def _refusal(v: dict[str, str]) -> str | None:
    """Why these settings cannot run in the port yet, or None."""
    backend = v["backend"]
    if backend in ("pallas", "jax", "tpu"):
        return (f"backend={backend} is a JAX backend; its port is backend=cuda "
                "(ROADMAP Queue A items 2-3)")
    if backend not in ("auto", "cuda", "torch", "native", "numpy"):
        return f"unknown backend={backend} (cuda, torch, native or numpy)"
    if _truthy(v["mkt"]):
        return "mkt=True is not ported yet (ROADMAP Queue A item 9)"
    if int(v["n_procs"]) > 1 or v["coordinator"] != "None":
        return "n_procs>1 is not ported yet (ROADMAP Queue A item 12)"
    return None


def _index_backend(v: dict[str, str]) -> tuple[str, str]:
    """(index backend, device of the graph stages) for the settings:
    ``auto`` is ``device`` for the GPU and torch sketches, ``host``
    otherwise."""
    backend, index = v["backend"], v["index_backend"]
    device = "cuda" if backend in ("auto", "cuda") else v.get("device", "cpu")
    if index == "auto":
        index = "host" if backend in ("native", "numpy") else "device"
    return index, device


def _sketcher(backend: str, device: str):
    """(records' codes, k, w) -> list of Sketch for one assembly."""
    if backend in ("auto", "cuda"):
        return lambda codes, k, w: sketch_cuda.sketch_records_torch(codes, k, w, "cuda")
    if backend == "torch":
        return lambda codes, k, w: sketch_cuda.sketch_records_torch(
            codes, k, w, device, plain=True)
    if backend == "native":
        if not native.available():
            raise RuntimeError("native library unavailable (no g++ to build it)")
        one = native.sketch_codes_native
    else:
        one = sketch_codes
    return lambda codes, k, w: [one(c, k, w) for c in codes]


def _ensure_sketch(fasta: str, k: int, w: int, force: bool, sketch,
                   timers: StageTimers) -> tuple[str, AssemblySketch | None]:
    """Write (or reuse, Make-style) the minimizer TSV and .fai of one
    assembly, as ``ntjoin_tpu.cli._ensure_sketch`` does."""
    tsv = f"{fasta}.k{k}.w{w}.tsv"
    fresh = (
        not force
        and os.path.exists(tsv)
        and os.path.getmtime(tsv) >= os.path.getmtime(fasta)
    )
    fai = fasta + ".fai"
    if force or not os.path.exists(fai) or os.path.getmtime(fai) < os.path.getmtime(fasta):
        write_fai(fasta)
    if fresh:
        return tsv, None
    with timers.stage(f"sketch:{os.path.basename(fasta)}"):
        records = read_fasta(fasta)
        sketches = sketch([r.codes for r in records], k, w)
        for r in records:
            r._codes = None
        write_minimizer_tsv(tsv, records, sketches, k)
    hs = [np.asarray(sk.hashes, dtype=np.uint64) for sk in sketches]
    ps = [np.asarray(sk.positions, dtype=np.int64) for sk in sketches]
    cs = [np.full(len(sk.positions), i, dtype=np.int32) for i, sk in enumerate(sketches)]
    return tsv, AssemblySketch.from_stream(
        tsv, 1.0, [r.id for r in records],
        np.concatenate(hs) if hs else np.empty(0, np.uint64),
        np.concatenate(ps) if ps else np.empty(0, np.int64),
        np.concatenate(cs) if cs else np.empty(0, np.int32),
    )


def assemble(words: list[str]) -> int:
    force = "-B" in words
    v = _parse_vars([w for w in words if not w.startswith("-")])
    if v["reference_config"] != "None":
        refs, weights = [], []
        with open(v["reference_config"], encoding="utf-8") as fh:
            for line in fh:
                if line.strip():
                    parts = line.strip().split(",")
                    refs.append(parts[0])
                    weights.append(parts[1])
        v["references"] = " ".join(refs)
        v["reference_weights"] = " ".join(weights)
    for req in ("target", "references", "reference_weights"):
        if v[req] == "None":
            print(f"ERROR: Must set {req}", file=sys.stderr)
            return 1
    why = _refusal(v)
    if why:
        print(f"ERROR: {why}", file=sys.stderr)
        return 1
    if v["backend"] in ("auto", "cuda") and not torch.cuda.is_available():
        print("ERROR: backend=cuda needs a CUDA device and none is available "
              "(backend=torch runs the plain versions)", file=sys.stderr)
        return 1
    index_backend, index_device = _index_backend(v)

    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    prefix = v["prefix"] or f"out.k{k}.w{w}.n{n}"
    timers = StageTimers(enabled=_truthy(v["time"]), prefix=prefix)
    sketch = _sketcher(v["backend"], v.get("device", "cpu"))
    cache: dict[str, AssemblySketch] = {}
    tsvs = []
    for fa in v["references"].split() + [v["target"]]:
        tsv, sk = _ensure_sketch(fa, k, w, force, sketch, timers)
        tsvs.append(tsv)
        if sk is not None:
            cache[tsv] = sk

    overlap_g = v["overlap_g"] or v["g"]
    cfg = ScaffoldConfig(
        references=tsvs[:-1],
        target=tsvs[-1],
        target_weight=float(v["target_weight"]),
        reference_weights=[float(x) for x in v["reference_weights"].split()],
        prefix=prefix,
        n=n,
        k=k,
        w=w,
        g=int(v["g"]),
        G=int(v["G"]),
        mkt=False,
        m=int(v["m"]),
        t=int(v["assemble_t"]),
        agp=_truthy(v["agp"]),
        no_cut=_truthy(v["no_cut"]),
        overlap=_truthy(v["overlap"]),
        overlap_gap=int(overlap_g),
        overlap_k=int(v["overlap_k"]),
        overlap_w=int(v["overlap_w"]),
        index_backend=index_backend,
    )
    device_index.reset_counts()
    with timers.stage("scaffold"):
        Scaffolder(cfg, sketch_cache=cache, device=index_device).run()

    base = f"{v['target']}.k{k}.w{w}.n{n}"
    parts = [f"{base}.assigned.scaffolds.fa", f"{base}.unassigned.scaffolds.fa"]
    with atomic_write(f"{base}.all.scaffolds.fa", mode="wb") as out:
        for part in parts:
            if os.path.exists(part):
                with open(part, "rb") as fh:
                    shutil.copyfileobj(fh, out, length=16 << 20)
    if _truthy(v["gzip"]):
        for part in parts + [f"{base}.all.scaffolds.fa"]:
            if os.path.exists(part):
                _gzip_artifact(part, threads=int(v["t"]))
    timers.report()
    if timers.enabled:
        print("sketch_counts\t" + json.dumps(sketch_cuda.COUNTS))
        print("index_counts\t" + json.dumps(device_index.counts_report()))
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "assemble":
        print(USAGE, file=sys.stderr)
        return 0 if argv[:1] in (["help"], ["-h"], ["--help"]) else 1
    return assemble(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
