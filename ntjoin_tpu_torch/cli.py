"""Command line of the PyTorch port, the counterpart of ``ntjoin_tpu.cli``.

Usage::

    python -m ntjoin_tpu_torch.cli assemble -B target=scaf.fa references='ref.fa' \\
        reference_weights='2' k=32 w=1000 n=2 [backend=cuda] [agp=True] [time=True] ...
    python -m ntjoin_tpu_torch.cli analysis target=scaf.fa references='ref.fa' ref=truth.fa
    python -m ntjoin_tpu_torch.cli quast target=scaf.fa references='ref.fa' ref=truth.fa [large=1]
    python -m ntjoin_tpu_torch.cli all | help | version | check_install

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
backends; the Mann-Kendall op of ``mkt=True`` runs on the same device.
Options whose device code is not ported yet are refused.

With more than one CUDA device visible, ``backend=cuda|auto`` tiles each
record's sketch across all of them (``parallel/mesh.py``; the JAX package's
rule, ``NTJOIN_TPU_MESH=off`` turns it off); on one card it is not taken.
``n_procs=N coordinator=host:port process_id=i [local_devices=m]`` runs one
process of the multi-process pipeline (``parallel/pipeline.py``, gloo).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from ntjoin_tpu_torch.analysis import MissingToolError, align_to_reference, run_quast
from ntjoin_tpu_torch.core.assembly import AssemblySketch
from ntjoin_tpu_torch.core.config import ScaffoldConfig
from ntjoin_tpu_torch.core.scaffolder import Scaffolder
from ntjoin_tpu_torch.emit.writers import write_minimizer_tsv
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.io.fasta import write_fai
from ntjoin_tpu_torch.ops import sketch_records
from ntjoin_tpu_torch.ops.nthash_np import sketch_codes, sketch_seq
from ntjoin_tpu_torch.parallel.distributed import shard_device
from ntjoin_tpu_torch.parallel.mesh import sketch_records_sharded
from ntjoin_tpu_torch.parallel.pipeline import (
    DistributedConfig,
    distributed_assemble,
    write_all_scaffolds,
)
from ntjoin_tpu_torch.utils import timers
from ntjoin_tpu_torch.utils.atomic import atomic_write
from ntjoin_tpu_torch.utils.timers import StageTimers

VERSION = "ntjoin-tpu 0.1.0 (capability parity target: ntJoin v1.1.5)"

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
    # the multi-process mode (parallel/pipeline.py)
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
    if int(v["n_procs"]) > 1 and v["coordinator"] == "None":
        return ("n_procs>1 needs coordinator=<host:port>, the address of the "
                "process group every process joins")
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


def _mesh(v: dict[str, str]) -> list[str] | None:
    """The devices each record's sketch is tiled across, or None: every
    CUDA device when the backend is auto or cuda, more than one is visible
    and ``NTJOIN_TPU_MESH`` is not ``off`` (``ntjoin_tpu/cli.py:266-289``)."""
    if v["backend"] not in ("auto", "cuda") or os.environ.get("NTJOIN_TPU_MESH", "auto") == "off":
        return None
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n > 1 else None


def _sketcher(backend: str, device: str):
    """(records' source, k, w) -> list of Sketch for one assembly; the cuda
    backend sketches on ``device``, a card.  The cuda and torch backends
    take the source whole (``sketch_records_torch`` encodes each record into
    its batch buffer); the host sketchers take one record's codes at a time
    and drop them, as ``ntjoin_tpu/cli.py:297-301`` does."""
    if backend in ("auto", "cuda"):
        return lambda src, k, w: sketch_records.sketch_records_torch(src, k, w, device)
    if backend == "torch":
        return lambda src, k, w: sketch_records.sketch_records_torch(
            src, k, w, device, plain=True)
    if backend == "native":
        if not native.available():
            raise RuntimeError("native library unavailable (no g++ to build it)")
        one = native.sketch_codes_native
    else:
        one = sketch_codes
    return lambda src, k, w: [one(src.codes(i), k, w) for i in range(len(src))]


def _sharded(mesh: list[str]):
    """The mesh's sketcher: each record's codes from a generator that keeps
    none of them, as ``ntjoin_tpu/cli.py:283-289`` feeds its mesh."""
    return lambda src, k, w: sketch_records_sharded(
        (src.codes(i) for i in range(len(src))), k, w, mesh)


def _write_fai(fasta: str, src: native.FastaSource | None) -> None:
    """Write the ``.fai`` of ``fasta``: from the rows the native reader
    kept while the sketch read the file, where it did, else by reading the
    file again (``write_fai``); counted in ``fai_rescans``, 1 for a file
    read again and 0 for one indexed from the reader's rows."""
    with timers.span(f"fai:{os.path.basename(fasta)}"):
        text = None if src is None else src.fai_text()
        if text is None:
            write_fai(fasta)
        else:
            with atomic_write(fasta + ".fai", "wb") as out:
                out.write(text)
    timers.count("fai_rescans", text is None)


def _ensure_sketch(fasta: str, k: int, w: int, force: bool, sketch,
                   stages: StageTimers) -> tuple[str, AssemblySketch | None]:
    """Write (or reuse, Make-style) the minimizer TSV and .fai of one
    assembly, as ``ntjoin_tpu.cli._ensure_sketch`` does: the records come
    from one ``FastaSource``, and each k-mer's text in the TSV from the
    reader's bytes of its record.  The file is read once: a stale ``.fai``
    is written after the sketch from the reader's rows (``_write_fai``)."""
    tsv = f"{fasta}.k{k}.w{w}.tsv"
    base = os.path.basename(fasta)
    fresh = (
        not force
        and os.path.exists(tsv)
        and os.path.getmtime(tsv) >= os.path.getmtime(fasta)
    )
    fai = fasta + ".fai"
    fai_stale = force or not os.path.exists(fai) or os.path.getmtime(fai) < os.path.getmtime(fasta)
    if fresh:
        if fai_stale:
            _write_fai(fasta, None)
        return tsv, None
    with stages.stage(f"sketch:{base}"):
        with timers.span("reader"):
            src = native.FastaSource(fasta)
        try:
            sketches = sketch(src, k, w)
            with timers.span("tsv"):
                write_minimizer_tsv(tsv, src, sketches, k)
            names = src.names
        finally:
            with timers.span("reader"):
                src.close()
    if fai_stale:
        _write_fai(fasta, src)
    if timers.ON:
        timers.count("minimizers", sum(len(sk.positions) for sk in sketches))
    with timers.span(f"unique:{base}"):
        hs = [np.asarray(sk.hashes, dtype=np.uint64) for sk in sketches]
        ps = [np.asarray(sk.positions, dtype=np.int64) for sk in sketches]
        cs = [np.full(len(sk.positions), i, dtype=np.int32) for i, sk in enumerate(sketches)]
        return tsv, AssemblySketch.from_stream(
            tsv, 1.0, names,
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
    overlap_g = v["overlap_g"] or v["g"]
    scaffold_opts = dict(
        g=int(v["g"]),
        G=int(v["G"]),
        mkt=_truthy(v["mkt"]),
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
    if int(v["n_procs"]) > 1 or v["coordinator"] != "None":
        return _distributed(v, k, w, n, prefix, index_device, scaffold_opts)
    stages = StageTimers(enabled=_truthy(v["time"]), prefix=prefix)
    with timers.recording(stages.enabled):
        mesh = _mesh(v)
        sketch = _sharded(mesh) if mesh else _sketcher(v["backend"], index_device)
        cache: dict[str, AssemblySketch] = {}
        tsvs = []
        for fa in v["references"].split() + [v["target"]]:
            tsv, sk = _ensure_sketch(fa, k, w, force, sketch, stages)
            tsvs.append(tsv)
            if sk is not None:
                cache[tsv] = sk

        cfg = ScaffoldConfig(
            references=tsvs[:-1],
            target=tsvs[-1],
            target_weight=float(v["target_weight"]),
            reference_weights=[float(x) for x in v["reference_weights"].split()],
            prefix=prefix,
            n=n,
            k=k,
            w=w,
            **scaffold_opts,
        )
        with stages.stage("scaffold"):
            Scaffolder(cfg, sketch_cache=cache, device=index_device).run()

        base = f"{v['target']}.k{k}.w{w}.n{n}"
        parts = [f"{base}.assigned.scaffolds.fa", f"{base}.unassigned.scaffolds.fa"]
        with timers.span("all_scaffolds"):
            write_all_scaffolds(v["target"], k, w, n)
        if _truthy(v["gzip"]):
            for part in parts + [f"{base}.all.scaffolds.fa"]:
                if os.path.exists(part):
                    _gzip_artifact(part, threads=int(v["t"]))
        stages.report()
        if stages.enabled:
            print("trace_counts\t" + json.dumps(timers.trace_counts()))
        return 0


def _distributed(v: dict[str, str], k: int, w: int, n: int, prefix: str, device: str,
                 scaffold_opts: dict) -> int:
    """One process of the multi-process pipeline, as ``ntjoin_tpu/cli.py``
    runs it: its records sketched by the backend's sketcher on its shards'
    device, the verdict by hash bucket, process 0 scaffolds.  Prints the
    process's ``trace_counts`` line under ``time=True``."""
    pid = int(v["process_id"])
    dev = str(shard_device(pid, device))
    cfg = DistributedConfig(
        target=v["target"],
        references=v["references"].split(),
        reference_weights=[float(x) for x in v["reference_weights"].split()],
        target_weight=float(v["target_weight"]),
        prefix=prefix,
        k=k,
        w=w,
        n=n,
        coordinator=None if v["coordinator"] == "None" else v["coordinator"],
        num_processes=int(v["n_procs"]),
        process_id=pid,
        local_device_count=None if v["local_devices"] == "None" else int(v["local_devices"]),
        device=dev,
        scaffold_opts=scaffold_opts,
    )
    on = _truthy(v["time"])
    with timers.recording(on):
        distributed_assemble(cfg, _sketcher(v["backend"], dev))
        if on:
            print("trace_counts\t" + json.dumps(timers.trace_counts()))
    return 0


def _resolve_fasta(path: str) -> str | None:
    """Existing path for a FASTA artifact, accepting the gzip=True variant
    (``assemble gzip=True`` replaces ``<fa>`` with ``<fa>.gz``; minimap2,
    QUAST and our reader all take gzipped FASTA directly)."""
    if os.path.exists(path):
        return path
    if os.path.exists(path + ".gz"):
        return path + ".gz"
    return None


def analysis(words: list[str]) -> int:
    """Alignment/QUAST evaluation of inputs and outputs vs a truth reference
    (mirror of the reference's ``analysis`` Make target, ``ntJoin:158-161``)."""
    v = _parse_vars([w for w in words if not w.startswith("-")])
    ref = v.get("ref", "None")
    if ref == "None":
        print("ERROR: must set ref", file=sys.stderr)
        return 1
    if v["target"] == "None":
        print("ERROR: Must set target", file=sys.stderr)
        return 1
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    references = v["references"].split() if v["references"] != "None" else []
    targets = references + [
        v["target"],
        f"{v['target']}.k{k}.w{w}.n{n}.all.scaffolds.fa",
    ]
    try:
        for fa in targets:
            fa = _resolve_fasta(fa)
            if fa is not None:
                bam = align_to_reference(fa, ref, threads=int(v["t"]))
                print(f"aligned {fa} -> {bam}")
    except MissingToolError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


def quast(words: list[str]) -> int:
    """QUAST evaluation of references + target + all.scaffolds vs a truth
    reference (mirror of the reference's ``quast_$(prefix)/report.tsv``
    target, ``ntJoin:244-252``): ``--fast --scaffold-gap-max-size 100000
    --split-scaffolds`` plus ``--large`` when ``large=1``."""
    v = _parse_vars([w for w in words if not w.startswith("-")])
    ref = v.get("ref", "None")
    if ref == "None":
        print("ERROR: must set ref", file=sys.stderr)
        return 1
    if v["target"] == "None":
        print("ERROR: Must set target", file=sys.stderr)
        return 1
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    prefix = v["prefix"] or f"out.k{k}.w{w}.n{n}"
    references = v["references"].split() if v["references"] != "None" else []
    assemblies = [
        fa
        for fa in (
            _resolve_fasta(p)
            for p in references
            + [v["target"], f"{v['target']}.k{k}.w{w}.n{n}.all.scaffolds.fa"]
        )
        if fa is not None
    ]
    try:
        report = run_quast(
            assemblies, ref, f"quast_{prefix}", threads=int(v["t"]),
            large=v.get("large", "0") == "1",
        )
    except MissingToolError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    print(f"QUAST report: {report}")
    return 0


def check_install() -> int:
    """Counterpart of the reference's check_install target
    (``ntJoin:192-198``): the host sketch, the native library and the GPU."""
    sk = sketch_seq("ACGT" * 64, 15, 10)
    if sk.positions.size == 0:
        print("core sketch: FAILED (no minimizers)", file=sys.stderr)
        return 1
    print("core sketch: OK")
    print(f"native library: {'OK' if native.available() else 'MISSING (no g++ to build it)'}")
    if torch.cuda.is_available():
        print(f"CUDA device: OK ({torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s))")
    else:
        print("CUDA device: none (torch.cuda.is_available() is False; backend=torch, "
              "native and numpy run on the CPU)")
    return 0


HELP_TEXT = """
ntjoin-tpu (PyTorch port): Scaffolding assemblies using reference assemblies and minimizer graphs
{version}
Usage: python -m ntjoin_tpu_torch.cli assemble target=<target scaffolds> references='List of reference assemblies' reference_weights='List of weights per reference assembly'

Options:
target\t\t\tTarget assembly to be scaffolded in fasta format
references\t\tList of reference files (separated by a space, in fasta format)
target_weight\t\tWeight of target assembly [1]
reference_weights\tList of weights of reference assemblies
prefix\t\t\tPrefix of intermediate output files [out.k<k>.w<w>.n<n>]
t\t\t\tNumber of threads [4]
assemble_t\t\tNumber of threads for assembling stage [1]
k\t\t\tK-mer size for minimizers [32]
w\t\t\tWindow size for minimizers (bp) [1000]
n\t\t\tMinimum graph edge weight [1]
g\t\t\tMinimum gap size (bp) [20]
G\t\t\tMaximum gap size (bp) (0 if no maximum) [0]
m\t\t\tMinimum percentage of increasing/decreasing minimizer positions to orient contig [90]
mkt\t\t\tIf True, use Mann-Kendall Test to predict contig orientation (computationally-intensive, overrides 'm') [False]
agp\t\t\tIf True, output AGP file describing output scaffolds [False]
no_cut\t\t    \tIf True, will not cut contigs at putative misassemblies [False]
overlap\t\t\tIf True, attempts to detect and trim overlaps between joined sequences [True]
overlap_g\t\tGap size between trimmed overlapping segments (used if overlap=True) [g]
overlap_k\t\tK-mer size for overlap minimizers (bp) [15]
overlap_w\t\tWindow size for overlap minimizers (bp) [10]
time\t\t    \tIf True, will log the time for each step, and the kernels' and ops' counts [False]
gzip\t\t\tIf True, gzip the output scaffold FASTAs (pigz -p t when available) [False]
reference_config\tConfig file with reference assemblies and reference weights as comma-separated values (See README for example)
\t\t\t This is optional, and will override the 'references' and 'reference_weights' variables if specified

GPU options:
backend\t\t\tMinimizer sketch backend: auto (= cuda) | cuda (CUDA kernels) | torch (their plain PyTorch versions on 'device') | native | numpy [auto]
device\t\t\tTorch device of backend=torch and of its index stages [cpu]
index_backend\t\tFilter/graph stage placement: auto (device for cuda and torch, host for native and numpy) | device | host [auto]
n_procs\t\t\tMulti-process distributed mode: total process count [1]
process_id\t\tThis process's id (0..n_procs-1) [0]
coordinator\t\tgloo coordinator address for multi-host runs [None]
local_devices\t\tDevices visible to this process (distributed mode) [None]

Notes:
\t- Ensure the lists of reference assemblies and weights are in the same order, and that both are space-separated
\t- Ensure all assembly files are in the current working directory
\t- With more than one CUDA device visible, backend=cuda tiles each record's sketch across them (NTJOIN_TPU_MESH=off: not); on one card it is not taken

Other commands:
\tpython -m ntjoin_tpu_torch.cli analysis target=... references=... ref=truth.fa   minimap2+samtools alignment of inputs/outputs
\tpython -m ntjoin_tpu_torch.cli quast target=... references=... ref=truth.fa      QUAST evaluation report
\tpython -m ntjoin_tpu_torch.cli all target=... references=...                     assemble then analysis
\tpython -m ntjoin_tpu_torch.cli version | check_install
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(HELP_TEXT.format(version=VERSION))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(VERSION)
        return 0
    if cmd == "check_install":
        return check_install()
    if cmd == "assemble":
        return assemble(rest)
    if cmd == "analysis":
        return analysis(rest)
    if cmd == "quast":
        return quast(rest)
    if cmd == "all":
        return assemble(rest) or analysis(rest)
    print(
        f"ERROR: unknown command {cmd!r} (try: assemble, analysis, quast, all, version, help)",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
