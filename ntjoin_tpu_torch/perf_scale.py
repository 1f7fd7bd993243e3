"""Synthetic-scale end-to-end run of the port's ``assemble``: the counterpart
of ``scripts/perf_scale.py``.

    python -m ntjoin_tpu_torch.perf_scale --mbp 1000 --refs 2 [--backend B]
        [--index_backend I] [--device D] [--k K] [--w W] [--profile] [--sort S]
        [--keep DIR]

A random genome is the reference assembly (``--refs N`` of them, each with
its chromosome bounds offset), and its ~50 kbp pieces, shuffled and 30%
reverse-complemented, are the target draft; ``make_inputs`` writes the same
FASTA bytes as the original's for the same arguments.  The inputs are
written by a child process, so that this process's peak RSS is the
``assemble``'s own.  The run is ``ntjoin_tpu_torch.cli.main`` in this
process with ``time=True`` (``--profile``: under cProfile, the top entries
and the callees of ``find_paths`` printed).

``--backend`` is the sketch backend: ``cuda`` (default: the CUDA kernels,
which need a GPU), ``torch`` (their plain versions on ``--device``, default
cpu), ``native`` or ``numpy`` (host sketchers).  ``--index_backend host``
with ``native`` is the host oracle.  Without a CUDA device a run that
needs one exits 1 with "no CUDA device" on stderr before writing anything.

The last stdout line is one JSON object: ``mbp``, ``refs``, ``backend``,
``e2e_s`` (host clock around ``cli.main``), ``rss_gb`` (peak RSS of this
process, ``utils/timers.peak_rss_kb``), ``rc`` and ``stages`` (each
``time=True`` stage's wall, peak RSS, resident set at its start and end
and the highest one read while it was open), and ``rss_inherited_gb``, the
same peak read at the start: where the system carries the peak of the
spawning process over (``ru_maxrss``), a peak no higher than this is not
the run's own.  A run on a card adds ``cuda_init_s`` and
``rss_cuda_init_gb`` (the first CUDA context, made before the run, and the
resident set just after it),
``device_peak_gb`` (``torch.cuda.max_memory_allocated`` over the run),
``device``, the run's ``sketch_counts`` and ``index_counts``, and
``sketch_stages_s``, the host clock of ``sketch_records_torch`` by stage
(``plan``: each record's path read from its codes).  A
sampler thread reads the resident set every ``utils/timers.SAMPLE_S``
seconds: ``sampled`` gives each stage's first and highest sample of ``VmRSS``,
``RssAnon`` and ``RssFile`` (None where ``/proc`` has no such line);
``--py_top STAGE`` adds ``py_top``, the
largest holders of the Python heap (tracemalloc, by source line) near its
peak in that stage.
"""
from __future__ import annotations

import argparse
import cProfile
import glob
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import tracemalloc

import numpy as np

from ntjoin_tpu_torch.utils import timers
from ntjoin_tpu_torch.utils.timers import peak_rss_kb, status_kb

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = np.frombuffer(b"ACGT", dtype=np.uint8)
LINE = 80  # bases a FASTA line


def synth_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int8)


def write_fasta(path: str, records: list[tuple[str, np.ndarray]]) -> None:
    """The original's FASTA bytes (lines of 80 bases), written a record at
    a time as rows of 80 letters and a newline column."""
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(b">" + name.encode() + b"\n")
            seq = CODES[codes]
            full = seq.shape[0] // LINE
            rows = np.empty((full, LINE + 1), dtype=np.uint8)
            rows[:, :LINE] = seq[: full * LINE].reshape(full, LINE)
            rows[:, LINE] = ord("\n")
            fh.write(rows.data)
            if seq.shape[0] > full * LINE:
                fh.write(seq[full * LINE :].tobytes() + b"\n")


def make_inputs(workdir: str, mbp: float, seed: int = 7, n_refs: int = 1):
    """``ref.fa``, ``ref1.fa`` ... and ``target.fa`` in ``workdir``, byte for
    byte those of ``scripts/perf_scale.py`` (the same draws from the same
    generator); returns (reference paths, target path)."""
    rng = np.random.default_rng(seed)
    n = int(mbp * 1e6)
    genome = synth_genome(rng, n)
    # a few chromosome-scale sequences a reference; extra references offset
    # the chromosome bounds, so they are distinct assemblies of one genome
    n_chrom = max(1, int(round(mbp / 50)))
    ref_fas = []
    for r in range(n_refs):
        off = (r * n) // (n_chrom * max(1, n_refs) * 2)
        bounds = np.linspace(0, n, n_chrom + 1).astype(np.int64)
        bounds[1:-1] = np.clip(bounds[1:-1] + off, 1, n - 1)
        ref = [(f"r{r}chr{i}", genome[bounds[i] : bounds[i + 1]]) for i in range(n_chrom)]
        ref_fa = os.path.join(workdir, f"ref{r if r else ''}.fa")
        write_fasta(ref_fa, ref)
        ref_fas.append(ref_fa)
    # target: ~50 kbp contigs, order shuffled, some reversed
    frag = 50_000
    cuts = np.append(np.arange(0, n, frag), n)
    pieces = []
    comp = np.array([3, 2, 1, 0], dtype=np.int8)
    for i in range(cuts.shape[0] - 1):
        codes = genome[cuts[i] : cuts[i + 1]]
        if rng.random() < 0.3:
            codes = comp[codes[::-1]]
        pieces.append((f"ctg{i}", codes))
    order = rng.permutation(len(pieces))
    tgt_fa = os.path.join(workdir, "target.fa")
    write_fasta(tgt_fa, [pieces[i] for i in order])
    return ref_fas, tgt_fa


def _on_card(backend: str, device: str) -> bool:
    return backend == "cuda" or (backend == "torch" and device.startswith("cuda"))


def _peak_rss_gb() -> float:
    return peak_rss_kb() / 1e6


def _gb(kb: str) -> float | None:
    return None if kb == "None" else int(kb) / 1e6


def _stages() -> dict:
    """Each ``out.*.time`` file's stage: its wall, the peak RSS at its end,
    the resident set at its start and at its end and the highest one read
    while it was open."""
    stages = {}
    for tf in sorted(glob.glob("out.*.time")):
        with open(tf, encoding="utf-8") as fh:
            kv = dict(line.split("\t") for line in fh.read().splitlines())
        stages[kv["stage"]] = {"wall_s": float(kv["wall_s"]),
                               "rss_gb": _gb(kv["peak_rss_kb"]),
                               "rss_start_gb": _gb(kv["rss_start_kb"]),
                               "rss_end_gb": _gb(kv["rss_end_kb"]),
                               "rss_max_gb": _gb(kv["rss_max_kb"])}
    return stages


_RSS_FIELDS = ("VmRSS", "RssAnon", "RssFile")


class RssSampler:
    """A thread that reads this process's resident set every
    ``timers.SAMPLE_S`` seconds, ``VmRSS`` and its anonymous and file-backed parts (``RssAnon``,
    ``RssFile``), and keeps for each stage (``timers.STAGE``) its first
    sample and the one of the highest ``VmRSS``.  With ``py_stage`` it
    traces the Python heap (tracemalloc) and keeps a snapshot taken in that
    stage whenever the traced bytes passed the last one's by 5%: the
    holders near its peak of what the stage allocated (tracing starts at
    the stage's first sample and stops when it ends)."""

    def __init__(self, py_stage: str | None = None):
        self.py_stage = py_stage
        self.first: dict[str, tuple] = {}
        self.peak: dict[str, tuple] = {}
        self.py = None  # (traced bytes, snapshot)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        stage = timers.STAGE[-1] if timers.STAGE else "(outside stages)"
        got = tuple(status_kb(f) for f in _RSS_FIELDS)  # None where the system lacks one
        self.first.setdefault(stage, got)
        if (got[0] or 0) > (self.peak.get(stage, (-1,))[0] or 0):
            self.peak[stage] = got
        if stage != self.py_stage:
            if tracemalloc.is_tracing():
                tracemalloc.stop()
            return
        if not tracemalloc.is_tracing():
            tracemalloc.start(16)
        traced = tracemalloc.get_traced_memory()[0]
        if self.py is None or traced > 1.05 * self.py[0]:
            self.py = (traced, tracemalloc.take_snapshot())

    def _run(self) -> None:
        while not self._stop.wait(timers.SAMPLE_S):
            self._sample()

    def __enter__(self) -> RssSampler:
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        tracemalloc.stop()

    def report(self) -> dict:
        """{stage: {"first" | "peak": {VmRSS, RssAnon, RssFile in GB}}}."""
        def gb(sample):
            return {f: None if kb is None else kb / 1e6 for f, kb in zip(_RSS_FIELDS, sample)}
        return {stage: {"first": gb(self.first[stage]), "peak": gb(self.peak[stage])}
                for stage in self.peak}

    def py_top(self, n: int = 12) -> list[dict]:
        """The snapshot's ``n`` largest holders, each block put on the
        innermost line of the port that allocated it."""
        if self.py is None:
            return []
        pkg = os.path.join(_REPO, "ntjoin_tpu_torch")
        held: dict[str, list[int]] = {}
        for st in self.py[1].statistics("traceback"):
            frames = [f for f in st.traceback if f.filename.startswith(pkg)]
            f = max(frames, key=lambda f: list(st.traceback).index(f)) if frames \
                else st.traceback[-1]
            key = f"{os.path.relpath(f.filename, _REPO)}:{f.lineno}"
            size = held.setdefault(key, [0, 0])
            size[0] += st.size
            size[1] += st.count
        top = sorted(held.items(), key=lambda kv: -kv[1][0])[:n]
        return [{"where": where, "gb": size / 1e9, "blocks": count}
                for where, (size, count) in top]


def words_for(args, ref_fas: list[str], tgt_fa: str) -> list[str]:
    """The ``assemble`` words of the original, with the port's backend
    options."""
    words = [
        "assemble",
        f"target={os.path.basename(tgt_fa)}",
        "references=" + " ".join(os.path.basename(r) for r in ref_fas),
        "reference_weights=" + " ".join("2" for _ in ref_fas),
        f"k={args.k}",
        f"w={args.w}",
        "prefix=out",
        "time=True",
        f"backend={args.backend}",
    ]
    if args.index_backend:
        words.append(f"index_backend={args.index_backend}")
    if args.backend == "torch":
        words.append(f"device={args.device}")
    return words


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ntjoin_tpu_torch.perf_scale")
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--w", type=int, default=1000)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--keep", default=None, help="keep the work directory at this path")
    ap.add_argument("--sort", default="cumulative")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch", "native", "numpy"),
                    help="sketch backend")
    ap.add_argument("--index_backend", default=None, choices=("auto", "device", "host"),
                    help="filter and graph stages (default: the CLI's auto)")
    ap.add_argument("--device", default="cpu", help="torch device of backend=torch")
    ap.add_argument("--refs", type=int, default=1, help="number of references")
    ap.add_argument("--py_top", default=None, metavar="STAGE",
                    help="trace the Python heap and name its largest holders in STAGE")
    args = ap.parse_args(argv)
    if args.refs < 1:
        ap.error("--refs must be >= 1 (at least one reference assembly)")
    return args


def main(argv: list[str] | None = None) -> int:
    inherited = _peak_rss_gb()
    args = parse_args(argv)
    import torch

    on_card = _on_card(args.backend, args.device)
    if on_card and not torch.cuda.is_available():
        print(f"perf_scale: no CUDA device (torch.cuda.is_available() is False); "
              f"backend={args.backend} runs on the card", file=sys.stderr)
        return 1
    workdir = os.path.abspath(args.keep or tempfile.mkdtemp(prefix="ntjoin_scale_"))
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    # the inputs come from a child process: at Gbp scale the generator holds
    # several GB, which would otherwise count in this process's peak RSS
    gen = subprocess.run(
        [sys.executable, "-c",
         "from ntjoin_tpu_torch.perf_scale import make_inputs; "
         f"make_inputs({workdir!r}, {args.mbp!r}, n_refs={args.refs})"],
        env=dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
    )
    if gen.returncode != 0:
        return 1
    ref_fas = [os.path.join(workdir, f"ref{r if r else ''}.fa") for r in range(args.refs)]
    tgt_fa = os.path.join(workdir, "target.fa")
    print(f"[inputs] {args.mbp} Mbp generated in {time.perf_counter() - t0:.1f}s", flush=True)

    from ntjoin_tpu_torch import cli
    from ntjoin_tpu_torch.ops import device_index, sketch_cuda, sketch_records

    out = {"rss_inherited_gb": inherited}
    if on_card:
        t0 = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        out["cuda_init_s"] = time.perf_counter() - t0
        out["rss_cuda_init_gb"] = (status_kb("VmRSS") or peak_rss_kb()) / 1e6
        torch.cuda.reset_peak_memory_stats()
    sketch_cuda.reset_counts()
    sketch_records.STAGES.clear()
    # artifact names are prefix + "." + target TSV name: relative paths, as
    # the reference's Makefile runs them
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        words = words_for(args, ref_fas, tgt_fa)
        sampler = RssSampler(args.py_top)
        t0 = time.perf_counter()
        with sampler:
            if args.profile:
                prof = cProfile.Profile()
                prof.enable()
                rc = cli.main(words)
                prof.disable()
                stats = pstats.Stats(prof, stream=sys.stdout)
                stats.sort_stats(args.sort).print_stats(35)
                stats.print_callees("find_paths")
            else:
                rc = cli.main(words)
        e2e_s = time.perf_counter() - t0
        out["sampled"] = sampler.report()
        if args.py_top:
            out["py_top"] = sampler.py_top()
        print(f"[e2e] assemble rc={rc} in {e2e_s:.1f}s", flush=True)
        stages = _stages()
    finally:
        os.chdir(cwd)
    result = {"mbp": args.mbp, "refs": args.refs, "backend": args.backend,
              "e2e_s": e2e_s, "rss_gb": _peak_rss_gb(), "rc": rc, "stages": stages, **out}
    if on_card:
        result.update(device_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                      device=torch.cuda.get_device_name(0),
                      sketch_counts=dict(sketch_cuda.COUNTS),
                      sketch_stages_s=dict(sketch_records.STAGES),
                      index_counts=device_index.counts_report())
    print(json.dumps(result), flush=True)
    if not args.keep:
        shutil.rmtree(workdir, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
