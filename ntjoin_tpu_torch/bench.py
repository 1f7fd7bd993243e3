"""The port's benchmark on one CUDA GPU: minimizer sketch throughput on the
card and end-to-end scaffolding walls beside the port's host oracle.  The
counterpart of the JAX package's ``bench.py``.

    python -m ntjoin_tpu_torch.bench [--quick] [--no-3gbp]

In order:

1. ``baseline``: the port's native C++ sketcher (``io/native.py``) on 2^24
   seeded bases, k=32, w=1000, the least of 3 host-clock calls.
2. ``parity``: ``sketch_records_torch`` on the card against the native
   sketcher on a fresh 16,777,216-base record with a repeat run and a
   12,000,000-base record with N runs; positions and hashes equal, or the
   bench exits 1 before measuring anything else.
3. Device sketch cells from ``python -m ntjoin_tpu_torch.kernel_prof`` in a
   process of its own (its JSON lines): ``link``, ``fused`` (2^27 bases; CUDA
   events, three trials), ``multi`` (68 records of 2 Mbp) and ``general``
   (the same with 100 N runs of 500 bp; host clock, three trials, the
   ``STAGES`` split); ``fused`` again at w=5000 (one-chunk tiles) and
   w=10000 (the device-memory route).
4. ``process_start``: ``import torch`` and the first CUDA context in a fresh
   interpreter, three times.
5. ``e2e_30mbp``: the JAX bench's 30 Mbp cell (one reference of 5 Mbp
   records, 50 kbp contigs, every third reverse-complemented;
   ``reference_weights=2 n=2 overlap=False``), three runs of
   ``python -m ntjoin_tpu_torch.cli assemble backend=cuda`` and three of
   ``backend=native index_backend=host``, host clock around each process;
   every artifact byte-equal.  ``e2e_100mbp``: ``python -m
   ntjoin_tpu_torch.perf_scale --mbp 100 --refs 2`` on both, byte-equal.
6. ``idle``: one 100 Mbp ``assemble backend=cuda`` in this process under
   torch.profiler (CUDA activity): the union of the card's kernel, copy and
   fill intervals against the host-clock wall of the call and against the
   span from the first device event to the last.  Apart from the timed runs:
   the profiler inflates the wall.
7. ``scale_1gbp``: ``perf_scale --mbp 1000 --refs 2`` on the card (with
   ``--profile``: the callees of ``find_paths``) and on the host oracle,
   byte-equal; ``e2e_scaffold_3gbp``: ``--mbp 3000 --refs 2`` on the card
   (``--no-3gbp`` skips it; without the free disk it needs under the
   temporary directory the bench refuses to start).
8. ``scaling_proxy``: ``python -m ntjoin_tpu_torch.scaling_proxy``.

``--quick`` runs 1, 2, ``fused`` at w=1000, the 30 Mbp cell once a backend,
the idle share of a 30 Mbp ``assemble`` and the proxy at 4 Mbp with four
verdict widths; no 1 Gbp or 3 Gbp run.

The line before the last is ``{"detail": {...}}``; the last is the
headline: ``metric`` (``minimizer_sketch_throughput``), ``value`` (Gbp/s of
the fused cell at w=1000), ``unit``, ``vs_baseline``, ``multi_record_gbps``,
``general_n_rich_gbps``, ``e2e_scaffold_3gbp_wall_s``,
``e2e_scaffold_3gbp_rss_gb`` (null where this run did not measure them) and
``device``.  No file is written under the repository.  Without a CUDA
device it exits 1 with "no CUDA device" on stderr and prints no headline.
"""
from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ntjoin_tpu_torch import cli, perf_scale, split_bench
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.ops import sketch_records

K, W = 32, 1000
BASELINE_BASES = 1 << 24
FUSED_BASES = 1 << 27  # kernel_prof's default KP_SIZE
FUSED_WINDOWS = (1000, 5000, 10_000)
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "multi_record_gbps",
                 "general_n_rich_gbps", "e2e_scaffold_3gbp_wall_s", "e2e_scaffold_3gbp_rss_gb",
                 "device")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


class BenchError(RuntimeError):
    """A cell failed: a process exited non-zero, an output or an artifact
    differed."""


def _run(cmd: list[str], cwd: str | None = None, timeout: float = 3600,
         env: dict | None = None) -> tuple[float, str]:
    """(host-clock seconds, stdout) of a process that must exit 0."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, env=env or _ENV, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise BenchError(f"{' '.join(cmd[:5])} exited {res.returncode}:\n"
                         f"{res.stderr[-3000:]}{res.stdout[-1000:]}")
    return wall, res.stdout


def _last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise BenchError(f"no JSON line in:\n{out[-2000:]}")


def _spread(xs: list[float]) -> dict:
    return {"min": min(xs), "median": statistics.median(xs), "n": len(xs)}


# -- 1-3: sketch cells ---------------------------------------------------------------


def baseline() -> list[float]:
    """Host-clock seconds of three native sketches of 2^24 seeded bases."""
    if not native.available():
        raise BenchError("the native library is unavailable (no g++): it is the baseline")
    codes = np.random.default_rng(42).integers(0, 4, size=BASELINE_BASES).astype(np.uint8)
    out = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.sketch_codes_native(codes, K, W)
        out.append(time.perf_counter() - t0)
    return out


def parity_records(seed: int = 42) -> list[np.ndarray]:
    """A 16,777,216-base record with a 1,500-base repeat run and a
    12,000,000-base record with two N runs."""
    rng = np.random.default_rng(seed)
    clean = rng.integers(0, 4, size=16_777_216).astype(np.uint8)
    clean[2_000_000:2_001_500] = 1
    with_n = rng.integers(0, 4, size=12_000_000).astype(np.uint8)
    with_n[100_000:100_400] = 4
    with_n[7_000_000:7_000_050] = 4
    return [clean, with_n]


def parity_gate(device: str = "cuda") -> dict:
    """The card's sketch of the parity records against the native
    sketcher's; raises on any difference."""
    recs = parity_records()
    got = sketch_records.sketch_records_torch(recs, K, W, device)
    minimizers = []
    for i, (g, rec) in enumerate(zip(got, recs)):
        want = native.sketch_codes_native(rec, K, W)
        if not (np.array_equal(g.positions, want.positions)
                and np.array_equal(g.hashes, want.hashes)):
            raise BenchError(f"parity: record {i} ({rec.shape[0]} bases) differs between "
                             "the card and the native sketcher")
        minimizers.append(int(want.positions.shape[0]))
    return {"records": [int(r.shape[0]) for r in recs], "minimizers": minimizers,
            "equal": True}


def kernel_prof(stages: list[str], w: int = W) -> dict:
    """The profiler's JSON lines for ``stages`` at window ``w``, from a
    process of its own; every stage must print a result."""
    env = dict(_ENV, KP_W=str(w))
    _, out = _run([sys.executable, "-m", "ntjoin_tpu_torch.kernel_prof", *stages], cwd=_REPO,
                  timeout=1800, env=env)
    lines = {}
    for line in out.splitlines():
        lines.update(json.loads(line))
    bad = [s for s in stages if not isinstance(lines.get(s), dict) or "skipped" in lines[s]]
    if bad:
        raise BenchError(f"kernel_prof printed no result for {bad} at w={w}")
    return lines


# -- 4-7: end to end -------------------------------------------------------------------


_START = ("import json, time; t0 = time.perf_counter(); import torch; "
          "t1 = time.perf_counter(); from ntjoin_tpu_torch.utils.timers import status_kb; "
          "r1 = status_kb('VmRSS'); torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
          "t2 = time.perf_counter(); r2 = status_kb('VmRSS'); "
          "print(json.dumps({'import_torch_s': t1 - t0, 'cuda_init_s': t2 - t1, "
          "'rss_import_torch_gb': r1 / 1e6, 'rss_cuda_init_gb': r2 / 1e6}))")
START_KEYS = ("import_torch_s", "cuda_init_s", "rss_import_torch_gb", "rss_cuda_init_gb")


def process_start() -> dict:
    """``import torch`` and the first CUDA context, each in a fresh
    interpreter three times: their seconds and the resident set after
    each."""
    runs = [_last_json(_run([sys.executable, "-c", _START], timeout=300)[1])
            for _ in range(3)]
    return {key: _spread([r[key] for r in runs]) for key in START_KEYS}


_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = np.zeros(256, dtype=np.uint8)
_COMPLEMENT[_LETTERS] = np.frombuffer(b"TGCA", dtype=np.uint8)


def write_cell_inputs(workdir: str, mbp: int = 30, seed: int = 7) -> None:
    """The JAX bench's end-to-end inputs (``bench.py`` ``bench_e2e``): a
    random genome as ``ref.fa`` in records of 5 Mbp, and ``target.fa``, its
    50 kbp pieces in order with every third reverse-complemented; one line
    a record."""
    n = mbp * 1_000_000
    genome = _LETTERS[np.random.default_rng(seed).integers(0, 4, size=n)]
    with open(os.path.join(workdir, "ref.fa"), "wb") as fh:
        for i in range(0, n, 5_000_000):
            fh.write(b">r%d\n" % i + genome[i : i + 5_000_000].tobytes() + b"\n")
    with open(os.path.join(workdir, "target.fa"), "wb") as fh:
        for j, i in enumerate(range(0, n, 50_000)):
            seg = genome[i : i + 50_000]
            if j % 3 == 2:
                seg = _COMPLEMENT[seg[::-1]]
            fh.write(b">t%d\n" % j + seg.tobytes() + b"\n")


CELL_WORDS = ["assemble", "-B", "target=target.fa", "references=ref.fa", "reference_weights=2",
              "prefix=bench", f"k={K}", f"w={W}", "n=2", "overlap=False", "time=True"]
CARD_WORDS = ["backend=cuda"]
ORACLE_WORDS = ["backend=native", "index_backend=host"]


def stage_walls(out: str) -> dict:
    """The ``time=True`` table the CLI printed: {stage: wall seconds}."""
    lines = out.splitlines()
    if "stage\twall_s\tpeak_rss_kb" not in lines:
        return {}
    i = lines.index("stage\twall_s\tpeak_rss_kb")
    return {name: float(wall) for name, wall, _ in
            (ln.split("\t") for ln in lines[i + 1 :] if ln.count("\t") == 2
             and "_counts\t" not in ln)}


def same_artifacts(got: str, want: str) -> int:
    """Every file of ``want`` (the host oracle's directory) but the stage
    timings, byte-equal in ``got``, and no other file there; returns how
    many."""
    names = sorted(f for f in os.listdir(want) if not f.endswith(".time"))
    extra = sorted(f for f in os.listdir(got) if not f.endswith(".time") and f not in names)
    if extra:
        raise BenchError(f"artifacts only the card run made: {extra}")
    for f in names:
        a = os.path.join(got, f)
        if not os.path.exists(a) or not filecmp.cmp(a, os.path.join(want, f), shallow=False):
            raise BenchError(f"artifact {f} differs between the card run and the host oracle")
    return len(names)


def _linked_copy(src: str, dst: str, names: list[str]) -> str:
    os.makedirs(dst)
    for f in names:
        os.link(os.path.join(src, f), os.path.join(dst, f))
    return dst


def e2e_cell(tmp: str, runs: int) -> tuple[dict, str]:
    """The 30 Mbp cell, ``runs`` processes a backend; returns its detail and
    the directory of its inputs."""
    inputs = os.path.join(tmp, "cell30")
    os.makedirs(inputs)
    write_cell_inputs(inputs)
    out = {}
    for name, words in (("cuda", CARD_WORDS), ("native_host", ORACLE_WORDS)):
        work = _linked_copy(inputs, os.path.join(tmp, f"cell30_{name}"),
                            ["ref.fa", "target.fa"])
        walls, stdout = [], ""
        for _ in range(runs):
            wall, stdout = _run([sys.executable, "-m", "ntjoin_tpu_torch.cli",
                                 *CELL_WORDS, *words], cwd=work)
            walls.append(wall)
        out[name] = {"wall_s": sorted(walls), **_spread(walls),
                     "stages_s": stage_walls(stdout),
                     "sketch_counts": json.loads(next(
                         ln for ln in stdout.splitlines()
                         if ln.startswith("sketch_counts\t")).split("\t", 1)[1])}
    out["artifacts_equal"] = same_artifacts(os.path.join(tmp, "cell30_cuda"),
                                            os.path.join(tmp, "cell30_native_host"))
    return out, inputs


def perf_scale_pair(tmp: str, mbp: int, refs: int, profile: bool = False,
                    oracle: bool = True) -> dict:
    """``perf_scale`` on the card (and on the host oracle), work kept under
    ``tmp``; artifacts byte-equal; returns each run's JSON line and, with
    ``profile``, the card run's cProfile lines of the path passes."""
    out = {}
    runs = [("cuda", ["--backend", "cuda"] + (["--profile"] if profile else []))]
    if oracle:
        runs.append(("native_host", ["--backend", "native", "--index_backend", "host"]))
    for name, flags in runs:
        keep = os.path.join(tmp, f"scale{mbp}_{name}")
        _, stdout = _run([sys.executable, "-m", "ntjoin_tpu_torch.perf_scale", "--mbp",
                          str(mbp), "--refs", str(refs), "--keep", keep, *flags])
        out[name] = _last_json(stdout)
        if out[name]["rc"] != 0:
            raise BenchError(f"perf_scale --mbp {mbp} on {name} returned rc {out[name]['rc']}")
        if profile and name == "cuda":
            out["find_paths_profile"] = [ln.strip() for ln in stdout.splitlines()
                                         if re.search(r"paths\.py|find_paths", ln)]
    if oracle:
        out["artifacts_equal"] = same_artifacts(os.path.join(tmp, f"scale{mbp}_cuda"),
                                                os.path.join(tmp, f"scale{mbp}_native_host"))
    return out


def idle_share(workdir: str, words: list[str]) -> dict:
    """One ``cli.main(words)`` in ``workdir``, in this process, under
    torch.profiler with CUDA activity: the share of its host-clock wall and
    of its device span in which no kernel, copy or fill ran on the card."""
    from torch.profiler import ProfilerActivity, profile

    cwd = os.getcwd()
    os.chdir(workdir)
    try:  # the CLI's log goes to stderr: stdout holds the bench's lines
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            rc = cli.main(words)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise BenchError(f"the traced assemble returned {rc}")
    spans = split_bench.device_spans(prof, ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        raise BenchError("the traced assemble put no event on the card")
    busy = split_bench.busy_us(spans)
    span = max(hi for _, hi, *_ in spans) - spans[0][0]
    events = {}
    for *_, cat in spans:
        events[cat] = events.get(cat, 0) + 1
    return {"traced_wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "device_span_s": span / 1e6, "events": events,
            "idle_share_of_wall": 1 - busy / wall_us, "idle_share_of_span": 1 - busy / span}


# -- the bench -----------------------------------------------------------------------


def _gbps(bases: int, seconds: list[float] | None) -> float | None:
    return bases / min(seconds) / 1e9 if seconds else None


def summarize(cells: dict) -> tuple[dict, dict]:
    """(detail, headline) from the raw cells: ``baseline_s`` (seconds of
    ``baseline_bases``), ``fused`` ({w: kernel_prof's fused line}), and
    where they ran ``multi`` / ``general`` (kernel_prof's lines, over
    ``fused_bases``), ``scale3`` (perf_scale's JSON line), and every other
    cell as it is.  Throughputs in Gbp/s: bases over the least time."""
    base_gbps = _gbps(cells["baseline_bases"], cells["baseline_s"])
    size = cells["fused_bases"]
    detail = {"k": K, "w": W, "bases": size, "baseline": "native C++ rolling sketcher",
              "baseline_gbps": base_gbps, "baseline_s": _spread(cells["baseline_s"])}
    for w, line in sorted(cells["fused"].items()):
        detail[f"fused_w{w}"] = {"ms": _spread(line["ms_trials"]),
                                 "gbps": size / min(line["ms_trials"]) / 1e6,
                                 "per_call_ms": line["per_call_ms"],
                                 "emissions": line["emissions"]}
    rates = {}
    for name in ("multi", "general"):
        line = cells.get(name)
        rates[name] = _gbps(size, line["wall_s"]) if line else None
        if line:
            detail[name] = {"wall_s": _spread(line["wall_s"]), "gbps": rates[name],
                            "records": line["records"], "stages_s": line["stages_s"]}
    for key, val in cells.items():
        if key not in ("baseline_s", "baseline_bases", "fused_bases", "fused", "multi",
                       "general", "device"):
            detail[key] = val
    value = size / min(cells["fused"][W]["ms_trials"]) / 1e6
    scale3 = cells.get("scale3") or {}
    headline = {
        "metric": "minimizer_sketch_throughput",
        "value": value,
        "unit": "Gbp/s",
        "vs_baseline": value / base_gbps,
        "multi_record_gbps": rates["multi"],
        "general_n_rich_gbps": rates["general"],
        "e2e_scaffold_3gbp_wall_s": scale3.get("e2e_s"),
        "e2e_scaffold_3gbp_rss_gb": scale3.get("rss_gb"),
        "device": cells["device"],
    }
    return detail, headline


def disk_needed(mbp: float, refs: int) -> float:
    """Bytes a ``perf_scale`` run writes, with a twentieth to spare: the
    FASTAs of the references and the target (81 bytes a line of 80 bases),
    the assigned and all scaffold FASTAs, each about the genome, and the
    minimizer TSVs and the graph's DOT, under a byte a base in all (17.3 GB
    written at 3 Gbp and 2 references)."""
    return mbp * 1e6 * (81 / 80 * (refs + 3) + 1) * 1.05


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m ntjoin_tpu_torch.bench")
    ap.add_argument("--quick", action="store_true",
                    help="parity, fused w=1000, the 30 Mbp cell once, its idle share, "
                         "the proxy at 4 Mbp")
    ap.add_argument("--no-3gbp", dest="no_3gbp", action="store_true",
                    help="skip the 3 Gbp + 2 references run")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, tmp: str) -> dict:
    """Every cell of this mode, in order; returns the raw cells."""
    def say(msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    cells = {"device": torch.cuda.get_device_name(0), "baseline_bases": BASELINE_BASES,
             "fused_bases": FUSED_BASES, "mode": "quick" if args.quick else "full"}
    cells["baseline_s"] = baseline()
    cells["parity"] = parity_gate()
    say("parity gate passed")
    prof = kernel_prof(["fused"] if args.quick else ["link", "fused", "multi", "general"])
    cells["fused"] = {W: prof["fused"]}
    if not args.quick:
        cells["link"] = prof["link"]
        cells["multi"], cells["general"] = prof["multi"], prof["general"]
        for w in FUSED_WINDOWS[1:]:
            cells["fused"][w] = kernel_prof(["fused"], w)["fused"]
        cells["process_start"] = process_start()
    say("device cells done")
    cells["e2e_30mbp"], inputs30 = e2e_cell(tmp, 1 if args.quick else 3)
    say("30 Mbp cell done")
    if args.quick:
        work = _linked_copy(inputs30, os.path.join(tmp, "idle30"), ["ref.fa", "target.fa"])
        cells["idle_30mbp"] = idle_share(work, CELL_WORDS + CARD_WORDS)
    else:
        cells["e2e_100mbp"] = perf_scale_pair(tmp, 100, 2)
        work = _linked_copy(os.path.join(tmp, "scale100_cuda"), os.path.join(tmp, "idle100"),
                            ["ref.fa", "ref1.fa", "target.fa"])
        words = perf_scale.words_for(perf_scale.parse_args(["--refs", "2"]),
                                     ["ref.fa", "ref1.fa"], "target.fa")
        cells["idle_100mbp"] = idle_share(work, words)
        for d in ("scale100_cuda", "scale100_native_host", "idle100"):
            shutil.rmtree(os.path.join(tmp, d))
        say("100 Mbp cell and idle share done")
        cells["scale_1gbp"] = perf_scale_pair(tmp, 1000, 2, profile=True)
        for d in ("scale1000_cuda", "scale1000_native_host"):
            shutil.rmtree(os.path.join(tmp, d))
        say("1 Gbp pair done")
        if not args.no_3gbp:
            cells["scale3"] = perf_scale_pair(tmp, 3000, 2, oracle=False)["cuda"]
            say("3 Gbp run done")
    proxy = ["--widths", "4096,16384,65536,262144"] if args.quick else []
    cells["scaling_proxy"] = _last_json(_run(
        [sys.executable, "-m", "ntjoin_tpu_torch.scaling_proxy", *proxy], timeout=1800)[1])
    return cells


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); the bench "
              "measures the port on the card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="ntjoin_bench_") as tmp:
        if not args.quick and not args.no_3gbp:
            need, free = disk_needed(3000, 2), shutil.disk_usage(tmp).free
            if free < need:
                print(f"bench: refusing the 3 Gbp + 2 references run: it needs "
                      f"~{need / 1e9:.1f} GB free under {tempfile.gettempdir()}, "
                      f"{free / 1e9:.1f} GB are (--no-3gbp skips it)", file=sys.stderr)
                return 1
        try:
            cells = run(args, tmp)
        except BenchError as exc:
            print(f"bench: FAIL: {exc}", file=sys.stderr)
            return 1
    detail, headline = summarize(cells)
    print(json.dumps({"detail": detail}))
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
