"""The benchmark of ``ntjoin_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``benchmark/configs/<config>.json``) and a traffic
mix (``benchmark/traffic/<traffic>.json``); each metric is read by
``benchmark/metrics/<name>.py``.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones.  The last line of stdout is the
result as JSON; the last lines of stderr are the numbers compared, each
beside its limit.  Exits with no result: 3 where the cards the cell asks for
are not there or the jobs saw another number of them, 4 where a module of
``jax``, ``jaxlib``, ``flax`` or ``ntjoin_tpu`` was loaded in this process
or in any child of the run (set-up, job, reference).
"""
import time

T_START = time.perf_counter()  # set-up counts from here, before torch loads

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".benchcache")  # fixed, inside the checkout
sys.path[:0] = [p for p in (ROOT, BENCH_DIR) if p not in sys.path]

from njbench.proc import forbidden_modules  # noqa: E402  (the standard library alone)


def _cell(name: str) -> tuple[dict, dict, dict, list[dict], list[dict]]:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as fh:
        bench = json.load(fh)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    with open(os.path.join(BENCH_DIR, "configs", cell["config"] + ".json"), encoding="utf-8") as fh:
        config = json.load(fh)
    with open(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"), encoding="utf-8") as fh:
        traffic = json.load(fh)

    def mine(metric):
        return name in metric.get("workloads", [name])

    return (cell, config, traffic, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, traffic, e2e, layers = _cell(args.workload)

    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    from njbench import gen  # numpy alone

    inputs = gen.Inputs(config, traffic, args.seed)  # written while torch loads
    try:
        import torch  # noqa: F401 - set-up: what every job would import

        import ntjoin_tpu_torch.cli  # noqa: F401
        from njbench import harness

        try:
            run = harness.run_cell(config, traffic, args.seed, args.seconds, bool(args.trace),
                                   T_START, chips=cell["chips"], inputs=inputs)
        except harness.NoDevice as exc:
            print(f"ERROR: {exc}", file=sys.stderr)
            return 3
    finally:
        inputs.close()
    if run["cards"] is not None and run["cards"] != [cell["chips"]]:
        print(f"ERROR: the jobs saw {run['cards']} CUDA device(s), the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 3
    out = harness.result(run, layers if args.trace else e2e, run["devices"]["kind"],
                         cell["chips"])
    bad = forbidden_modules()
    if bad or run["forbidden"]:
        print("ERROR: forbidden modules loaded: in the process that prints the result: "
              + (", ".join(bad) or "none") + "; in the run's children: "
              + (", ".join(run["forbidden"]) or "none"), file=sys.stderr)
        return 4
    jobs = run["jobs"]
    detail = {"jobs": len(jobs), "walls_s": [j["wall_s"] for j in jobs],
              "main_s": [j.get("main_s") for j in jobs],
              "rc": [j["rc"] for j in jobs],
              "job_peak_rss_gb": [j.get("peak_rss_kb", 0) / 1e6 for j in jobs],
              "job_end_maxrss_gb": [j.get("end_maxrss_kb", 0) / 1e6 for j in jobs],
              "job_exit_maxrss_gb": [j["maxrss_kb"] / 1e6 for j in jobs],
              "job_start_rss_gb": [(j.get("start_rss_kb") or 0) / 1e6 for j in jobs],
              "rss_inherited_gb": run["harness_peak_kb"] / 1e6,
              "bytes_written": {"inputs": run["input_bytes"],
                                "jobs": [j["bytes_written"] for j in jobs]},
              "setup_s": run["setup_s"], "setup_parts": run["setup_parts"],
              "window_s": run["window_s"], "cards": run["cards"],
              "reference_s": run["reference_s"], "inputs": {
                  k: v for k, v in run["inputs"].items() if k != "contig_lengths"},
              "minimizers": run["minimizers"], "devices": run["devices"]}
    if args.trace:
        detail["power"] = run.get("power")
        detail["process_start"] = run.get("process_start")
        for key in ("sketch_counts", "index_counts", "sketch_stages"):
            detail[key] = [j.get(key) for j in jobs]
        detail["stages"] = [j.get("stages") for j in jobs]
        detail["device_peak_gb"] = [j.get("device_peak_bytes", 0) / 1e9 for j in jobs]
    print("detail " + json.dumps(detail))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
