"""The control of the comparison that decides ``correct``: the plain
reference put in the port's place at the nearest precision below the one
ntHash states, its 64-bit canonical hash cut to 32 bits, compared with the
reference by ``njbench.check`` on the cell's own inputs.  Each number it
gives is an upper reading of that number's limit (0).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

prints one JSON line a seed and, last, the least reading of each number.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

from njbench import check, gen  # noqa: E402
from njref.pipeline import artifacts, settings  # noqa: E402


def write_artifacts(out_dir: str, art: dict, words: dict[str, str]) -> None:
    """``art`` (``njref.pipeline.artifacts``) as the files a job writes."""
    v = settings(words)
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    for fa, lines in art["tsv"].items():
        with open(os.path.join(out_dir, f"{fa}.k{k}.w{w}.tsv"), "w", encoding="utf-8") as fh:
            for name, toks in lines:
                fh.write(f"{name}\t{' '.join(toks)}\n")
    with open(os.path.join(out_dir, (v["prefix"] or f"out.k{k}.w{w}.n{n}") + ".path"), "w",
              encoding="utf-8") as fh:
        fh.write(art["path"])
    base = os.path.join(out_dir, f"{v['target']}.k{k}.w{w}.n{n}")
    for part, text in (("assigned", art["assigned"]), ("unassigned", art["unassigned"]),
                       ("all", art["assigned"] + art["unassigned"])):
        with open(f"{base}.{part}.scaffolds.fa", "w", encoding="utf-8") as fh:
            fh.write(text)


def control(config: dict, traffic: dict, seed: int, device: str) -> dict[str, int]:
    """The comparison's numbers for the control on one seed's inputs."""
    work = tempfile.mkdtemp(prefix="njbench-control-")
    try:
        inputs = gen.generate(config, traffic, seed, work)
        words = {**config["words"], **traffic.get("words", {}), "target": inputs["target"],
                 "references": " ".join(inputs["references"])}
        ref = artifacts(work, words, device)
        out_dir = os.path.join(work, "control")
        os.makedirs(out_dir)
        write_artifacts(out_dir, artifacts(work, words, device, hash_bits=32), words)
        return check.compare(out_dir, ref, words)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json"), encoding="utf-8") as fh:
        cell = next(w for w in json.load(fh)["workloads"] if w["name"] == args.workload)
    with open(os.path.join(BENCH_DIR, "configs", cell["config"] + ".json"), encoding="utf-8") as fh:
        config = json.load(fh)
    with open(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"), encoding="utf-8") as fh:
        traffic = json.load(fh)
    least = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control(config, traffic, seed, args.device)
        print(json.dumps({"seed": seed, **got}), flush=True)
        least = {k: min(v, least.get(k, v)) for k, v in got.items()}
    print(json.dumps({"workload": args.workload, "least": least, "limits": check.LIMITS}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
