"""The plain reference of one ``assemble``: each assembly's minimizer TSV
lines, the ``.path`` text and the scaffold FASTAs, from the input FASTAs
alone.

``DEFAULTS`` is the CLI's word table for what the reference reads: ntJoin's
Makefile defaults (``ntJoin:33-87``).
"""
from __future__ import annotations

import os

import numpy as np

from njref.assembly import AssemblySketch
from njref.config import ScaffoldConfig
from njref.fasta import read_fasta
from njref.scaffolder import Scaffolder

DEFAULTS = {
    "target_weight": "1", "w": "1000", "k": "32", "overlap": "True", "overlap_w": "10",
    "overlap_k": "15", "n": "1", "g": "20", "overlap_g": "", "G": "0", "mkt": "False",
    "m": "90", "no_cut": "False", "prefix": "",
}


def _truthy(val: str) -> bool:
    return val.strip().lower() in ("true", "1", "yes")


def settings(words: dict[str, str]) -> dict[str, str]:
    """The words of a job with the defaults filled in."""
    return {**DEFAULTS, **words}


def tsv_lines(records: list[tuple[str, bytes]], sketches, k: int) -> list[tuple[str, list[str]]]:
    """(record id, ``hash:pos:kmer`` tokens) of each record: an indexlr TSV's
    lines."""
    out = []
    for (name, seq), (pos, hashes) in zip(records, sketches):
        out.append((name, [f"{h}:{p}:{seq[p:p + k].decode()}"
                           for h, p in zip(hashes.tolist(), pos.tolist())]))
    return out


def artifacts(workdir: str, words: dict[str, str], device="cpu", hash_bits: int = 64) -> dict:
    """{"tsv": {fasta: lines}, "path", "assigned", "unassigned": text,
    "minimizers": {fasta: count}} of ``assemble`` with ``words`` (which name
    ``target`` and ``references``) over the FASTAs in ``workdir``."""
    from njref.sketch import sketch_records  # torch: loaded where the reference runs

    v = settings(words)
    if _truthy(v["mkt"]):
        raise ValueError("the plain reference has no Mann-Kendall orientation (mkt=True)")
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    refs = v["references"].split()
    tsv, counts, sketches = {}, {}, []
    for fa in refs + [v["target"]]:
        records = read_fasta(os.path.join(workdir, fa))
        sk = sketch_records([seq for _, seq in records], k, w, device, hash_bits)
        tsv[fa] = tsv_lines(records, sk, k)
        counts[fa] = sum(p.shape[0] for p, _ in sk)
        ctg = [np.full(p.shape[0], i, dtype=np.int32) for i, (p, _) in enumerate(sk)]
        sketches.append(AssemblySketch.from_stream(
            f"{fa}.k{k}.w{w}.tsv", 1.0, [name for name, _ in records],
            np.concatenate([h for _, h in sk]), np.concatenate([p for p, _ in sk]),
            np.concatenate(ctg)))
        if fa != v["target"]:
            del records
    cfg = ScaffoldConfig(
        references=[f"{fa}.k{k}.w{w}.tsv" for fa in refs],
        target=f"{v['target']}.k{k}.w{w}.tsv",
        target_weight=float(v["target_weight"]),
        reference_weights=[float(x) for x in v["reference_weights"].split()],
        prefix=v["prefix"] or f"out.k{k}.w{w}.n{n}",
        n=n, k=k, w=w, g=int(v["g"]), G=int(v["G"]), m=int(v["m"]),
        no_cut=_truthy(v["no_cut"]), overlap=_truthy(v["overlap"]),
        overlap_gap=int(v["overlap_g"] or v["g"]), overlap_k=int(v["overlap_k"]),
        overlap_w=int(v["overlap_w"]),
    )
    out = Scaffolder(cfg, sketches, records).run()
    return {"tsv": tsv, "minimizers": counts, **out}
