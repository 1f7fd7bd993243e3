"""The comparison that decides ``correct``: a job's artifacts against the
plain reference's, as counts of what differs, each held to the limit 0.

- ``tsv_tokens``: ``hash:pos:kmer`` tokens of the minimizer TSVs that differ
  from the reference's, position by position in each record (the sketch);
- ``path_lines``: lines of the ``.path`` file that differ (graph and paths);
- ``scaffold_bytes``: bytes of the assigned, unassigned and ``all`` scaffold
  FASTAs that differ (emission).

A missing record, line or byte counts as differing; a missing file counts
as all of the reference's.
"""
from __future__ import annotations

import os

import numpy as np

from njref.pipeline import settings

LIMITS = {"tsv_tokens": 0, "path_lines": 0, "scaffold_bytes": 0}


def _read(path: str) -> bytes | None:
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError:
        return None


def tsv_diff(path: str, want: list[tuple[str, list[str]]]) -> int:
    data = _read(path)
    if data is None:
        return sum(len(toks) + 1 for _, toks in want)
    got = []
    for line in data.decode("utf-8", "replace").splitlines():
        name, _, rest = line.partition("\t")
        got.append((name, rest.split(" ") if rest else []))
    diff = 0
    for i in range(max(len(got), len(want))):
        g = got[i] if i < len(got) else None
        w = want[i] if i < len(want) else None
        if g is None or w is None or g[0] != w[0]:
            diff += len((g or w)[1]) + 1
            continue
        m = min(len(g[1]), len(w[1]))
        diff += sum(a != b for a, b in zip(g[1][:m], w[1][:m])) + abs(len(g[1]) - len(w[1]))
    return diff


def lines_diff(got: bytes | None, want: str) -> int:
    want_lines = want.splitlines()
    if got is None:
        return len(want_lines)
    got_lines = got.decode("utf-8", "replace").splitlines()
    return sum(a != b for a, b in zip(got_lines, want_lines)) + abs(len(got_lines) - len(want_lines))


def bytes_diff(got: bytes | None, want: bytes) -> int:
    if got is None:
        return len(want)
    a, b = np.frombuffer(got, dtype=np.uint8), np.frombuffer(want, dtype=np.uint8)
    m = min(a.shape[0], b.shape[0])
    return int(np.count_nonzero(a[:m] != b[:m])) + abs(a.shape[0] - b.shape[0])


def compare(job_dir: str, ref: dict, words: dict[str, str]) -> dict[str, int]:
    """The counts of what differs between a job's artifacts and ``ref``
    (``njref.pipeline.artifacts`` of the same words)."""
    v = settings(words)
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    prefix = v["prefix"] or f"out.k{k}.w{w}.n{n}"
    tsv = sum(tsv_diff(os.path.join(job_dir, f"{fa}.k{k}.w{w}.tsv"), lines)
              for fa, lines in ref["tsv"].items())
    path = lines_diff(_read(os.path.join(job_dir, prefix + ".path")), ref["path"])
    base = os.path.join(job_dir, f"{v['target']}.k{k}.w{w}.n{n}")
    assigned, unassigned = ref["assigned"].encode(), ref["unassigned"].encode()
    scaffolds = (bytes_diff(_read(base + ".assigned.scaffolds.fa"), assigned)
                 + bytes_diff(_read(base + ".unassigned.scaffolds.fa"), unassigned)
                 + bytes_diff(_read(base + ".all.scaffolds.fa"), assigned + unassigned))
    return {"tsv_tokens": tsv, "path_lines": path, "scaffold_bytes": scaffolds}
