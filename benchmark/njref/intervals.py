"""Interval arithmetic replacing the bedtools/pybedtools dependency.

Pure NumPy sweeps implementing the three operations the reference shells out
for: lexicographic BED sort + self-intersection counts (reference
``ntjoin_assemble.py:660-686``) and per-genome complement (reference
``ntjoin_assemble.py:628-658``).  BED intervals are 0-based half-open.
"""
from __future__ import annotations

import numpy as np

from njref.pathnode import Bed


def sort_beds(beds: list[Bed]) -> list[Bed]:
    """Lexicographic (chrom, start, end) sort — pybedtools .sort() default."""
    return sorted(beds, key=lambda b: (b.contig, b.start, b.end))


def self_intersect_counts(beds: list[Bed]) -> list[int]:
    """For each interval, how many intervals of the set overlap it (>=1 bp).

    Mirrors ``bedtools intersect -c -wa`` with the file against itself
    (half-open overlap test; every interval counts itself).  O(n log n)
    sort/sweep per contig — bedtools-class scaling, not the naive all-pairs
    compare: overlaps(i) = #{start_j < end_i} - #{end_j <= start_i} (an
    interval failing the second test while passing the first would need
    end_j <= start_i < end_i <= start_j, contradicting start_j < end_j).
    """
    by_ctg: dict[str, list[int]] = {}
    for i, b in enumerate(beds):
        by_ctg.setdefault(b.contig, []).append(i)
    counts = [0] * len(beds)
    for idxs in by_ctg.values():
        starts = np.array([beds[i].start for i in idxs])
        ends = np.array([beds[i].end for i in idxs])
        starts_sorted = np.sort(starts)
        ends_sorted = np.sort(ends)
        c = np.searchsorted(starts_sorted, ends, side="left") - np.searchsorted(
            ends_sorted, starts, side="right"
        )
        for i, ci in zip(idxs, c):
            counts[i] = int(ci)
    return counts


def complement(
    beds: list[Bed], genome: list[tuple[str, int]]
) -> list[Bed]:
    """Uncovered regions per genome contig, in genome order.

    Mirrors ``bedtools complement`` with a genome file: per contig, the gaps
    of the union of intervals within [0, length).
    """
    by_ctg: dict[str, list[Bed]] = {}
    for b in beds:
        by_ctg.setdefault(b.contig, []).append(b)
    out: list[Bed] = []
    for name, length in genome:
        ivs = sorted(
            (max(0, b.start), min(length, b.end)) for b in by_ctg.get(name, [])
        )
        cursor = 0
        for s, e in ivs:
            if s > cursor:
                out.append(Bed(name, cursor, s))
            cursor = max(cursor, e)
        if cursor < length:
            out.append(Bed(name, cursor, length))
    return out
