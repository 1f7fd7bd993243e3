"""Resolution of intersecting claimed regions on one contig.

When cut paths claim overlapping target regions, the longest ("best") region
wins; subsumed regions are dropped and partial overlaps trimmed to abut it,
followed by an iterative fix-up sweep until no pair overlaps.  Reproduces
reference ``overlap_region.py:7-91`` (note its closed-coordinate overlap
test, distinct from the half-open BED test used for flagging).
"""
from __future__ import annotations

from njref.pathnode import Bed


def _overlapping(r1: Bed, r2: Bed) -> bool:
    return r1.start <= r2.end and r2.start <= r1.end


def _subsumed(r1: Bed, r2: Bed) -> bool:
    return r1.start >= r2.start and r1.end <= r2.end


class OverlapRegionResolver:
    """Collects flagged regions of one contig and resolves the overlaps."""

    def __init__(self):
        self.regions: list[Bed] = []
        self.best: Bed | None = None

    def add(self, region: Bed) -> None:
        if self.best is None or (region.end - region.start) > (
            self.best.end - self.best.start
        ):
            self.best = region
        assert self.best.contig == region.contig
        self.regions.append(region)

    def resolve(self) -> dict[Bed, Bed | None] | None:
        """Map each region to its replacement (None = dropped)."""
        if not self.regions or self.best is None:
            return None
        best = self.best
        result: dict[Bed, Bed | None] = {}
        for region in self.regions:
            if region == best:
                result[region] = region
            elif _subsumed(region, best):
                result[region] = None
            elif _overlapping(region, best):
                if region.start <= best.start:
                    result[region] = Bed(region.contig, region.start, best.start - 1)
                elif region.end >= best.end:
                    result[region] = Bed(region.contig, best.end + 1, region.end)
            else:
                result[region] = region

        # Iterative fix-up: adjust the smaller of any still-overlapping pair.
        # Each sweep compares the snapshot taken at sort time and writes the
        # adjustments into ``result``; changes are only observed on the next
        # sweep (exactly the reference's update discipline, :56-89).
        dirty = True
        while dirty:
            dirty = False
            survivors = sorted(
                ((before, after) for before, after in result.items() if after is not None),
                key=lambda item: item[1],
            )
            for (b1, a1), (b2, a2) in zip(survivors, survivors[1:]):
                if not _overlapping(a1, a2):
                    continue
                dirty = True
                if _subsumed(a1, a2):
                    result[b1] = None
                elif _subsumed(a2, a1):
                    result[b2] = None
                elif (a1.end - a1.start) > (a2.end - a2.start):
                    result[b2] = Bed(a2.contig, a1.end + 1, a2.end)
                else:
                    result[b1] = Bed(a1.contig, a1.start, a2.start - 1)
        return result
