"""Path data model: oriented contig regions in a scaffold path.

Counterpart of reference ``path_node.py:13-66`` and the ``Bed`` namedtuple
(``ntjoin_utils.py:17``); the trimming-aware coordinate getters implement the
same orientation-dependent arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


class Bed(NamedTuple):
    contig: str
    start: int
    end: int


class OrientationError(ValueError):
    def __init__(self):
        super().__init__("Orientation must be + or -")


@dataclass
class PathNode:
    """One oriented region of a target contig within a scaffold path."""

    contig: str
    ori: str  # '+', '-' or '?'
    start: int
    end: int
    contig_size: int
    first_mx: int  # graph node id of the first minimizer of the run
    terminal_mx: int  # graph node id of the last minimizer of the run
    gap_size: int = 0
    raw_gap_size: int = 0
    start_adjust: int = 0  # overlap-trim cut offsets (aligned coordinates)
    end_adjust: int = 0

    @property
    def aligned_length(self) -> int:
        return self.end - self.start

    def end_adjusted_coordinate(self) -> int:
        """End cut point in aligned coordinates (aligned_length if untrimmed)."""
        return self.end_adjust if self.end_adjust != 0 else self.aligned_length

    def adjusted_start(self) -> int:
        if self.ori == "+":
            return self.start + self.start_adjust
        if self.ori == "-":
            return self.start + (self.aligned_length - self.end_adjusted_coordinate())
        raise OrientationError()

    def adjusted_end(self) -> int:
        if self.ori == "+":
            return self.end - (self.aligned_length - self.end_adjusted_coordinate())
        if self.ori == "-":
            return self.end - self.start_adjust
        raise OrientationError()

    def bed(self) -> Bed:
        return Bed(self.contig, self.start, self.end)
