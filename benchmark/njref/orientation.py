"""Contig orientation from minimizer position trends.

Reference semantics (``ntjoin_assemble.py:30-50``) without ``--mkt``: strict
monotonicity wins; otherwise a >= m% monotone pair vote decides; '?' when
undecidable.  The Mann-Kendall branch (``mkt=True``) is not here: no cell
runs it, and ``pipeline.artifacts`` refuses it.
"""
from __future__ import annotations

from typing import Sequence


def determine_orientation(positions: Sequence[int], m_percent: float) -> str:
    """'+', '-' or '?' for a run of target minimizer positions."""
    if len(positions) <= 1:
        return "?"
    inc = all(x < y for x, y in zip(positions, positions[1:]))
    if inc:
        return "+"
    dec = all(x > y for x, y in zip(positions, positions[1:]))
    if dec:
        return "-"
    up = sum(1 for x, y in zip(positions, positions[1:]) if x < y)
    positive_perc = up / float(len(positions) - 1) * 100.0
    if positive_perc >= m_percent:
        return "+"
    if 100.0 - positive_perc >= m_percent:
        return "-"
    return "?"


def determine_orientations(runs: Sequence[Sequence[int]], m_percent: float) -> list[str]:
    """Orientations for a batch of position runs (one path's contig runs)."""
    return [determine_orientation(r, m_percent) for r in runs]
