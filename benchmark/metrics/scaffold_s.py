"""scaffold_s: the ``scaffold`` stage wall (index, graph, paths,
orientation, gaps, overlap trim, emission), median over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _stages import walls  # noqa: E402


def read(run: dict) -> float | None:
    return walls(run, lambda name: name == "scaffold")
