"""scaffold_graph_s: the sketches loaded and the shared index built
(``scaffold/index``), the graph built, written (``.mx.dot``) and filtered
with the target's extremes (``scaffold/graph``), summed, median over the
traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name in ("scaffold/index", "scaffold/graph"))
