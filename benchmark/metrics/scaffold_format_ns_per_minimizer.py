"""scaffold_format_ns_per_minimizer: the ``scaffold/format`` span over the
job's counter ``path_minimizers`` (the minimizers of the paths that
``format_path`` walks), ns a minimizer, median over the traced jobs: a
rate that holds when a seed draws another number of contigs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import per_count  # noqa: E402


def read(run: dict) -> float | None:
    return per_count(run, lambda name: name == "scaffold/format", "path_minimizers", 1e9)
