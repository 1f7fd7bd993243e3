"""scaffold_paths_s: ``FastaStore`` and ``find_paths`` (``scaffold/paths``),
then ``format_path``, the tally, the relocation merge, no-cut and the
intersecting regions (``scaffold/format``), summed, median over the
traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name in ("scaffold/paths", "scaffold/format"))
