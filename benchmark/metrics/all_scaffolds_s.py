"""all_scaffolds_s: the assigned and unassigned scaffold FASTAs copied
into the ``all`` one (``write_all_scaffolds``): the ``all_scaffolds``
span, median over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name == "all_scaffolds")
