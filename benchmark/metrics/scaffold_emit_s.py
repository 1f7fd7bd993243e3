"""scaffold_emit_s: the emission of the scaffold FASTAs, ``.path``, AGP
and unassigned records, overlap trim (``scaffold/emit/trim``) included:
the ``scaffold/emit`` span, median over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name == "scaffold/emit")
