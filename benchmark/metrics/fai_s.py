"""fai_s: the ``.fai`` index of every input FASTA (``write_fai``): the
``fai:<fa>`` spans summed, median over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name.startswith("fai:"))
