"""unique_s: the per-assembly uniqueness filter (``AssemblySketch.from_stream``,
once for each assembly after its sketch stage): the ``unique:<fa>`` spans
summed, median over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name.startswith("unique:"))
