"""sketch_s: the FASTA read, sketch and TSV write of every assembly: the
median over the traced jobs of the summed ``sketch:<fa>`` stage walls."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _stages import walls  # noqa: E402


def read(run: dict) -> float | None:
    return walls(run, lambda name: name.startswith("sketch:"))
