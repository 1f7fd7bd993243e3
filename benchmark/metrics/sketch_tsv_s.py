"""sketch_tsv_s: the minimizer TSV text of every assembly
(``write_minimizer_tsv``): the ``sketch:<fa>/tsv`` spans summed, median
over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import in_sketch, seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, in_sketch("tsv"))
