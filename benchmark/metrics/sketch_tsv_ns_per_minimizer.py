"""sketch_tsv_ns_per_minimizer: the ``sketch:<fa>/tsv`` spans summed over
the job's counter ``minimizers`` (emitted, every assembly), ns a
minimizer, median over the traced jobs: a rate that holds when a seed
draws another number of records."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import in_sketch, per_count  # noqa: E402


def read(run: dict) -> float | None:
    return per_count(run, in_sketch("tsv"), "minimizers", 1e9)
