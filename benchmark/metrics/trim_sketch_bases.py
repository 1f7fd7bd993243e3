"""trim_sketch_bases: the bases the overlap trim handed to its sketch in a
job (the port's counter ``trim_sketch_bases``: the overlap ends it keeps,
summed over the nodes of the paths), median over the traced jobs.  None
where no job carries the counter (a port that sketches each whole masked
segment counts nothing)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import _median  # noqa: E402


def read(run: dict) -> float | None:
    return _median(run, lambda spans, counters: counters.get("trim_sketch_bases"))
