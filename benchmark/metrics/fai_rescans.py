"""fai_rescans: the input FASTAs of a job whose ``.fai`` was written by
reading the file a second time (``write_fai``) rather than from the rows
the sketch's reader kept in its own read: the port's counter
``fai_rescans``, median over the traced jobs.  None where no job carries
the counter (a port that writes every ``.fai`` by a second read counts
nothing)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import _median  # noqa: E402


def read(run: dict) -> float | None:
    return _median(run, lambda spans, counters: counters.get("fai_rescans"))
