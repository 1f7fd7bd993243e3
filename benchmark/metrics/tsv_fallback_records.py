"""tsv_fallback_records: the records whose minimizer TSV line the port's
Python formatter wrote in a job, where the native library's formatter was
not loaded (the port's counter ``tsv_fallback_records``), median over the
traced jobs.  None where no job carries the counter (a port that formats
every line in Python counts nothing)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import _median  # noqa: E402


def read(run: dict) -> float | None:
    return _median(run, lambda spans, counters: counters.get("tsv_fallback_records"))
