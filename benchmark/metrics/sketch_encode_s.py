"""sketch_encode_s: each assembly's records planned (path probe, bounds)
and encoded into the batch buffers: the ``sketch:<fa>/plan`` and
``sketch:<fa>/pack`` spans summed, median over the traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import in_sketch, seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, in_sketch("plan", "pack"))
