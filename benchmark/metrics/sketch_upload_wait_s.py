"""sketch_upload_wait_s: the host's wait on each batch's upload, its
kernels and the copies back, up to the sync on its result: the
``sketch:<fa>/device`` spans summed, median over the traced jobs.  Host
clock: the card is busy for a small part of it (``sketch_roofline`` and
``device_idle_pct`` read the device's own time)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import in_sketch, seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, in_sketch("device"))
