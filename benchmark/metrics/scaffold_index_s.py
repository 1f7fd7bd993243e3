"""scaffold_index_s: the sketches loaded and the shared index built (the
``scaffold/index`` span), median over the traced jobs.  Its cost is mostly
fixed: it moves little with the number of minimizers or assemblies that
feed it, so it is a time and not a rate."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import seconds  # noqa: E402


def read(run: dict) -> float | None:
    return seconds(run, lambda name: name == "scaffold/index")
