"""scaffold_filter_ns_per_edge: the global weight filter
(``scaffold/graph/filter``) and the escalating branch filter
(``scaffold/paths/branch``) summed, over the job's counter ``graph_edges``
(the graph's edges before either filter), ns an edge, median over the
traced jobs."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _spans import per_count  # noqa: E402


def read(run: dict) -> float | None:
    return per_count(run, lambda name: name in ("scaffold/graph/filter", "scaffold/paths/branch"),
                     "graph_edges", 1e9)
