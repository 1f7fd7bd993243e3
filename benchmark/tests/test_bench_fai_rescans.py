"""The reader of the port's counter ``fai_rescans``: None for jobs without
it (a port that counts nothing), the median over the jobs that carry it."""
import pytest

from njbench import harness


def _run(*counters):
    """A run whose jobs carry these counters (None: a job without a
    ``trace_counts`` line)."""
    return {"jobs": [{"trace_counts": None if c is None else {"spans": {}, "counters": c}}
                     for c in counters]}


@pytest.mark.parametrize("counters,want", [
    ((None, None), None),
    (({}, {"minimizers": 5}), None),
    (({"fai_rescans": 0}, {"fai_rescans": 0}, {"fai_rescans": 0}), 0),
    (({"fai_rescans": 0}, {"fai_rescans": 3}, {"fai_rescans": 1}), 1),
    (({"fai_rescans": 1}, None, {"fai_rescans": 2}, {}), 1.5),
])
def test_fai_rescans_reads_the_median(counters, want):
    assert harness.load_reader("fai_rescans")(_run(*counters)) == want
