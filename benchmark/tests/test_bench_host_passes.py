"""The readers of the port's counters ``trim_sketch_bases`` (the bases the
overlap trim sketched) and ``tsv_fallback_records`` (the TSV records the
Python formatter wrote): None for jobs without them (a port that counts
nothing), the median over the jobs that carry them."""
import pytest

from njbench import harness


def _run(*counters):
    """A run whose jobs carry these counters (None: a job without a
    ``trace_counts`` line)."""
    return {"jobs": [{"trace_counts": None if c is None else {"spans": {}, "counters": c}}
                     for c in counters]}


@pytest.mark.parametrize("name", ["trim_sketch_bases", "tsv_fallback_records"])
@pytest.mark.parametrize("values,want", [
    ((None, None), None),
    ((), None),
    ((0, 0, 0), 0),
    ((90_210, 88_000, 91_500), 90_210),
    ((7, None, 3, "absent"), 5),
])
def test_counter_reads_the_median(name, values, want):
    counters = [None if v is None else {"minimizers": 5} if v == "absent" else {name: v}
                for v in values]
    assert harness.load_reader(name)(_run(*counters)) == want
