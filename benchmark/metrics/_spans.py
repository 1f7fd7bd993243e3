"""What the span readers share: each traced job's ``trace_counts`` line,
the port's own spans and counters (``ntjoin_tpu_torch/utils/timers.py``).
A job without it (a port that prints none) gives no number."""
import statistics


def _median(run: dict, value) -> float | None:
    """The median over the traced jobs of ``value(spans, counters)``,
    leaving out the jobs where it is None; None where no job gives one."""
    got = []
    for j in run["jobs"]:
        tc = j.get("trace_counts")
        if tc:
            v = value(tc.get("spans", {}), tc.get("counters", {}))
            if v is not None:
                got.append(v)
    return statistics.median(got) if got else None


def _summed(spans: dict, pick) -> float | None:
    got = [s["s"] for name, s in spans.items() if pick(name)]
    return sum(got) if got else None


def seconds(run: dict, pick) -> float | None:
    """The median over the traced jobs of the summed walls of the spans
    whose full names ``pick`` selects."""
    return _median(run, lambda spans, counters: _summed(spans, pick))


def per_count(run: dict, pick, counter: str, scale: float) -> float | None:
    """The median over the traced jobs of the summed walls of the spans
    ``pick`` selects, times ``scale``, over the job's counter ``counter``."""
    def value(spans, counters):
        s, n = _summed(spans, pick), counters.get(counter)
        return scale * s / n if s is not None and n else None

    return _median(run, value)


def in_sketch(*names: str):
    """Picks the spans of these names directly inside a ``sketch:<fa>``
    stage (``sketch:ref1.fa/pack``)."""
    return lambda full: full.startswith("sketch:") and full.partition("/")[2] in names
