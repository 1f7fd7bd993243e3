"""device_idle_pct: the share of the traced jobs' ``cli.main`` walls in
which no kernel, copy or fill ran on the card (the union of the profiler's
device intervals), %."""


def read(run: dict) -> float | None:
    traced = [j["trace"] for j in run["jobs"] if j.get("trace")]
    if not traced:
        return None
    return 100.0 * (1.0 - sum(t["busy_s"] for t in traced) / sum(t["span_s"] for t in traced))
