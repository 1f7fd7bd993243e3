"""peak_rss_gb: the highest peak resident set of a job process in the
window, GB: each job's own high-water mark (``getrusage(RUSAGE_SELF)`` in
the job) from its fork to the return of its call of ``cli.main``.  Not the
exit status's ``ru_maxrss``: on a CUDA machine the harness's queries of the
card after the call raise it (both are printed, as ``job_peak_rss_gb`` and
``job_exit_maxrss_gb``)."""


def read(run: dict) -> float | None:
    got = [j["peak_rss_kb"] for j in run["jobs"] if j.get("peak_rss_kb")]
    return max(got) / 1e6 if got else None
