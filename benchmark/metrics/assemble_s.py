"""assemble_s: seconds a job, from the first job's fork to the last job's
exit over the jobs the window completed (host clock)."""


def read(run: dict) -> float | None:
    return run["window_s"] / len(run["jobs"])
