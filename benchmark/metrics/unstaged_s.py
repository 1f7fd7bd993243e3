"""unstaged_s: the job's ``cli.main`` wall less its ``time=True`` stage
walls (the ``.fai`` writes, ``write_all_scaffolds``), median over the traced
jobs.  In a traced job the profiler's start makes the CUDA context before
``cli.main`` is called, so neither this nor a stage holds it."""
import statistics


def read(run: dict) -> float | None:
    got = [j["main_s"] - sum(s["wall_s"] for s in j["stages"].values())
           for j in run["jobs"] if j.get("stages") and j.get("main_s") is not None]
    return statistics.median(got) if got else None
