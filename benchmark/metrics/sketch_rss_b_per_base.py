"""sketch_rss_b_per_base: the most a ``sketch:<fa>`` stage took above its
start (``rss_max_kb - rss_start_kb``) over that assembly's bases, the
highest over the traced jobs' assemblies but the first, bytes a base.

The first assembly's stage also loads the kernels and sets up the job's
device state (1.5-1.8 GB above its start on the H100 machine), which would
hide what the sketch holds; the later stages start with both in place."""


def read(run: dict) -> float | None:
    bases = {name: f["bases"] for name, f in run["inputs"]["files"].items()}
    first = run["inputs"]["references"][0]
    got = []
    for j in run["jobs"]:
        for name, s in (j.get("stages") or {}).items():
            fa = name[len("sketch:"):]
            if name.startswith("sketch:") and fa in bases and fa != first \
                    and s.get("rss_max_kb") is not None and s.get("rss_start_kb") is not None:
                got.append((s["rss_max_kb"] - s["rss_start_kb"]) * 1000 / bases[fa])
    return max(got) if got else None
