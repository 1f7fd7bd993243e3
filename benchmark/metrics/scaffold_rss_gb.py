"""scaffold_rss_gb: the most the ``scaffold`` stage took above its start
(``rss_max_kb - rss_start_kb``), GB, the highest over the traced jobs."""


def read(run: dict) -> float | None:
    got = [(s["rss_max_kb"] - s["rss_start_kb"]) / 1e6
           for j in run["jobs"] for name, s in (j.get("stages") or {}).items()
           if name == "scaffold" and s.get("rss_max_kb") is not None
           and s.get("rss_start_kb") is not None]
    return max(got) if got else None
