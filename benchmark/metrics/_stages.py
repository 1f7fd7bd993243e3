"""What the per-layer readers share: the traced jobs' ``time=True`` stages."""
import statistics


def walls(run: dict, pick) -> float | None:
    """The median over the traced jobs of the summed walls of the stages
    ``pick(name)`` selects, or None where no job has one."""
    sums = []
    for j in run["jobs"]:
        st = j.get("stages") or {}
        got = [s["wall_s"] for name, s in st.items() if pick(name)]
        if got:
            sums.append(sum(got))
    return statistics.median(sums) if sums else None
