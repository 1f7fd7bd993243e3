"""sketch_roofline: the least time the sketch could take on the card
over the time its kernels took, %.

The least time is the work's least bytes over the H100's published memory
bandwidth (3.35 TB/s, SXM, at its 700 W limit; the run prints the card's
limit beside it): each base's code read once (1 byte) and each emitted
minimizer's position and hash written once (16 bytes), over every
assembly.  The kernels' time is that of the kernels launched while a
``sketch:`` stage was open, summed over the traced jobs.  It counts the
work, not a design's own traffic, so it stays valid when kernels are fused
or removed."""

PEAK_BYTES_PER_S = 3.35e12
BYTES_PER_BASE = 1
BYTES_PER_MINIMIZER = 16


def least_bytes(run: dict) -> int:
    bases = sum(f["bases"] for f in run["inputs"]["files"].values())
    return BYTES_PER_BASE * bases + BYTES_PER_MINIMIZER * sum(run["minimizers"].values())


def read(run: dict) -> float | None:
    traced = [j["trace"] for j in run["jobs"] if j.get("trace")]
    spent = sum(sec for t in traced for stage, cats in t["ops_by_stage"].items()
                if stage.startswith("sketch:") for cat, sec in cats.items() if cat == "kernel")
    if not spent:
        return None
    return 100.0 * len(traced) * least_bytes(run) / PEAK_BYTES_PER_S / spent
