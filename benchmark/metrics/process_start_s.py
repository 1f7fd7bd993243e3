"""process_start_s: a fresh interpreter's ``import ntjoin_tpu_torch.cli``
and first CUDA context, host clock around the whole child (the traced run,
after the window)."""


def read(run: dict) -> float | None:
    got = run.get("process_start")
    return got["wall_s"] if got and "wall_s" in got else None
