"""setup_s: the run's set-up, from the harness's start (before ``import
torch``) to the window's: the port's import, the libraries' build or load
and the cards' look in a child, the inputs written from the seed."""


def read(run: dict) -> float | None:
    return run["setup_s"]
