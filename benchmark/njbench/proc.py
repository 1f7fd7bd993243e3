"""Child processes of the harness: forked, each with its answer sent back as
JSON beside the forbidden modules it had loaded and the time it finished.

The harness never makes a CUDA context itself, so a forked child may make
its own.  ``os.wait4`` gives a child's ``ru_maxrss`` over its whole life,
its exit included; the harness's own peak at the fork (``self_peak_kb``) is
printed beside it.
"""
from __future__ import annotations

import json
import os
import resource
import signal
import sys
import time
import traceback

FORBIDDEN = ("jax", "jaxlib", "flax", "ntjoin_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted(name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN)


def self_peak_kb() -> int:
    """This process's peak resident set (``ru_maxrss``, kB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def status_kb(pid: int | str, field: str = "VmRSS") -> int | None:
    """A ``kB`` field of ``/proc/<pid>/status``, or None."""
    try:
        with open(f"/proc/{pid}/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return None


class Child:
    """``fn()`` in a forked child whose JSON answer ``wait`` returns, with
    the forbidden modules the child had loaded once ``fn`` returned, the
    time ``fn`` returned, the child's wall from fork to exit and its
    ``ru_maxrss``.  ``log``: the child's stdout and stderr go to this
    file."""

    def __init__(self, fn, log: str | None = None):
        self.read_fd, write_fd = os.pipe()
        self.self_peak_kb = self_peak_kb()
        self.t0 = time.perf_counter()
        self.pid = os.fork()
        if self.pid == 0:  # the child
            code = 0
            try:
                os.close(self.read_fd)
                if log is not None:
                    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
                    os.dup2(fd, 1)
                    os.dup2(fd, 2)
                    os.close(fd)
                answer = fn()
                out = json.dumps({"answer": answer, "t_end": time.perf_counter(),
                                  "forbidden": forbidden_modules()}).encode()
                with os.fdopen(write_fd, "wb") as fh:
                    fh.write(out)
            except BaseException:  # noqa: BLE001 - the child reports and exits
                traceback.print_exc()
                code = 70
            finally:
                try:
                    sys.stdout.flush()
                    sys.stderr.flush()
                finally:
                    os._exit(code)
        os.close(write_fd)
        self.done = None

    def wait(self) -> dict:
        """{"answer", "forbidden", "t_end", "rc", "wall_s", "t_fork",
        "t_exit", "maxrss_kb", "self_peak_kb"}; "answer" is None where the
        child failed.  A second call returns the first's."""
        if self.done is None:
            with os.fdopen(self.read_fd, "rb") as fh:
                data = fh.read()
            _, status, usage = os.wait4(self.pid, 0)
            wall = time.perf_counter() - self.t0
            rc = os.waitstatus_to_exitcode(status)
            sent = json.loads(data) if rc == 0 and data else {"answer": None, "forbidden": []}
            self.done = {"t_end": self.t0 + wall, **sent, "rc": rc, "wall_s": wall,
                         "t_exit": self.t0 + wall, "t_fork": self.t0,
                         "maxrss_kb": usage.ru_maxrss, "self_peak_kb": self.self_peak_kb}
        return self.done

    def stop(self) -> None:
        """End the child where it still runs, and wait for it."""
        if self.done is None:
            try:
                os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.wait()


def run(fn, log: str | None = None, forbidden: set | None = None) -> dict:
    """``fn()`` in a forked child; its JSON answer (raises where it failed).
    The forbidden modules the child had loaded are added to ``forbidden``."""
    got = Child(fn, log).wait()
    if forbidden is not None:
        forbidden.update(got["forbidden"])
    if got["answer"] is None:
        raise RuntimeError(f"child exited {got['rc']}" + (f"; see {log}" if log else ""))
    return got["answer"]
