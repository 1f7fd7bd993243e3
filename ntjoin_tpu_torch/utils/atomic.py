"""Crash-safe artifact writes (tmp + rename).

Reference parity: Make's ``.DELETE_ON_ERROR`` (reference ``ntJoin:201``)
deletes half-written targets when a rule dies, so a crashed run never
leaves a fresh-mtimed partial artifact for the next run's timestamp-reuse
check to trust.  The framework's equivalent: every artifact writer goes
through a ``<path>.tmp.<pid>`` temp file that is ``os.replace``d into
place only on clean completion; on any error the temp file is unlinked
and the destination (old artifact or absence) is untouched.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w", encoding: str | None = "utf-8"):
    """Open ``<path>.tmp.<pid>`` for writing; rename over ``path`` on
    clean exit, unlink on error."""
    tmp = f"{path}.tmp.{os.getpid()}"
    if "b" in mode:
        encoding = None
    fh = open(tmp, mode, encoding=encoding)
    try:
        yield fh
    except BaseException:
        fh.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    else:
        fh.close()
        os.replace(tmp, path)


@contextlib.contextmanager
def atomic_path(path: str):
    """Filename-taking variant for writers that open the file themselves
    (the native C++ emitters): yields the temp name to write to, then
    renames it over ``path`` on clean exit, unlinks on error."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        yield tmp
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    else:
        os.replace(tmp, path)
