"""Structured stage timing — the framework's tracing/observability hook.

Successor of the reference's per-Make-target GNU ``time -v`` logging
(``ntJoin:98-107``): wall-clock and peak-RSS per named stage, an in-process
summary, and optional per-stage ``<prefix>.<stage>.time`` files, which also
hold the resident set (``VmRSS``) at the stage's start and at its end
(``rss_start_kb``, ``rss_end_kb``) and the highest one read while it was
open (``rss_max_kb``, every ``SAMPLE_S`` seconds): the peak says how high
the process has been so far, the two ends what the stage left behind, and
``rss_max_kb - rss_start_kb`` what the stage itself took at most.

Inside ``recording(True)`` (the CLI's ``time=True``) the stages and the
spans that the port opens inside them (``span``) are kept in memory on
``time.perf_counter_ns``, with the counters the port adds (``count``);
``trace_counts`` gives both to the CLI's ``trace_counts`` line.  A span's
full name is its parent's, ``/`` and its own (``sketch:ref1.fa/pack``,
``scaffold/emit/trim``); one opened outside any stage keeps its own name.
While a ``torch.profiler`` records, every stage and span open is marked in
its trace as ``stage:<full name>`` (``OPEN``), on the clock of the device
events.

``COUNTERS`` is the port's only count store.  A counter is named
``<layer>:<name>``, with ``@<device type>`` last where the op runs on the
device it is given:

* ``launch:<kernel>``: CUDA kernel launches (``hash``, ``flags`` three a
  call, ``window_emit``, ``window_emit_gmem``, ``window``, ``copy``,
  ``stream`` four a batch, ``mk_s`` one or two a batch), and
  ``launch:<op>_plain`` the calls of an op's plain version;
* ``sketch_route:<route>``: records and batches of ``sketch_records_torch``
  by route (``host_records``, ``general_records``, ``general_batches``) and
  calls that took the exact window path (``exact_runs``);
  ``sketch:codes_held_max`` (``count_max``) the most code bytes one call
  held at once;
* ``graph:<op>@<device type>``: runs of a graph op (``shared_filter``,
  ``edge_tally``, ``cc``, ``escalate``, ``rank``), ``graph:cc_rounds`` the
  hooking rounds of connected components, one sync each;
* ``mk:batches@<device type>``, ``mk:runs@<device type>``: the
  Mann-Kendall op's batches and the runs they held;
* ``mesh:sharded_records``, ``mesh:tiles``, ``mesh:device_calls``: records
  split over a mesh, their tiles, and ``sketch_records_torch`` calls;
* ``dist:exchanges:<collective>`` and ``dist:exchange_bytes:<collective>``:
  a process's collectives and the bytes it sent to other processes,
  ``dist:verdict_us`` the verdict's device time on a card,
  ``dist:shards@<device type>`` the shards of every process, and
  ``dist:records``, ``dist:entries``, ``dist:survivors`` what the process
  sketched and kept.

The counters that the benchmark's metrics read keep names without a
prefix: ``fai_rescans``, ``minimizers``, ``graph_edges``,
``path_minimizers``, ``trim_sketch_bases`` and ``tsv_fallback_records``.
"""
from __future__ import annotations

import contextlib
import resource
import sys
import threading
import time

# Seconds between two reads of the resident set while a stage is open
# (``RssMax``; ``perf_scale``'s sampler reads at the same period).
SAMPLE_S = 0.05


def status_kb(field: str) -> int | None:
    """A ``kB`` field of ``/proc/self/status`` (``VmRSS``, ``VmHWM``), or
    None where the system has no such line."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def peak_rss_kb() -> int:
    """This process's peak resident set in kB: ``VmHWM`` where the system
    gives it, else ``ru_maxrss``.  On Linux ``ru_maxrss`` keeps the
    high-water mark across ``execve``, so in a process spawned by a larger
    one it reads at least that process's peak at the spawn.  Where both
    exist the lower one is taken: the kernel may read them from its
    per-CPU page counters at different precision, and the two then differ
    by a few hundred kB either way."""
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    hwm = status_kb("VmHWM")
    return maxrss if hwm is None else min(hwm, maxrss)


class Open(list):
    """The full names of the stages and spans open now, innermost last.  A
    name pushed while a ``torch.profiler`` records opens a
    ``record_function("stage:<name>")`` that its pop closes (this module
    leaves ``import torch`` to its callers: a process without torch has no
    profiler)."""

    def __init__(self):
        super().__init__()
        self._marks: list = []

    def append(self, name: str) -> None:
        super().append(name)
        mark = None
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            mark = torch.profiler.record_function("stage:" + name)
            mark.__enter__()
        self._marks.append(mark)

    def pop(self) -> str:
        mark = self._marks.pop()
        if mark is not None:
            mark.__exit__(None, None, None)
        return super().pop()


OPEN: list[str] = Open()
# The ``StageTimers`` stages open now, innermost last: a sampler in another
# thread reads ``STAGE[-1]`` to tell which stage a sample falls in.
STAGE: list[str] = []

# Spans and counters: on only inside ``recording(True)``.  ``SPANS`` holds
# each closed stage or span as (full name, parent's full name or None,
# start ns, end ns, ns its child spans cover); ``_CHILD_NS`` the ns covered
# so far by the children of each recorded one open now.
ON = False
SPANS: list[tuple[str, str | None, int, int, int]] = []
COUNTERS: dict[str, int] = {}
_CHILD_NS: list[int] = []
_COUNT_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording(on: bool):
    """Spans and counters on (``on``) or off inside the block, from none;
    the setting before is restored after it, and what the block recorded
    stays readable until the next block starts."""
    global ON
    was = ON
    SPANS.clear()
    COUNTERS.clear()
    _CHILD_NS.clear()
    ON = on
    try:
        yield
    finally:
        ON = was


def _recorded() -> bool:
    """Whether a span opened now is kept: spans on, and the main thread
    (the mesh's per-device threads open none)."""
    return ON and threading.current_thread() is threading.main_thread()


def _open(name: str) -> None:
    """Push a recorded stage or span."""
    OPEN.append(name)
    _CHILD_NS.append(0)


def _close(name: str, parent: str | None, t0: int, t1: int) -> None:
    OPEN.pop()
    kids = _CHILD_NS.pop()
    if _CHILD_NS:
        _CHILD_NS[-1] += t1 - t0
    SPANS.append((name, parent, t0, t1, kids))


class Span:
    """An interval on ``time.perf_counter_ns`` (``t0``, ``t1``; ``s`` its
    seconds).  A recorded one is pushed on ``OPEN`` under its full name
    while open and kept in ``SPANS`` when it closes.  A ``stage`` keeps its
    own name, and is pushed on ``OPEN`` and ``STAGE`` recorded or not."""

    __slots__ = ("name", "parent", "record", "stage", "t0", "t1")

    def __init__(self, name: str, record: bool, stage: bool = False):
        self.name, self.parent, self.record, self.stage = name, None, record, stage

    def __enter__(self) -> Span:
        if self.record:
            self.parent = OPEN[-1] if OPEN else None
            if self.parent is not None and not self.stage:
                self.name = f"{self.parent}/{self.name}"
            _open(self.name)
        elif self.stage:
            OPEN.append(self.name)
        if self.stage:
            STAGE.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.stage:
            STAGE.pop()
        if self.record:
            _close(self.name, self.parent, self.t0, self.t1)
        elif self.stage:
            OPEN.pop()

    @property
    def s(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span(name: str):
    """A span of the work in its block, named ``name`` under the stage or
    span open around it.  Off (outside ``recording(True)`` or off the main
    thread) it is a shared empty context: no clock read, no push."""
    if not ON or threading.current_thread() is not threading.main_thread():
        return _OFF
    return Span(name, True)


def timed(name: str) -> Span:
    """A span that reads the clock even where spans are off, for a caller
    that keeps its own total of ``s``; recorded as ``span`` would be."""
    return Span(name, _recorded())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (from any thread); off, nothing."""
    if ON:
        with _COUNT_LOCK:
            COUNTERS[name] = COUNTERS.get(name, 0) + int(n)


def count_max(name: str, value: int) -> None:
    """Raise counter ``name`` to ``value`` where it is lower (from any
    thread); off, nothing."""
    if ON:
        with _COUNT_LOCK:
            COUNTERS[name] = max(COUNTERS.get(name, 0), int(value))


def trace_counts() -> dict:
    """The recorded stages and spans by full name (``n`` of them, ``s``
    their summed wall, ``self_s`` that less the part their child spans
    cover, ``parent``) and the counters: the CLI's ``trace_counts`` line."""
    spans: dict[str, dict] = {}
    for name, parent, t0, t1, kids in SPANS:
        got = spans.setdefault(name, {"n": 0, "s": 0.0, "self_s": 0.0, "parent": parent})
        got["n"] += 1
        got["s"] += (t1 - t0) / 1e9
        got["self_s"] += (t1 - t0 - kids) / 1e9
    return {"spans": spans, "counters": dict(COUNTERS)}


class RssMax:
    """A thread that reads ``VmRSS`` every ``SAMPLE_S`` seconds from its
    start until ``stop``: the highest of its reads and of the first and
    last reads given, in kB (None where the system has no ``VmRSS``)."""

    def __init__(self, first_kb: int | None):
        self.kb = first_kb
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _take(self, kb: int | None) -> None:
        if kb is not None and kb > (self.kb or 0):
            self.kb = kb

    def _run(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            self._take(status_kb("VmRSS"))

    def stop(self, last_kb: int | None) -> int | None:
        self._stop.set()
        self._thread.join()
        self._take(last_kb)
        return self.kb


class StageTimers:
    def __init__(self, enabled: bool = False, prefix: str = "out"):
        self.enabled = enabled
        self.prefix = prefix
        self.stages: list[tuple[str, float, int]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        """The block as stage ``name``: pushed on ``OPEN`` while open; where
        enabled, timed with its resident set into a ``.time`` file and
        kept for ``report``, and recorded as a span where spans are on."""
        if not self.enabled:  # nothing reads a disabled stage's wall or RSS
            with Span(name, False, stage=True):
                yield
            return
        rss_start = status_kb("VmRSS")
        rss_max = RssMax(rss_start)
        sp = Span(name, _recorded(), stage=True)
        try:
            with sp:
                yield
        finally:
            wall = sp.s
            rss_kb = peak_rss_kb()
            self.stages.append((name, wall, rss_kb))
            rss_end = status_kb("VmRSS")
            most = rss_max.stop(rss_end)
            safe = name.replace("/", "_").replace(":", ".")
            with open(f"{self.prefix}.{safe}.time", "w", encoding="utf-8") as fh:
                fh.write(f"stage\t{name}\nwall_s\t{wall:.4f}\npeak_rss_kb\t{rss_kb}\n"
                         f"rss_start_kb\t{rss_start}\nrss_end_kb\t{rss_end}\n"
                         f"rss_max_kb\t{most}\n")

    def report(self) -> None:
        if not self.enabled or not self.stages:
            return
        print("stage\twall_s\tpeak_rss_kb")
        for name, wall, rss in self.stages:
            print(f"{name}\t{wall:.4f}\t{rss}")
