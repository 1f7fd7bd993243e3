"""The port's one counter store (``utils/timers.COUNTERS``): every layer
that counts, the kernels' plain versions, the graph and Mann-Kendall ops,
the mesh and the process exchange, counts into it inside
``timers.recording(True)`` under the names of the ``timers`` docstring and
leaves it empty outside; ``count_max`` keeps the highest value; counts made
on worker threads are all kept."""
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ntjoin_tpu_torch.ops import mannkendall as mk
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops.cc import connected_components
from ntjoin_tpu_torch.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.parallel import mesh
from ntjoin_tpu_torch.utils import timers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_EXCHANGE = """
import json, sys
import torch
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.utils import timers

pd.initialize(f"127.0.0.1:{sys.argv[2]}", 2, int(sys.argv[1]), device="cpu")
try:
    got = []
    for on in (False, True):
        with timers.recording(on):
            pd.all_gather(torch.arange(4))
            got.append(timers.trace_counts()["counters"])
    print(json.dumps(got))
finally:
    torch.distributed.destroy_process_group()
"""


def _off_on(op) -> list[dict]:
    """The counters ``op()`` leaves outside a recording and inside one."""
    got = []
    for on in (False, True):
        with timers.recording(on):
            op()
            got.append(timers.trace_counts()["counters"])
    return got


def _plain_op():
    codes = np.random.default_rng(1).integers(0, 4, size=(64, 8)).astype(np.int8)
    return _off_on(lambda: sc.hash_chunked_ref(torch.from_numpy(codes), 15))


def _graph_op():
    src, dst = np.array([0, 1, 3]), np.array([1, 2, 4])
    return _off_on(lambda: connected_components(6, src, dst, "cpu"))


def _mk_op():
    pos = torch.tensor([[3, 1, 2, 5], [1, 2, 3, 0]])
    return _off_on(lambda: mk.mk_s_batch(pos, torch.tensor([4, 3])))


def _mesh_op():
    codes = np.random.default_rng(2).integers(0, 4, size=20_000).astype(np.uint8)
    return _off_on(lambda: mesh.sketch_records_sharded([codes], 15, 10, ["cpu"] * 2))


def _exchange_op():
    """``all_gather`` of 4 int64 over two gloo processes, each process's
    counters off and on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _EXCHANGE, str(pid), str(port)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert got[0] == got[1]  # the same exchange seen from both processes
    return got[0]


# one case a former module registry: the op, its counter's name and value
CASES = {
    "kernel_plain": (_plain_op, "launch:hash_plain", 1),
    "graph": (_graph_op, "graph:cc@cpu", 1),
    "mann_kendall": (_mk_op, "mk:runs@cpu", 2),
    "mesh": (_mesh_op, "mesh:tiles", 2),
    "exchange": (_exchange_op, "dist:exchange_bytes:all_gather", 4 * 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_layer_counts_only_when_recording(case):
    op, name, want = CASES[case]
    off, on = op()
    assert off == {}
    assert on[name] == want, on
    assert all(":" in n for n in on), on


def test_count_max_keeps_the_highest():
    with timers.recording(True):
        for v in (5, 9, 3):
            timers.count_max("sketch:codes_held_max", v)
        assert timers.COUNTERS == {"sketch:codes_held_max": 9}
    with timers.recording(True):
        assert timers.COUNTERS == {}
        timers.count_max("sketch:codes_held_max", 2)
        assert timers.COUNTERS == {"sketch:codes_held_max": 2}
    with timers.recording(False):
        timers.count_max("sketch:codes_held_max", 7)
        assert timers.COUNTERS == {}


def test_mesh_worker_threads_count():
    """Two distinct devices sketch in a thread each: their launches of the
    plain versions are kept with the main thread's counts, and the sketch's
    spans opened off the main thread are not recorded."""
    rng = np.random.default_rng(3)
    recs = [rng.integers(0, 4, size=20_000).astype(np.uint8) for _ in range(3)]
    with timers.recording(True):
        got = mesh.sketch_records_sharded(recs, 15, 10, ["cpu", "cpu:1"])
        tc = timers.trace_counts()
    for g, c in zip(got, recs):
        assert g.positions.tolist() == sketch_codes(c, 15, 10).positions.tolist()
    counts = tc["counters"]
    assert counts["mesh:device_calls"] == 2 and counts["mesh:tiles"] == 2 * len(recs)
    for op in ("hash", "flags", "window_emit"):
        assert counts[f"launch:{op}_plain"] == counts["mesh:device_calls"], op
    assert tc["spans"] == {}


def test_counts_from_many_threads_lose_no_update():
    """16 threads, more than this machine's cores, each adding 2,000 times
    and raising a maximum, under a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for _ in range(2000):
            timers.count("mesh:tiles")
        timers.count_max("sketch:codes_held_max", i)

    try:
        with timers.recording(True):
            threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            counts = timers.trace_counts()["counters"]
    finally:
        sys.setswitchinterval(old)
    assert counts == {"mesh:tiles": 16 * 2000, "sketch:codes_held_max": 15}
