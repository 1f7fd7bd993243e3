"""The port's multi-process half (``ntjoin_tpu_torch/parallel/distributed.py``
and ``pipeline.py``) on the CPU: the hash-bucket verdict bit-equal to the
JAX package's ``distributed_survive_sharded`` in one process and in two gloo
processes, int64 survivors through the exchange, and a two-process
``assemble`` byte-equal to the one-process runs of both packages."""
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from test_torch_cli import _PORT, _many_contigs, _more_sequences

from ntjoin_tpu.parallel import distributed as jax_dist
from ntjoin_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.parallel.pipeline import DistributedConfig, distributed_assemble
from ntjoin_tpu_torch.utils import timers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ASM = 3
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rows(n_dev=8, width=512):
    """The (8, 512) rows of ``tests/test_distributed.py``: hashes with
    duplicates within and across 3 assemblies, 10% dead."""
    rng = np.random.default_rng(3)
    n_el = n_dev * width
    lo = rng.integers(0, 700, n_el).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n_el, dtype=np.uint64).astype(np.uint32)
    hi = (hi % np.uint32(5)) + lo
    asm = rng.integers(0, N_ASM, n_el).astype(np.int32)
    alive = rng.random(n_el) < 0.9
    h = (lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))).view(np.int64)
    return lo, hi, asm, alive, h


def _jax_verdicts(n_dev):
    lo, hi, asm, alive, _ = _rows()
    mesh = jax_make_mesh(n_dev)
    width = lo.shape[0] // n_dev
    sharding = NamedSharding(mesh, P("shard", None))
    arrs = [jax.device_put(x.reshape(n_dev, width), sharding) for x in (lo, hi, asm, alive)]
    bw = jax_dist.bucket_width_for_rows(hi.reshape(n_dev, width), alive.reshape(n_dev, width),
                                        n_dev)
    sharded = np.asarray(jax_dist.distributed_survive_sharded(
        mesh, *arrs, n_asm=N_ASM, bucket_width=bw)).reshape(-1)
    return sharded, np.asarray(jax_dist.distributed_survive(mesh, *arrs, n_asm=N_ASM)), bw


@pytest.mark.parametrize("n_shards", [8, 4])
def test_sharded_verdict_matches_jax_in_one_process(n_shards):
    """One process holding every shard: the exchange is a transpose, no
    collective runs, and the verdict is bit-equal to the JAX package's
    sharded and replicated ones at the same shard count."""
    _, _, asm, alive, h = _rows()
    width = h.shape[0] // n_shards
    rows = [torch.from_numpy(x.reshape(n_shards, width)) for x in (h, asm, alive)]
    bw = pd.bucket_width_for_rows(rows[0].numpy(), rows[2].numpy(), n_shards)
    with timers.recording(True):
        got = pd.distributed_survive_sharded(*rows, N_ASM, bw).reshape(-1).numpy()
        counts = timers.trace_counts()["counters"]
    want, replicated, jax_bw = _jax_verdicts(n_shards)
    assert bw == jax_bw
    assert got.tolist() == want.tolist() == replicated.tolist()
    assert pd.distributed_survive(*rows, N_ASM).numpy().tolist() == replicated.tolist()
    assert got.sum() > 100 and not [n for n in counts if n.startswith("dist:")]  # no collective
    assert n_shards * bw < 2 * h.shape[0] // n_shards + 64  # O(total / shards) a shard


_WORKER = """
import sys
import numpy as np
import torch
from ntjoin_tpu_torch.parallel import distributed as pd
from ntjoin_tpu_torch.utils import timers

pid, port, rows_file, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
shards = pd.initialize(f"127.0.0.1:{port}", 2, pid, local_device_count=4, device="cpu")
try:
    data = np.load(rows_file)
    mine = slice(4 * pid, 4 * pid + 4)
    h, asm, alive = (torch.from_numpy(data[x][mine]) for x in ("h", "asm", "alive"))
    local_bw = pd.bucket_width_for_rows(h.numpy(), alive.numpy(), 8)
    bw = int(pd.all_gather(torch.tensor([local_bw])).max())
    with timers.recording(True):
        sharded = pd.distributed_survive_sharded(h, asm, alive, 3, bw)
        a2a = timers.trace_counts()["counters"].get("dist:exchanges:all_to_all", 0)
    replicated = pd.distributed_survive(h, asm, alive, 3)
    m = 5 + 3 * pid  # survivors of unequal counts, positions from 2^31 up
    pos = (1 << 31) + np.arange(m, dtype=np.int64) * (1 << 33) + pid
    cols = np.stack([np.full(m, -7 - pid, dtype=np.int64), pos])
    gathered = pd.gather_ragged(torch.from_numpy(cols))
    np.savez(out, sharded=sharded.numpy(), replicated=replicated.numpy(),
             gathered=gathered.numpy(), shards=len(shards), a2a=a2a)
finally:
    torch.distributed.destroy_process_group()
"""


def _run_processes(argvs, cwd, env=None):
    """Start every argv at once, each with its own timeout; all must exit 0."""
    procs = [subprocess.Popen(a, cwd=cwd, env=env or dict(os.environ, PYTHONPATH=REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Two gloo processes of 4 CPU shards each over the (8, 512) rows."""
    d = tmp_path_factory.mktemp("gloo")
    _, _, asm, alive, h = _rows()
    np.savez(d / "rows.npz", h=h.reshape(8, 512), asm=asm.reshape(8, 512),
             alive=alive.reshape(8, 512))
    (d / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    _run_processes([[sys.executable, str(d / "worker.py"), str(pid), port, str(d / "rows.npz"),
                     str(d / f"out{pid}.npz")] for pid in range(2)], d)
    return [np.load(d / f"out{pid}.npz") for pid in range(2)]


def test_two_process_verdict_matches_jax(two_processes):
    want, replicated, _ = _jax_verdicts(8)
    got = np.concatenate([out["sharded"] for out in two_processes]).reshape(-1)
    assert got.tolist() == want.tolist()
    for out in two_processes:
        assert out["replicated"].tolist() == replicated.tolist()
        assert int(out["shards"]) == 4 and int(out["a2a"]) == 2  # there and back


def test_two_process_survivors_keep_int64_positions(two_processes):
    """Positions of 2^31 and more travel through the survivor exchange
    unchanged (the JAX pipeline refuses them)."""
    for out in two_processes:
        g = out["gathered"]
        assert g.dtype == np.int64 and g.shape == (2, 5 + 8)
        for pid, cols in ((0, g[:, :5]), (1, g[:, 5:])):
            m = 5 + 3 * pid
            assert cols[0].tolist() == [-7 - pid] * m
            assert cols[1].tolist() == [(1 << 31) + i * (1 << 33) + pid for i in range(m)]
        assert g[1].max() > 1 << 35


_ARGS = ["target=target.fa", "references=ref.fa", "reference_weights=2", "k=32", "w=250", "n=2",
         "overlap=True", "agp=True", "prefix=d"]


@pytest.mark.parametrize("fixture", [_many_contigs, _more_sequences])
def test_two_process_assemble_matches_one_process(tmp_path, fixture):
    """``assemble backend=torch n_procs=2 local_devices=2``: .path, .agp,
    .mx.dot, the unassigned bed and the scaffold trio byte-equal to the
    port's one-process run and to ``ntjoin_tpu.cli backend=numpy``."""
    dirs = {name: tmp_path / name for name in ("dist", "port", "jax")}
    for d in dirs.values():
        d.mkdir()
        fixture(d)
    port = _free_port()
    outs = _run_processes(
        [[sys.executable, "-c", _PORT, "assemble", *_ARGS, "backend=torch", "n_procs=2",
          "local_devices=2", f"coordinator=127.0.0.1:{port}", f"process_id={pid}", "time=True"]
         for pid in range(2)], dirs["dist"])
    _run_processes([[sys.executable, "-c", _PORT, "assemble", "-B", *_ARGS, "backend=torch"]],
                   dirs["port"])
    _run_processes([[sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B", *_ARGS,
                     "backend=numpy", "index_backend=host"]], dirs["jax"])
    made = sorted(p.name for p in dirs["dist"].iterdir() if p.name not in ("ref.fa", "target.fa"))
    assert {"d.path", "d.agp", "d.mx.dot", "target.fa.k32.w250.n2.all.scaffolds.fa",
            "target.fa.k32.w250.n2.assigned.scaffolds.fa"} <= set(made)
    for name in made:
        want = (dirs["jax"] / name).read_bytes()
        assert (dirs["dist"] / name).read_bytes() == want, name
        assert (dirs["port"] / name).read_bytes() == want, name
    records = 0
    for out in outs:
        assert not [ln for ln in out.splitlines() if ln.startswith("dist_counts\t")]
        line = next(ln for ln in out.splitlines() if ln.startswith("trace_counts\t"))
        counts = json.loads(line.split("\t", 1)[1])["counters"]
        assert counts["dist:shards@cpu"] == 4  # local_devices=2 on each of 2 processes
        assert counts["dist:exchanges:all_to_all"] == 2
        assert counts["dist:exchange_bytes:all_to_all"] > 0 and counts["launch:hash_plain"] > 0
        records += counts["dist:records"]
    assert records == sum(open(dirs["port"] / fa).read().count(">")
                          for fa in ("ref.fa", "target.fa"))


def test_source_fed_pipeline_matches_codes_fed(tmp_path, monkeypatch):
    """One process of the pipeline on two CPU shards: each process's
    records fed to ``sketch_records_torch`` as a ``Subset`` of the
    assembly's ``FastaSource`` (the default) give the artifacts, byte for
    byte, and the entries and survivors of the same records fed as a list
    of their codes."""
    from ntjoin_tpu_torch.ops.sketch_records import sketch_records_torch

    def codes_fed(src, k, w):
        return sketch_records_torch([src.codes(i) for i in range(len(src))], k, w, "cpu")

    counts = {}
    for name, sketch in (("source", None), ("codes", codes_fed)):
        d = tmp_path / name
        d.mkdir()
        _more_sequences(d)
        monkeypatch.chdir(d)
        cfg = DistributedConfig(target="target.fa", references=["ref.fa"],
                                reference_weights=[2.0], prefix="d", k=32, w=250, n=2,
                                local_device_count=2, device="cpu",
                                scaffold_opts={"agp": True, "index_backend": "host"})
        with timers.recording(True):
            distributed_assemble(cfg, sketch)
            counts[name] = timers.trace_counts()["counters"]
    made = sorted(p.name for p in (tmp_path / "codes").iterdir())
    assert "d.path" in made and "target.fa.k32.w250.n2.all.scaffolds.fa" in made
    assert sorted(p.name for p in (tmp_path / "source").iterdir()) == made
    for name in made:
        assert (tmp_path / "source" / name).read_bytes() == \
            (tmp_path / "codes" / name).read_bytes(), name
    for key in ("dist:records", "dist:entries", "dist:survivors"):
        assert counts["source"][key] == counts["codes"][key] > 0, key
    assert counts["source"]["dist:shards@cpu"] == counts["codes"]["dist:shards@cpu"] == 2


def test_pipeline_refuses_processes_without_a_coordinator():
    cfg = DistributedConfig(target="t.fa", references=["r.fa"], reference_weights=[2.0],
                            prefix="p", num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        distributed_assemble(cfg)
