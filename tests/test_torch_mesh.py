"""The port's sequence-parallel sketch (``ntjoin_tpu_torch/parallel/mesh.py``)
over meshes of CPU shards (the kernels' plain versions) against the JAX
package's ``sketch_records_sharded`` on the virtual 8-device CPU mesh and
the NumPy oracle; ``distributed_unique_count`` against JAX's.  Integer
outputs: bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.ops.nthash_np import sketch_codes
from ntjoin_tpu.parallel import mesh as jax_mesh
from ntjoin_tpu_torch.parallel import mesh


def _random(rng):
    return [rng.integers(0, 4, size=60_000).astype(np.uint8)], 32, 100


def _n_runs(rng):
    # interior N runs much longer than the (w + k - 2) halo
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    for start in rng.integers(0, 55_000, size=6):
        codes[start : start + int(rng.integers(200, 2_000))] = 4
    return [codes], 15, 10


def _mostly_n(rng):
    codes = np.full(50_000, 4, dtype=np.uint8)
    codes[1000:1200] = rng.integers(0, 4, size=200)
    codes[30_000:30_100] = rng.integers(0, 4, size=100)
    return [codes], 15, 10


def _repeat_seams(rng):
    # a periodic sequence: equal hashes everywhere, ties to the leftmost
    return [np.tile(np.array([0, 1, 2, 3], dtype=np.uint8), 10_000)], 8, 32


def _all_n(rng):
    return [np.full(200_000, 4, dtype=np.uint8)], 32, 1000


def _fewer_than_w(rng):
    # valid k-mers in stretches shorter than w between long N runs, and a
    # record of w - 1 valid k-mers in all
    a = np.full(40_000, 4, dtype=np.uint8)
    for s in range(500, 39_000, 3000):
        a[s : s + 60] = rng.integers(0, 4, size=60)
    b = np.full(30_000, 4, dtype=np.uint8)
    b[10_000 : 10_000 + 100 + 32 - 2] = rng.integers(0, 4, size=130)
    return [a, b], 32, 100


def _too_small(rng):
    # records no longer than 4 * (halo + shards): sketched whole on shard 0
    return [rng.integers(0, 4, size=n).astype(np.uint8) for n in (9, 40, 300, 1_200)], 15, 100


def _mixed(rng):
    # many records, some with N runs, one in-flight group a few records long
    recs = []
    for i in range(7):
        c = rng.integers(0, 4, size=int(rng.integers(2_000, 20_000))).astype(np.uint8)
        if i % 2:
            c[c.shape[0] // 3 : c.shape[0] // 3 + 700] = 4
        recs.append(c)
    return recs, 21, 50


CASES = [_random, _n_runs, _mostly_n, _repeat_seams, _all_n, _fewer_than_w, _too_small, _mixed]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.positions.tolist() == r.positions.tolist()
        assert g.hashes.tolist() == r.hashes.tolist()
        assert g.positions.dtype == np.int64 and g.hashes.dtype == np.uint64


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CASES, ids=[c.__name__.strip("_") for c in CASES])
def test_sharded_matches_jax_and_oracle(case, n_shards):
    recs, k, w = case(np.random.default_rng(CASES.index(case)))
    mesh.reset_counts()
    got = mesh.sketch_records_sharded(recs, k, w, ["cpu"] * n_shards, max_inflight_bases=40_000)
    _assert_same(got, [sketch_codes(c, k, w) for c in recs])
    _assert_same(got, jax_mesh.sketch_records_sharded(recs, k, w, jax_mesh.make_mesh(n_shards)))
    if n_shards > 1 and case in (_random, _n_runs, _repeat_seams):
        assert mesh.COUNTS["tiles"] == n_shards and mesh.COUNTS["device_calls"] == 1


def _seam_run(codes, n_shards, k, w, length):
    """Paint an N run of ``length`` bases inside the overlap of tiles 0 and
    1 (retiling until it stays there); returns the run's start."""
    runs = mesh._valid_kmer_runs(codes, k)
    n_valid = int(runs[1].sum())
    removed = length + k - 1
    for _ in range(5):
        tw = -(-(n_valid - removed - w + 1) // n_shards)
        # right after the k-mer of rank tw + w // 2, inside the overlap
        start = int(mesh._kmer_at(runs, np.array([tw + w // 2]))[0]) + k
        trial = codes.copy()
        trial[start : start + length] = 4
        lo, hi, _ = mesh._tile_record(trial, n_shards, k, w)
        if lo[1] < start and start + length < hi[0]:
            codes[:] = trial
            return start
        removed = n_valid - int(mesh._valid_kmer_runs(trial, k)[1].sum())
    raise AssertionError("no seam holds the N run")


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_n_run_longer_than_the_halo_across_a_seam(n_shards):
    """The seam's lead window and the windows after it slide across an N run
    of 3,000 bases (halo 1,030 at k=32, w=1000) inside both tiles."""
    k, w = 32, 1000
    rng = np.random.default_rng(77 + n_shards)
    codes = rng.integers(0, 4, size=80_000).astype(np.uint8)
    _seam_run(codes, n_shards, k, w, 3000)
    got = mesh.sketch_sharded(codes, k, w, ["cpu"] * n_shards)
    _assert_same([got], [sketch_codes(codes, k, w)])
    _assert_same([got], [jax_mesh.sketch_sharded(codes, k, w, jax_mesh.make_mesh(n_shards))])


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.strip("_") for c in CASES])
def test_valid_kmer_runs_are_the_jax_stream(case):
    """The stream as runs of starts gives every rank the position of the JAX
    package's ``_valid_kmer_starts``, k from 1 to 32."""
    for c in case(np.random.default_rng(5))[0]:
        for k in (1, 8, 32):
            want = jax_mesh._valid_kmer_starts(c, k)
            runs = mesh._valid_kmer_runs(c, k)
            assert int(runs[1].sum()) == want.size
            assert mesh._kmer_at(runs, np.arange(want.size)).tolist() == want.tolist()


def test_tiles_are_the_jax_tiles():
    """Tile bounds and owned windows are the JAX package's arithmetic, less
    its power-of-two padding."""
    codes, k, w = _n_runs(np.random.default_rng(1))[0][0], 15, 10
    for n_shards in (2, 3, 8):
        lo, hi, own = mesh._tile_record(codes, n_shards, k, w)
        tiles, lens, offsets, j_own = jax_mesh._tile_record(codes, n_shards, k, w)
        assert own.tolist() == j_own.tolist()
        assert lo.tolist() == offsets.tolist() and (hi - lo).tolist() == lens.tolist()
        for d in range(n_shards):
            assert tiles[d, : lens[d]].tolist() == codes[lo[d] : hi[d]].tolist()


def test_distributed_unique_count_matches_jax():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 200, size=(8, 64)).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    uniq, total = mesh.distributed_unique_count(
        ["cpu"] * 8, torch.from_numpy(vals.view(np.int64)), torch.full((8,), 64))
    j_uniq, j_total = jax_mesh.distributed_unique_count(
        jax_mesh.make_mesh(8),
        jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)),
        jnp.full(8, 64, jnp.int32))
    assert uniq.tolist() == np.asarray(j_uniq).tolist() == [len(np.unique(vals))] * 8
    assert total.tolist() == np.asarray(j_total).tolist() == [8 * 64] * 8
    assert len(jax.devices()) == 8


def test_make_mesh_never_puts_the_cpu_for_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for devices in (None, ["cuda"], ["cuda:0", "cpu"]):
        with pytest.raises(RuntimeError, match="CUDA device"):
            mesh.make_mesh(devices)
    assert mesh.make_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3


def test_devices_that_differ_sketch_in_threads():
    """Distinct devices sketch in a thread each; the shared kernel counters
    lose no update under a short switch interval (10 threads, more than this
    machine's cores), and every record equals the oracle."""
    import sys

    from ntjoin_tpu_torch.ops import sketch_cuda as sc

    devices = ["cpu"] + [f"cpu:{i}" for i in range(9)]
    rng = np.random.default_rng(11)
    recs = [rng.integers(0, 4, size=12_000).astype(np.uint8) for _ in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sc.reset_counts()
        mesh.reset_counts()
        got = mesh.sketch_records_sharded(recs, 21, 50, devices, max_inflight_bases=30_000)
    finally:
        sys.setswitchinterval(old)
    _assert_same(got, [sketch_codes(c, 21, 50) for c in recs])
    assert mesh.COUNTS["tiles"] == 10 * len(recs) and mesh.COUNTS["device_calls"] == 10 * 4
    # one batch a device call: each launches every plain op once
    for op in ("hash", "flags", "window_emit"):
        assert sc.COUNTS[f"{op}_plain"] == mesh.COUNTS["device_calls"], op


def test_source_fed_mesh_matches_list_fed(tmp_path):
    """The CLI's mesh sketcher fed by a ``FastaSource`` (a generator of each
    record's codes that keeps none) equals ``sketch_records_sharded`` of the
    list of codes and the oracle, on the mixed records over 3 shards."""
    from ntjoin_tpu_torch import cli
    from ntjoin_tpu_torch.io.native import FastaSource

    recs, k, w = _mixed(np.random.default_rng(17))
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
    (tmp_path / "a.fa").write_bytes(b"".join(
        b">r%d\n" % i + letters[c].tobytes() + b"\n" for i, c in enumerate(recs)))
    devices = ["cpu"] * 3
    mesh.reset_counts()
    with FastaSource(str(tmp_path / "a.fa")) as src:
        got = cli._sharded(devices)(src, k, w)
    assert mesh.COUNTS["sharded_records"] == len(recs)
    _assert_same(got, mesh.sketch_records_sharded(recs, k, w, devices))
    _assert_same(got, [sketch_codes(c, k, w) for c in recs])
