"""The port's batched multi-record sketch (plain ops on the CPU) against the
JAX package's batched Pallas sketch (interpret mode) and the NumPy oracle,
bit for bit, on the record sets of the JAX package's own batch tests."""
import numpy as np
import pytest

import ntjoin_tpu_torch.ops.sketch_records as sr
from ntjoin_tpu_torch.utils import timers
from ntjoin_tpu.ops.nthash_np import sketch_codes
from ntjoin_tpu.ops.sketch_pallas import sketch_records_pallas


def _batched():
    rng = np.random.default_rng(33)
    recs = [rng.integers(0, 4, size=ln).astype(np.uint8) for ln in [5000, 120, 9000, 31, 4000, 2500]]
    recs[0][100:160] = 4  # N run inside one record
    return recs


def _segmented():
    rng = np.random.default_rng(46)
    recs = []
    for ln in [9000, 12000]:
        c = rng.integers(0, 4, size=ln).astype(np.uint8)
        # interior runs, incl. short inter-run segments (< w+k-1)
        for start, rl in [(500, 40), (550, 30), (4000, 200), (ln - 300, 5)]:
            c[start : start + rl] = 4
        recs.append(c)
    return recs


def _clean():
    rng = np.random.default_rng(45)
    return [rng.integers(0, 4, size=ln).astype(np.uint8) for ln in [8000, 40, 6000, 2000, 9]]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.positions.tolist() == r.positions.tolist()
        assert g.hashes.tolist() == r.hashes.tolist()


@pytest.mark.parametrize("records", [_batched, _segmented, _clean])
def test_records_match_pallas_and_oracle(records):
    recs = records()
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, 15, 10, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["launch:hash_plain"] >= 1 and counts["launch:window_emit_plain"] >= 1
    assert not {"launch:hash", "launch:window_emit", "launch:window"} & set(counts)
    assert "sketch_route:host_records" not in counts
    _assert_same(got, [sketch_codes(c, 15, 10) for c in recs])
    _assert_same(got, sketch_records_pallas(recs, 15, 10, interpret=True))


def test_pathological_n_density_goes_to_host(monkeypatch):
    """An N every 25 bases leaves only short segments, which once sent the
    record to the host sketcher; now, as every record with N runs, it goes
    whole to the general device path (counted); the host takes nothing."""
    rng = np.random.default_rng(47)
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    codes[::25] = 4
    clean = rng.integers(0, 4, size=20_000).astype(np.uint8)
    with timers.recording(True):
        got = sr.sketch_records_torch([codes, clean], 15, 16, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:general_records"] == 1 and counts["sketch_route:general_batches"] == 1
    assert "sketch_route:host_records" not in counts
    _assert_same(got, [sketch_codes(codes, 15, 16), sketch_codes(clean, 15, 16)])


def test_batches_split_records(monkeypatch):
    """A small batch size spreads the records over several device batches
    with the same result."""
    rng = np.random.default_rng(60)
    recs = [rng.integers(0, 4, size=ln).astype(np.uint8) for ln in [9000, 8000, 7000, 6000]]
    recs[2][3000:3100] = 4
    monkeypatch.setattr(sr, "BATCH_BASES", 16_000)
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, 15, 10, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["launch:hash_plain"] >= 3
    _assert_same(got, [sketch_codes(c, 15, 10) for c in recs])


@pytest.mark.parametrize("n", [0, 5, 14, 15, 23, 24, 100])
def test_short_inputs(n):
    """Records shorter than k or with fewer than w k-mers emit nothing."""
    codes = np.random.default_rng(n).integers(0, 4, size=n).astype(np.uint8)
    got = sr.sketch_codes_torch(codes, 15, 10, "cpu")
    want = sketch_codes(codes, 15, 10)
    assert got.positions.tolist() == want.positions.tolist()
    assert got.hashes.tolist() == want.hashes.tolist()
    assert got.positions.dtype == np.int64 and got.hashes.dtype == np.uint64
