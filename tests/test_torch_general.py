"""The port's general device sketch (``ops/sketch_general.py``: N-dense
records compacted to their valid k-mers on the device) with the plain ops on
the CPU, against the JAX package's batched Pallas sketch (interpret mode,
whose general path serves the same records) and the NumPy oracle; and the
record-size route to the host.  Integer outputs: bit-exact."""
import numpy as np
import pytest
import torch

import ntjoin_tpu.ops.sketch_pallas as sp
import ntjoin_tpu_torch.ops.sketch_cuda as sc
import ntjoin_tpu_torch.ops.sketch_records as sr
from ntjoin_tpu.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.ops.sketch_general import sketch_general_torch


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.positions.tolist() == r.positions.tolist(), i
        assert g.hashes.tolist() == r.hashes.tolist(), i
        assert g.positions.dtype == np.int64 and g.hashes.dtype == np.uint64


def _dense(rng, n: int, every: int, run: int = 1) -> np.ndarray:
    """n seeded bases with an N run of ``run`` bases every ``every``."""
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    for s in range(int(rng.integers(0, every)), n, every):
        c[s : s + run] = 4
    return c


def _records(k: int, w: int) -> list[np.ndarray]:
    """N-dense records: N runs at a record's start and end, a record with
    fewer than w valid k-mers between two long ones, an all-N record, a
    clean record among them."""
    rng = np.random.default_rng(1000 * k + w)
    a = _dense(rng, 30_000, 3 * k, 2)
    a[:50] = 4
    a[-70:] = 4
    short = rng.integers(0, 4, size=w + k - 2).astype(np.uint8)  # w - 1 valid k-mers
    b = _dense(rng, 25_000, 2 * k + 7, 3)
    b[:1] = 4
    c = _dense(rng, 12_000, 2 * k + 1)
    return [a, short, b, np.full(400, 4, np.uint8), c,
            rng.integers(0, 4, size=60_000).astype(np.uint8)]


def _general_only(monkeypatch):
    """The JAX package's guard at test scale: every N-containing record here
    with a valid window takes its general path too (the port sends every
    record with N runs there)."""
    monkeypatch.setattr(sp, "_PATCH_WORK_MIN", 100)


@pytest.mark.parametrize("k,w", [(15, 10), (32, 16), (15, 24)])
def test_general_matches_pallas_and_oracle(monkeypatch, k, w):
    recs = _records(k, w)
    _general_only(monkeypatch)

    def no_host(codes, k, w):
        raise AssertionError("the JAX package took its host sketcher")

    monkeypatch.setattr(sp, "_host_sketch", no_host)
    want = sp.sketch_records_pallas(recs, k, w, interpret=True)
    _assert_same(want, [sketch_codes(c, k, w) for c in recs])
    sc.reset_counts()
    got = sr.sketch_records_torch(recs, k, w, "cpu")
    assert sc.COUNTS["general_records"] == 4 and sc.COUNTS["general_batches"] == 1
    assert sc.COUNTS["host_records"] == 0 and sc.COUNTS["host_records_size"] == 0
    assert sc.COUNTS["hash"] == sc.COUNTS["flags"] == sc.COUNTS["window_emit"] == 0
    _assert_same(got, want)


@pytest.mark.parametrize("k,w", [(15, 300), (32, 1100), (15, 4300), (32, 9000)])
def test_general_long_windows_match_oracle(monkeypatch, k, w):
    """Windows on both sides of the window/emission kernel's bands (1,014,
    4,242, 8,362 rows): the plain path's stream equals the oracle's."""
    rng = np.random.default_rng(w)
    recs = [_dense(rng, 3 * w + 40_000, 3 * k, 2), _dense(rng, 3 * w + 2_000, 4 * k),
            _dense(rng, 2 * w + 9_000, 3 * k, 4)]
    _general_only(monkeypatch)
    sc.reset_counts()
    got = sr.sketch_records_torch(recs, k, w, "cpu")
    assert sc.COUNTS["general_records"] == 3
    _assert_same(got, [sketch_codes(c, k, w) for c in recs])


@pytest.mark.parametrize("slot_cap", [1, 3])
def test_general_exact_route(monkeypatch, slot_cap):
    """Emission lists forced small: overflowed chunks of the stream take the
    exact window op, with the same sketch."""
    recs = _records(15, 10)
    _general_only(monkeypatch)
    sc.reset_counts()
    got = sr.sketch_records_torch(recs, 15, 10, "cpu", slot_cap=slot_cap)
    assert sc.COUNTS["exact_runs"] == 2 and sc.COUNTS["window_plain"] == 2  # fused and general
    assert sc.COUNTS["general_batches"] == 1
    _assert_same(got, [sketch_codes(c, 15, 10) for c in recs])


def test_general_call_positions_and_plain_flag():
    """``sketch_general_torch`` on one packed stream: positions in the
    stream, ascending, records cut at their starts; ``plain`` changes
    nothing on a CPU tensor."""
    rng = np.random.default_rng(5)
    k, w = 15, 12
    few = rng.integers(0, 4, size=26).astype(np.uint8)
    few[20] = 4  # 6 valid k-mers, no window
    recs = [_dense(rng, 4000, 20), _dense(rng, 9, 100), few, np.full(300, 4, np.uint8),
            _dense(rng, 7000, 33, 5)]
    starts = np.cumsum([0] + [c.shape[0] + k - 1 for c in recs[:-1]])
    n = int(starts[-1]) + 7000 + k - 1
    C, L = sc.layout(n, k, w)
    flat = np.full(C * L + w + k - 2, 4, np.int8)
    for s, c in zip(starts, recs):
        flat[s : s + c.shape[0]] = c
    outs = [sketch_general_torch(torch.from_numpy(flat), n, torch.from_numpy(starts), k, w,
                                 plain=plain) for plain in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    pos, canon = outs[0]
    assert bool((pos[1:] > pos[:-1]).all())
    for s, e, c in zip(starts, list(starts[1:]) + [n], recs):
        sel = (pos >= int(s)) & (pos < int(e))
        want = sketch_codes(c, k, w)
        assert (pos[sel] - int(s)).tolist() == want.positions.tolist()


def test_size_route_goes_to_host(monkeypatch):
    """A record longer than the device bound (patched small) is sketched
    whole on the host, decided before any launch and counted apart; the
    others stay on the device paths; every sketch equals the oracle."""
    rng = np.random.default_rng(9)
    big = rng.integers(0, 4, size=50_000).astype(np.uint8)
    big[20_000:20_100] = 4
    recs = [rng.integers(0, 4, size=8_000).astype(np.uint8), big,
            _dense(rng, 9_000, 40, 2)]
    monkeypatch.setattr(sr, "MAX_RECORD_BASES", 40_000)
    calls = []
    host = sr._host_sketch

    def counted(codes, k, w):
        calls.append(codes.shape[0])
        return host(codes, k, w)

    monkeypatch.setattr(sr, "_host_sketch", counted)
    sc.reset_counts()
    got = sr.sketch_records_torch(recs, 15, 10, "cpu")
    assert calls == [50_000]
    assert sc.COUNTS["host_records_size"] == 1 and sc.COUNTS["host_records"] == 1
    assert sc.COUNTS["general_records"] == 1
    _assert_same(got, [sketch_codes(c, 15, 10) for c in recs])


def test_size_route_by_path(monkeypatch):
    """Each path has its own bound: a record with N runs past the general
    path's bound goes to the host while an N-free record of the same length
    stays on the fused path."""
    rng = np.random.default_rng(10)
    clean = rng.integers(0, 4, size=30_000).astype(np.uint8)
    gappy = _dense(rng, 30_000, 500, 3)
    small = _dense(rng, 9_000, 40, 2)
    monkeypatch.setattr(sr, "record_bound",
                        lambda device, general=False: 20_000 if general else 50_000)
    sc.reset_counts()
    got = sr.sketch_records_torch([clean, gappy, small], 15, 10, "cpu")
    assert sc.COUNTS["host_records_size"] == 1 and sc.COUNTS["host_records"] == 1
    assert sc.COUNTS["general_records"] == 1 and sc.COUNTS["general_batches"] == 1
    assert sc.COUNTS["hash_plain"] == 2  # one fused batch, one general batch
    _assert_same(got, [sketch_codes(c, 15, 10) for c in (clean, gappy, small)])


class _Card:
    def __init__(self, total_memory: int):
        self.total_memory = total_memory


@pytest.mark.parametrize("gib", [80, 16])
def test_record_bound(monkeypatch, gib):
    """The CPU takes records up to ``MAX_RECORD_BASES``; a card up to three
    quarters of its memory at each path's bytes a base, and no more."""
    assert sr.record_bound(torch.device("cpu")) == sr.MAX_RECORD_BASES == (1 << 31) - (1 << 22)
    assert sr.record_bound(torch.device("cpu"), general=True) == sr.MAX_RECORD_BASES
    total = gib << 30
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: _Card(total))
    card = torch.device("cuda")
    for general, per in ((False, sr.FUSED_BYTES_PER_BASE), (True, sr.GENERAL_BYTES_PER_BASE)):
        assert sr.record_bound(card, general) == min(sr.MAX_RECORD_BASES, 3 * total // 4 // per)
    if gib == 80:  # an H100: every record up to the kernels' bound fits either path
        assert sr.record_bound(card, True) == sr.record_bound(card) == sr.MAX_RECORD_BASES
    else:
        assert sr.record_bound(card, True) < sr.record_bound(card) < sr.MAX_RECORD_BASES
