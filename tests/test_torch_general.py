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
import ntjoin_tpu_torch.ops.sketch_general as sg
import ntjoin_tpu_torch.ops.sketch_records as sr
from ntjoin_tpu.ops.nthash_np import sketch_codes
from ntjoin_tpu_torch.ops.sketch_general import sketch_general_torch
from ntjoin_tpu_torch.utils import timers


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
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, k, w, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:general_records"] == 4 and counts["sketch_route:general_batches"] == 1
    assert "sketch_route:host_records" not in counts
    assert not {"launch:hash", "launch:flags", "launch:window_emit"} & set(counts)
    _assert_same(got, want)


@pytest.mark.parametrize("k,w", [(15, 300), (32, 1100), (15, 4300), (32, 9000)])
def test_general_long_windows_match_oracle(monkeypatch, k, w):
    """Windows on both sides of the window/emission kernel's bands (1,014,
    4,242, 8,362 rows): the plain path's stream equals the oracle's."""
    rng = np.random.default_rng(w)
    recs = [_dense(rng, 3 * w + 40_000, 3 * k, 2), _dense(rng, 3 * w + 2_000, 4 * k),
            _dense(rng, 2 * w + 9_000, 3 * k, 4)]
    _general_only(monkeypatch)
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, k, w, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:general_records"] == 3
    _assert_same(got, [sketch_codes(c, k, w) for c in recs])


@pytest.mark.parametrize("slot_cap", [1, 3])
def test_general_exact_route(monkeypatch, slot_cap):
    """Emission lists forced small: overflowed chunks of the stream take the
    exact window op, with the same sketch."""
    recs = _records(15, 10)
    _general_only(monkeypatch)
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, 15, 10, "cpu", slot_cap=slot_cap)
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:exact_runs"] == 2 and counts["launch:window_plain"] == 2  # fused and general
    assert counts["sketch_route:general_batches"] == 1
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
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, 15, 10, "cpu")
        assert calls == [50_000]
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:host_records"] == 1
    assert counts["sketch_route:general_records"] == 1
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
    with timers.recording(True):
        got = sr.sketch_records_torch([clean, gappy, small], 15, 10, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:host_records"] == 1
    assert counts["sketch_route:general_records"] == 1 and counts["sketch_route:general_batches"] == 1
    assert counts["launch:hash_plain"] == 2  # one fused batch, one general batch
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


def _pack(recs: list[np.ndarray], k: int, w: int):
    """The records joined by exactly k - 1 invalid bases, as a batch is:
    (stream, data bases, starts)."""
    host, total, offsets = sr.pack_batch(recs, k, w)
    return host, total, torch.from_numpy(offsets)


def _stream_len(recs: list[np.ndarray], k: int, w: int) -> tuple[int, int, int]:
    """(S, Cs, Ls) of the records' stream."""
    host, total, starts = _pack(recs, k, w)
    hs, _, Ls, index = sg.stream_batch(host, total, starts, k, w)
    return index.S, hs.shape[1], Ls


def _edge_case(case: str, k: int, w: int) -> list[np.ndarray]:
    """Records whose stream meets an edge of the compaction."""
    rng = np.random.default_rng(len(case) * 100 + k)
    if case == "S_multiple_of_Ls":
        # lengthen one record until the stream fills its last chunk exactly
        head = _dense(rng, 30_000, 50, 2)
        for extra in range(1, 400):
            recs = [head, _dense(np.random.default_rng(extra), 300 + extra, 41, 3)]
            S, Cs, Ls = _stream_len(recs, k, w)
            if Cs > 1 and S == Cs * Ls:
                return recs
        raise AssertionError("no length fills the last chunk")
    if case == "S_below_w":  # fewer kept k-mers than a window, and fewer than w - 1
        few = np.full(120, 4, np.uint8)
        few[40 : 40 + k + 5] = rng.integers(0, 4, size=k + 5)
        return [few, np.full(30, 4, np.uint8)]
    if case == "only_invalid_kmers":  # an N every k - 1 bases: no valid k-mer
        dead = rng.integers(0, 4, size=600).astype(np.uint8)
        dead[:: k - 1] = 4
        return [_dense(rng, 20_000, 97, 2), dead, _dense(rng, 15_000, 61)]
    # valid bases up to both ends of each record: a window ends right at the
    # k - 1 separator bases and the next record's first k-mer follows them
    recs = [rng.integers(0, 4, size=n).astype(np.uint8)
            for n in (15_000, w + k - 1, 9_000, 12_000)]
    for c in recs:
        c[c.shape[0] // 2] = 4
    return recs


@pytest.mark.parametrize("case", ["S_multiple_of_Ls", "S_below_w", "only_invalid_kmers",
                                  "k_minus_1_separators"])
@pytest.mark.parametrize("k,w", [(15, 10), (21, 37)])
def test_general_stream_edges(monkeypatch, case, k, w):
    """Streams at the compaction's edges, through the plain versions, against
    the JAX package's batched Pallas sketch (which routes a record by its
    own size rules, to its general path or its host sketcher) and the
    oracle."""
    recs = _edge_case(case, k, w)
    S, Cs, Ls = _stream_len(recs, k, w)
    if case == "S_multiple_of_Ls":
        assert Cs > 1 and S == Cs * Ls
    if case == "S_below_w":
        assert S < w - 1 and Cs == 1
    _general_only(monkeypatch)
    want = [sketch_codes(c, k, w) for c in recs]
    _assert_same(sp.sketch_records_pallas(recs, k, w, interpret=True), want)
    with timers.recording(True):
        got = sr.sketch_records_torch(recs, k, w, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:general_batches"] == 1 and "sketch_route:host_records" not in counts
    assert counts["launch:stream_plain"] == int(sum(c.shape[0] for c in recs) + k - 1 >= w)
    _assert_same(got, want)
    if case == "only_invalid_kmers":
        assert got[1].positions.shape[0] == 0


def _chunked_stream(case: str, k: int, w: int):
    recs = _edge_case(case, k, w)
    host, total, starts = _pack(recs, k, w)
    return host, total, starts, sg.hash_batch(host, total, k, w)


@pytest.mark.parametrize("case", ["S_multiple_of_Ls", "only_invalid_kmers",
                                  "k_minus_1_separators"])
def test_stream_batch_layout(case):
    """``stream_batch`` on the CPU (the plain version): every rank's hash
    and flag in its chunk, at row r and in the halo of the chunk before,
    all-ones and 0 past S; the index's tile first ranks and its decode of
    every rank the kept positions; one plain call counted and no launch."""
    k, w = 15, 10
    host, total, starts, (h, val, L) = _chunked_stream(case, k, w)
    with timers.recording(True):
        hs, vs, Ls, index = sg.stream_batch(host, total, starts, k, w)
        counts = timers.trace_counts()["counters"]
    assert counts["launch:stream_plain"] == 1 and "launch:stream" not in counts
    keep = val[k - 1 : k - 1 + L].t().reshape(-1)[: total - k + 1].clone()
    dead = starts[1:] - 1
    keep[dead] = 1
    pos = torch.nonzero(keep).flatten()
    S = pos.shape[0]
    assert index.S == S and torch.equal(index.val, val) and index.L == L
    assert index.firsts.tolist() == sg.first_ranks(
        sg.tile_counts_ref(val, L, total, starts, k))[0].tolist()
    assert sg.decode_ranks(index, torch.arange(S)).tolist() == pos.tolist()
    Cs = hs.shape[1]
    assert (Cs, Ls) == sc.layout(S, 1, w) and hs.shape[0] == Ls + w - 1
    by_pos = h[k - 1 : k - 1 + L].t().reshape(-1)
    flat_h = torch.full((Cs * Ls + w - 1,), -1, dtype=torch.int64)
    flat_h[:S] = by_pos[pos]
    flat_v = torch.zeros(Cs * Ls + w - 1, dtype=torch.int8)
    flat_v[:S] = 1
    flat_v[torch.searchsorted(pos, dead)] = 0
    for c in range(Cs):
        assert hs[:, c].tolist() == flat_h[c * Ls : c * Ls + Ls + w - 1].tolist(), c
        assert vs[:, c].tolist() == flat_v[c * Ls : c * Ls + Ls + w - 1].tolist(), c


@pytest.mark.parametrize("seg", [7, 32, 1024])
def test_segment_counts_and_first_ranks(seg):
    """The count pass's plain version over tiles of ``seg`` rows (the
    kernel's are ``STREAM_TILE`` = 32; the columns of L = 93 rows end in a
    short tile for each) and the scan of its counts: each tile's first rank
    is the count of kept positions before its first row, followed by S."""
    k, w = 15, 10
    host, total, starts, (h, val, L) = _chunked_stream("k_minus_1_separators", k, w)
    pos = sg.valid_positions(val, L, total, starts, k)
    counts = sg.tile_counts_ref(val, L, total, starts, k, seg)
    C, T = val.shape[1], sg.stream_tiles(L, seg)
    assert counts.dtype == torch.int64 and counts.shape == (C * T + 1,) and T * seg >= L
    assert T == -(-L // seg) and sg.stream_tiles(L) == -(-L // sg.STREAM_TILE)
    assert int(counts[0]) == 0 and int(counts.min()) >= 0 and int(counts.max()) <= seg
    firsts, S = sg.first_ranks(counts)
    assert S == pos.shape[0] and firsts.dtype == torch.int64 and firsts.shape == (C * T + 1,)
    first_pos = torch.tensor([c * L + t * seg for c in range(C) for t in range(T)])
    assert firsts[:-1].tolist() == torch.searchsorted(pos, first_pos).tolist()
    assert int(firsts[-1]) == S


def _decode_by_tiles(index: sg.StreamIndex, ranks: torch.Tensor) -> list[int]:
    """The decode pass's steps (csrc/stream.cu) in Python: the last tile
    whose first rank is at most the rank, that tile's kept rows (valid
    flags, dead slots, rows below N), the j-th of them."""
    firsts = index.firsts.numpy()
    L, k, tile = index.L, index.k, sg.STREAM_TILE
    T, N = sg.stream_tiles(L), index.n - k + 1
    val = index.val[k - 1 : k - 1 + L].numpy()
    dead = set((index.starts[1:] - 1).tolist())
    out = []
    for q in ranks.tolist():
        x = int(np.searchsorted(firsts[:-1], q, side="right")) - 1
        c, r0 = divmod(x, T)
        r0 *= tile
        kept = [r for r in range(r0, min(r0 + tile, L))
                if c * L + r < N and (val[r, c] != 0 or c * L + r in dead)]
        out.append(c * L + kept[q - int(firsts[x])])
    return out


def _tile_layout(case: str):
    """A hash layout's flags (k = 4, L = 100: four tiles a column, the last
    of 4 rows; the last column ends before L at N) and record starts that
    put dead slots at a tile's edges: (val, n, starts, k)."""
    k, L, C = 4, 100, 6
    n = C * L - 37 + k - 1
    rng = np.random.default_rng(len(case))
    flags = (rng.random((L, C)) < 0.7).astype(np.int8)
    if case == "dead_on_tile_edges":  # rows 32 and 63 of column 1: a tile's first and last
        starts = [0, L + 33, L + 64, 4 * L + 10]
    elif case == "record_start_at_tile_edge":  # rows 64 and 0 start records
        starts = [0, 2 * L + 64, 3 * L, 5 * L + 32]
    else:  # column 3 keeps no row
        flags[:, 3] = 0
        starts = [0, L + 50, 5 * L + 3]
    for s in starts[1:]:
        flags[(s - 1) % L, (s - 1) // L] = 0  # a dead slot's k-mer is never valid
    val = np.zeros((k - 1 + L, C), np.int8)
    val[k - 1 :] = flags
    return torch.from_numpy(val), n, torch.tensor(starts, dtype=torch.int64), k


@pytest.mark.parametrize("case", ["every_rank", "emitted_ranks", "dead_on_tile_edges",
                                  "record_start_at_tile_edge", "column_without_kept_row",
                                  "S_multiple_of_Ls"])
def test_decode_ranks(case):
    """``decode_ranks`` (on the CPU ``valid_positions(...)[ranks]``) and the
    decode pass's steps from the tile first ranks agree on every rank asked
    for: all ranks of a layout, or the ranks a batch's windows emit."""
    if case in ("every_rank", "emitted_ranks", "S_multiple_of_Ls"):
        k, w = 15, 10
        recs = _edge_case("S_multiple_of_Ls" if case == "S_multiple_of_Ls"
                          else "k_minus_1_separators", k, w)
        host, total, starts = _pack(recs, k, w)
        hs, vs, Ls, index = sg.stream_batch(host, total, starts, k, w)
        if case == "S_multiple_of_Ls":
            assert index.S == hs.shape[1] * Ls
        ranks = (sc.window_stream(hs, vs, Ls, w, 0)[0] if case == "emitted_ranks"
                 else torch.arange(index.S))
    else:
        val, n, starts, k = _tile_layout(case)
        L = val.shape[0] - k + 1
        firsts, _ = sg.first_ranks(sg.tile_counts_ref(val, L, n, starts, k))
        index = sg.StreamIndex(val, firsts, L, n, k, starts)
        ranks = torch.arange(index.S)
        if case == "column_without_kept_row":
            T = sg.stream_tiles(L)
            assert int(firsts[4 * T]) == int(firsts[3 * T])  # column 3 keeps nothing
    assert 0 < ranks.shape[0] <= index.S
    want = sg.valid_positions(index.val, index.L, index.n, index.starts, index.k)[ranks]
    got = sg.decode_ranks(index, ranks)
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert _decode_by_tiles(index, ranks) == want.tolist()


@pytest.mark.parametrize("flat,starts,what", [
    (torch.zeros(100, dtype=torch.int32), torch.zeros(1, dtype=torch.int64), "int8 stream"),
    (torch.zeros((2, 50), dtype=torch.int8), torch.zeros(1, dtype=torch.int64), "int8 stream"),
    (torch.zeros(100, dtype=torch.int8), torch.zeros(1, dtype=torch.int32), "record starts"),
    (torch.zeros(100, dtype=torch.int8), torch.zeros((1, 1), dtype=torch.int64),
     "record starts"),
    (torch.zeros(100, dtype=torch.int8), torch.zeros(0, dtype=torch.int64), "record starts"),
    (torch.zeros(100, dtype=torch.int8), torch.zeros(4, dtype=torch.int64)[::2],
     "record starts"),
])
def test_stream_batch_refuses(flat, starts, what):
    with pytest.raises(ValueError, match=what):
        sg.stream_batch(flat, 60, starts, 15, 10)


def test_compaction_passes_want_the_card():
    """The kernel's passes take no CPU tensor: ``stream_batch`` and
    ``decode_ranks`` alone pick the plain version, for a CPU tensor."""
    k, w = 15, 10
    host, total, starts, (h, val, L) = _chunked_stream("k_minus_1_separators", k, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sg._count(val, L, total, starts, k)
    _, _, _, index = sg.stream_batch(host, total, starts, k, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sg._decode(index, torch.arange(3))
    with pytest.raises(ValueError, match="int64 ranks"):
        sg.decode_ranks(index, torch.arange(3, dtype=torch.int32))
