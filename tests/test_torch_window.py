"""Window ops of the port against the JAX package: the exact window op
against the Pallas window kernel (interpret mode) and the NumPy lexmin, and
the emitted stream of ``sketch_fused_torch`` against ``_sketch_fused``.
Integer outputs: comparisons are bit-exact (tolerance zero)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntjoin_tpu.ops.nthash_np import _window_lexmin, derive_hash, sketch_codes
from ntjoin_tpu.ops.sketch_pallas import (
    _CHUNKS, _LANE, _ROW_BLOCK, _SUB, _ceil_to, _expand_runs, _sketch_fused, _window_chunked,
)
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops import sketch_records as sr
from ntjoin_tpu_torch.ops import u64
from ntjoin_tpu_torch.utils import timers

# few distinct values (many ties), some with the top bit set (unsigned order)
_ALPHABET = np.array([3, 7, 2**63, 2**63 + 1, 2**64 - 2, 5], dtype=np.uint64)


@pytest.mark.parametrize("w", [16, 12])  # w % 8 == 0 takes the sublane-tiled kernel
def test_window_argmin_matches_pallas(w):
    rng = np.random.default_rng(w)
    L = 3 * w
    n_el = L + w - 1
    h = _ALPHABET[rng.integers(0, _ALPHABET.shape[0], size=(n_el, _CHUNKS))]
    with timers.recording(True):
        am = sc.window_argmin(torch.from_numpy(h.view(np.int64)), L, w, 0)
        counts = timers.trace_counts()["counters"]
    assert counts["launch:window_plain"] == 1 and "launch:window" not in counts
    assert tuple(am.shape) == (L, _CHUNKS)

    rows = (-(-n_el // w) + 1) * w  # whole blocks plus one all-max flush block
    hp = np.full((rows, _CHUNKS), 2**64 - 1, dtype=np.uint64)
    hp[:n_el] = h
    grp = hp.reshape(rows, _SUB, _LANE).transpose(1, 0, 2)
    lo = jnp.asarray((grp & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((grp >> np.uint64(32)).astype(np.uint32))
    ix = _window_chunked(lo, hi, jnp.asarray([L], jnp.int32), w, interpret=True)
    want = np.asarray(ix).transpose(1, 0, 2).reshape(-1, _CHUNKS)[:L]
    assert np.array_equal(am.numpy(), want)

    for c in (0, 1, 777, _CHUNKS - 1):
        assert np.array_equal(am[:, c].numpy(), _window_lexmin(h[:, c], w)[:L] + c * L)

    sel = torch.tensor([5, 0, 2047])
    assert torch.equal(sc.window_argmin(torch.from_numpy(h.view(np.int64)), L, w, 0, sel),
                       am[:, sel])


def _pallas_stream(buf, n, k, w, multi=False):
    """Expanded, seam-deduplicated (position, canonical hash) stream of the
    JAX package's fused sketch."""
    nk = n - k + 1
    cap = max(4 * (nk // w + 1), 4096) + _CHUNKS
    pos, lo, hi, count, ok, slots_ok, run = _sketch_fused(
        jnp.asarray(buf), n, k, w, cap, multi=multi, interpret=True)
    assert bool(ok) and bool(slots_ok)
    cnt = int(count)
    pos = np.asarray(pos[:cnt]).astype(np.int64)
    lo, hi = np.asarray(lo[:cnt]), np.asarray(hi[:cnt])
    pos, lo, hi = _expand_runs(pos, lo, hi, None if run is None else np.asarray(run[:cnt]))
    keep = np.ones(pos.shape[0], bool)
    keep[1:] = pos[1:] != pos[:-1]
    canon = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return pos[keep], canon[keep]


def _pallas_buffer(stream, n, k, w):
    L = -(-(n - k + 1) // _CHUNKS)
    buf = np.full(_CHUNKS * L + _ceil_to(L + w + k - 2, _ROW_BLOCK), 4, dtype=np.int8)
    buf[:n] = stream[:n]
    return buf


def _port_stream(stream, n, k, w, **kw):
    C, L = sc.layout(n, k, w)
    flat = np.full(C * L + w + k - 2, 4, dtype=np.int8)
    flat[:n] = stream[:n]
    pos, canon = sc.sketch_fused_torch(torch.from_numpy(flat), n, k, w, **kw)
    return pos.numpy(), u64.as_u64(canon)


def _joined(records, k):
    """Records joined by k-1 invalid bases, as the batched sketches lay them out."""
    parts = []
    for r in records:
        parts += [r.astype(np.int8), np.full(k - 1, 4, np.int8)]
    return np.concatenate(parts)


@pytest.mark.parametrize("k,w", [(15, 16), (32, 40)])
def test_fused_stream_matches_pallas(k, w):
    rng = np.random.default_rng(21 + k)
    codes = rng.integers(0, 4, size=70_000).astype(np.int8)
    n = codes.shape[0]
    with timers.recording(True):
        pos, canon = _port_stream(codes, n, k, w)
        jpos, jcanon = _pallas_stream(_pallas_buffer(codes, n, k, w), n, k, w)
        assert pos.tolist() == jpos.tolist()
        assert canon.tolist() == jcanon.tolist()
        ref = sketch_codes(codes.view(np.uint8), k, w)
        assert pos.tolist() == ref.positions.tolist()
        assert derive_hash(canon, k).tolist() == ref.hashes.tolist()
        counts = timers.trace_counts()["counters"]
    assert counts["launch:window_emit_plain"] == 1 and "sketch_route:exact_runs" not in counts


@pytest.mark.parametrize("k,w", [(15, 16), (32, 40)])
def test_fused_multi_record_matches_pallas(k, w):
    """Records joined by k-1 invalid bases: window-valid and force flags."""
    rng = np.random.default_rng(3 + w)
    records = [rng.integers(0, 4, size=ln) for ln in [30_000, 120, 25_000, 31, 15_000, 40]]
    stream = _joined(records, k)
    n = stream.shape[0]
    pos, canon = _port_stream(stream, n, k, w)
    jpos, jcanon = _pallas_stream(_pallas_buffer(stream, n, k, w), n, k, w, multi=True)
    assert pos.tolist() == jpos.tolist()
    assert canon.tolist() == jcanon.tolist()


def _repeat_codes():
    """The repeat fixture of the JAX package's run-compression test."""
    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    codes[5_000:5_200] = 1  # poly-C
    codes[20_000:20_060] = 3  # poly-T
    codes[40_000:40_100:2] = 0  # AT: one canonical hash, stride-1 slides
    codes[40_001:40_101:2] = 3
    codes[52_000:52_400:2] = 0  # AC: distinct phases, stride-2 slides
    codes[52_001:52_401:2] = 1
    return codes


def test_repeat_runs_take_exact_path():
    k, w = 15, 16
    codes = _repeat_codes()
    n = codes.shape[0]
    with timers.recording(True):
        pos, canon = _port_stream(codes.view(np.int8), n, k, w)
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:exact_runs"] == 1 and counts["launch:window_plain"] == 1
    jpos, jcanon = _pallas_stream(_pallas_buffer(codes.view(np.int8), n, k, w), n, k, w)
    assert pos.tolist() == jpos.tolist() and canon.tolist() == jcanon.tolist()
    ref = sketch_codes(codes, k, w)
    assert pos.tolist() == ref.positions.tolist()
    # runs inside and at the edges of records of a batch
    recs = [codes[:30_000], codes[30_000:], codes[4_990:5_230]]
    for rec, got in zip(recs, sr.sketch_records_torch(recs, k, w, "cpu")):
        r = sketch_codes(rec, k, w)
        assert got.positions.tolist() == r.positions.tolist()
        assert got.hashes.tolist() == r.hashes.tolist()


def test_periodic_repeat_exact():
    """A 600 bp AC repeat emits every 2nd window (distinct phase hashes)."""
    k, w = 15, 64
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=70_000).astype(np.uint8)
    codes[30_000:30_600:2] = 0
    codes[30_001:30_601:2] = 1
    with timers.recording(True):
        got = sr.sketch_codes_torch(codes, k, w, "cpu")
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:exact_runs"] == 1
    ref = sketch_codes(codes, k, w)
    assert got.positions.tolist() == ref.positions.tolist()
    assert got.hashes.tolist() == ref.hashes.tolist()


@pytest.mark.parametrize("slot_cap", [0, 1, 4])
def test_forced_overflow_is_exact(slot_cap):
    """A capacity below the chunks' emission counts sends them through the
    exact window op; the stream is unchanged."""
    k, w = 21, 24
    rng = np.random.default_rng(slot_cap)
    codes = rng.integers(0, 4, size=40_000).astype(np.int8)
    codes[7_000:7_050] = 4
    n = codes.shape[0]
    base_pos, base_canon = _port_stream(codes, n, k, w)
    with timers.recording(True):
        pos, canon = _port_stream(codes, n, k, w, slot_cap=slot_cap)
        counts = timers.trace_counts()["counters"]
    assert counts["sketch_route:exact_runs"] == 1 and counts["launch:window_plain"] == 1
    assert pos.tolist() == base_pos.tolist() and canon.tolist() == base_canon.tolist()


def test_window_emit_lists_and_counts():
    """Per-chunk lists hold the first cap emissions, padded -1 / 0; counts
    keep going past the capacity."""
    k, w = 15, 16
    codes = _repeat_codes().view(np.int8)
    n = codes.shape[0]
    C, L = sc.layout(n, k, w)
    rows = L + w + k - 2
    flat = np.full(C * L + w + k - 2, 4, dtype=np.int8)
    flat[:n] = codes
    h, val = sc.hash_chunked(torch.from_numpy(flat), L, C, rows, k)
    flags = sc.window_flags(val, L, w, k - 1)
    am = sc.window_argmin(h, L, w, k - 1)
    emit = sc._emit_mask(am, flags)
    cap = 6
    pos, hsh, count = sc.window_emit(h, flags, L, w, k - 1, cap)
    assert torch.equal(count, emit.sum(0))
    assert int(count.max()) > cap
    for c in range(C):
        want = am[:, c][emit[:, c]][:cap]
        m = want.shape[0]
        assert torch.equal(pos[:m, c], want)
        assert (pos[m:, c] == -1).all() and (hsh[m:, c] == 0).all()
        assert torch.equal(hsh[:m, c], h[want - c * L + k - 1, c])


# -- the pitched layout and the emission contract across unit seams -----------------
#
# On the card the hash and flag arrays are (rows, C) views of buffers whose
# rows are C rounded up to 16 columns apart, and kernel 2 cuts a chunk's
# windows into blocks of w that separate threads decide.  The plain versions
# are what the kernel is held to there, so they are held here to the layout
# (pad columns must not leak) and to the contract at the seams between blocks.


def _chunked_hashes(codes, k, w):
    """(h, val, flags, C, L) of the port's layout for one stream."""
    n = codes.shape[0]
    C, L = sc.layout(n, k, w)
    flat = np.full(C * L + w + k - 2, 4, dtype=np.int8)
    flat[:n] = codes
    h, val = sc.hash_chunked(torch.from_numpy(flat), L, C, L + w + k - 2, k)
    return h, val, sc.window_flags(val, L, w, k - 1), C, L


def _emission_lists(h_u64, flags, L, w, off, cap):
    """The contract, chunk by chunk, from the NumPy lexmin."""
    C = h_u64.shape[1]
    pos = np.full((cap, C), -1, np.int64)
    hsh = np.zeros((cap, C), np.uint64)
    count = np.zeros(C, np.int64)
    for c in range(C):
        col = h_u64[off : off + L + w - 1, c]
        am = _window_lexmin(col, w)[:L]
        prev = np.concatenate([[-1], am[:-1]])
        f = flags[:, c]
        emit = ((f & 1) != 0) & (((f & 2) != 0) | (am != prev))
        count[c] = emit.sum()
        s = am[emit][:cap]
        pos[: s.shape[0], c] = c * L + s
        hsh[: s.shape[0], c] = col[s]
    return pos, hsh, count


def test_pitched_layout_matches_unpitched():
    k, w = 15, 16
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=9_000).astype(np.int8)
    codes[4_000:4_030] = 4
    h, val, flags, C, L = _chunked_hashes(codes, k, w)
    assert C % sc.PITCH != 0 and h.stride(0) == C  # the CPU wrappers do not pad
    hp = sc.pitched(h.shape[0], C, torch.int64, h.device)
    vp = sc.pitched(val.shape[0], C, torch.int8, val.device)
    assert hp.stride() == (-(-C // sc.PITCH) * sc.PITCH, 1) and hp.shape == h.shape
    # whatever the pad columns hold must not reach a result
    sc._padded(hp).copy_(torch.from_numpy(rng.integers(-2**62, 2**62, size=sc._padded(hp).shape)))
    sc._padded(vp).fill_(1)
    hp.copy_(h)
    vp.copy_(val)
    fp = sc.window_flags(vp, L, w, k - 1)
    assert fp.stride(0) == hp.stride(0) and torch.equal(fp, flags)
    cap = sc._slot_cap(L, w)
    for got, want in zip(sc.window_emit(hp, fp, L, w, k - 1, cap),
                         sc.window_emit(h, flags, L, w, k - 1, cap)):
        assert torch.equal(got, want)
    sel = torch.tensor([0, C - 1, 3])
    assert torch.equal(sc.window_argmin(hp, L, w, k - 1, sel), sc.window_argmin(h, L, w, k - 1, sel))
    with pytest.raises(ValueError, match="unit column stride"):
        sc._check_rows(hp.t(), torch.int64, tuple(hp.t().shape), "transposed")


@pytest.mark.parametrize("w,tile", [(10, 8), (1000, 8), (1014, 8), (1015, 4), (2000, 4),
                                    (4000, 2), (4242, 2), (4243, 1), (5000, 1), (8362, 1),
                                    (8363, 0), (10000, 0)])
def test_emit_tile_follows_shared_memory(w, tile):
    """The route is chosen from w alone: the widest tile whose segments,
    argmins and flags fit in 227 KB (a one-chunk tile, with its 256 row
    groups, from w = 4,243 up to 8,362), else the device-memory route."""
    assert sc.emit_tile(w) == tile

    def fits(t):
        return 27 * w * t + 26 * sc.emit_groups(t) * t + 8 * t <= 232_448

    assert [t for t in (8, 4, 2, 1) if fits(t)][:1] == ([tile] if tile else [])
    if tile:
        assert 2 * w < 1 << 15  # 16-bit argmin offsets inside two segments
        assert sc.emit_groups(tile) % 32 == 0  # whole lanes of the scanning warp


def test_emission_contract_at_block_seams():
    """An argmin that stays across a block boundary emits once; a forced
    window at a block's first row emits although its argmin did not move; an
    invalid window emits nothing; a chunk past the capacity keeps its count."""
    k, w = 15, 16
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=30_000).astype(np.int8)
    h, _, flags, C, L = _chunked_hashes(codes, k, w)
    assert L > 4 * w
    hu = u64.as_u64(h)
    flags = flags.clone()
    am = sc.window_argmin(h, L, w, k - 1)
    seams = torch.arange(w, L, w)  # first windows of blocks 1, 2, ...
    stays = am[seams] == am[seams - 1]
    assert int(stays.sum()) > stays.numel() // 2  # most seams keep their argmin
    # force one such seam window in every 3rd chunk, and knock out a window
    # just before another seam in every 5th
    forced = []
    for c in range(0, C, 3):
        rows = seams[stays[:, c]]
        if rows.numel():
            flags[rows[0], c] |= 2
            forced.append((int(rows[0]), c))
    for c in range(0, C, 5):
        flags[2 * w - 1, c] = 0
    cap = 6
    pos, hsh, count = sc.window_emit(h, flags, L, w, k - 1, cap)
    want_pos, want_hsh, want_count = _emission_lists(hu, flags.numpy(), L, w, k - 1, cap)
    assert np.array_equal(pos.numpy(), want_pos)
    assert np.array_equal(u64.as_u64(hsh), want_hsh)
    assert np.array_equal(count.numpy(), want_count)
    assert int(count.max()) > cap  # true counts past the capacity
    big = sc.window_emit(h, flags, L, w, k - 1, L)[0].numpy()
    for j, c in forced:  # emitted twice: once where it became the argmin, once forced
        assert int((big[:, c] == int(am[j, c])).sum()) == 2, (j, c)
    c = next(c for c in range(C) if c % 3 and stays[:, c].any())
    j = int(seams[stays[:, c]][0])
    assert int((big[:, c] == int(am[j, c])).sum()) == 1  # across the seam: once


def _seam_records(k, w, total):
    """Record lengths (sum with separators = total) whose second record's
    first window is the first window of a block of w in its chunk."""
    C, L = sc.layout(total, k, w)
    for first in range(5_000, 5_000 + 4 * L):
        start = first + k - 1  # stream position of record 2's first k-mer
        if (start % L) % w == 0 and start % L != 0:
            return [first, total - start - 2 * (k - 1) - 4_000, 4_000], start
    raise AssertionError("no such layout")


@pytest.mark.parametrize("k,w", [(15, 16), (32, 40)])
def test_forced_window_on_a_block_seam_matches_pallas(k, w):
    """A record whose first (forced) window falls on a block's first row, in
    a joined stream: the port's stream equals the JAX package's fused sketch
    (interpret mode) and, record by record, the NumPy oracle."""
    total = 40_000
    lens, start = _seam_records(k, w, total)
    rng = np.random.default_rng(k * w)
    records = [rng.integers(0, 4, size=ln) for ln in lens]
    stream = _joined(records, k)
    n = stream.shape[0]
    assert n == total
    C, L = sc.layout(n, k, w)
    assert (start % L) % w == 0
    with timers.recording(True):
        pos, canon = _port_stream(stream, n, k, w)
        counts = timers.trace_counts()["counters"]
    assert counts["launch:window_emit_plain"] == 1 and "sketch_route:exact_runs" not in counts
    assert ((pos >= start) & (pos < start + w)).any()  # the forced window's argmin
    jpos, jcanon = _pallas_stream(_pallas_buffer(stream, n, k, w), n, k, w, multi=True)
    assert pos.tolist() == jpos.tolist() and canon.tolist() == jcanon.tolist()
    hashes = derive_hash(canon, k)
    offset = 0
    for rec in records:
        ref = sketch_codes(rec.astype(np.uint8), k, w)
        sel = (pos >= offset) & (pos < offset + rec.shape[0])
        assert (pos[sel] - offset).tolist() == ref.positions.tolist()
        assert hashes[sel].tolist() == ref.hashes.tolist()
        offset += rec.shape[0] + k - 1


def test_overflowed_chunk_keeps_its_count_and_stream():
    """Capacity 1: the chunks overflow, their counts stay true, and the
    exact path gives the JAX package's stream."""
    k, w = 15, 16
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, size=20_000).astype(np.int8)
    n = codes.shape[0]
    h, _, flags, C, L = _chunked_hashes(codes, k, w)
    _, _, count = sc.window_emit(h, flags, L, w, k - 1, 1)
    _, _, want = _emission_lists(u64.as_u64(h), flags.numpy(), L, w, k - 1, 1)
    assert np.array_equal(count.numpy(), want) and int((count > 1).sum()) >= C - 2
    pos, canon = _port_stream(codes, n, k, w, slot_cap=1)
    jpos, jcanon = _pallas_stream(_pallas_buffer(codes, n, k, w), n, k, w)
    assert pos.tolist() == jpos.tolist() and canon.tolist() == jcanon.tolist()


# -- the row-group split of the kernels that read their rows from device memory ----
#
# Kernel 3 and kernel 2's device-memory route (csrc/vanherk.cuh, namespace
# split) cut the w rows of a segment into passes of G row groups of R rows:
# group minima, exclusive carries from the groups after (segment b) and before
# (segment b + 1), a first pass for the minima of the later passes, suffix
# minima in place, combine with the running prefix minimum.  The card is the
# only place where they run, so their arithmetic is emulated here in NumPy,
# step for step, and held to the plain versions.

_NONE = (2**64 - 1, 0xFFFFFFFF)


def _left_wins(a, b):
    return b if b[0] < a[0] else a


def _split_windows(col, L, w, G, R, walk=False):
    """``split::block_windows`` for one column of hashes (Python ints, one per
    element): yields (b, t0, keys, args) for every block of windows, pass and
    row group, in the kernel's order; args are offsets from element b*w.
    With ``walk`` the blocks of windows hand their second segment on, as a
    thread block that takes them in order does: the passes' minima where a
    segment takes several passes, the rows and the scan of their group
    minima where it takes one."""
    n_el = L + w - 1
    Q = G * R
    S = -(-w // Q)

    def load(seg0, t):
        return col[seg0 + t] if t < w and seg0 + t < n_el else _NONE[0]

    def fold(keys, a0):
        m = _NONE
        for r, key in enumerate(keys):
            m = _left_wins(m, (key, a0 + r))
        return m

    def after(mins):  # minimum over the entries after each
        out, run = [_NONE] * len(mins), _NONE
        for i in reversed(range(len(mins))):
            out[i] = run
            run = _left_wins(mins[i], run)
        return out

    def before_(mins):  # minimum over the entries before each, and over all
        out, run = [_NONE] * len(mins), _NONE
        for i, m in enumerate(mins):
            out[i] = run
            run = _left_wins(run, m)
        return out, run

    def as_segment_b(m):  # an argmin noted in segment b + 1, seen from the next block
        return (m[0], m[1] if m[1] == _NONE[1] else m[1] - w)

    def rows_to_windows(kb, kn, suf, pre, t0):
        keys, args = [0] * R, [0] * R
        for r in reversed(range(R)):
            if kb[r] <= suf[0]:
                suf = (kb[r], t0 + r)
            keys[r], args[r] = suf
        for r in range(R):
            if pre[0] < keys[r]:
                keys[r], args[r] = pre
            if kn[r] < pre[0]:
                pre = (kn[r], w + t0 + r)
        return keys, args

    warm, noted, handed = False, [_NONE] * S, None
    for b in range(-(-L // w)):
        base = b * w
        if S == 1 and walk:
            t0s = [g * R for g in range(G)]
            if warm:
                kb, suf = handed
            else:
                kb = [[load(base, t0 + r) for r in range(R)] for t0 in t0s]
                suf = after([fold(kb[g], t0s[g]) for g in range(G)])
            kn = [[load(base + w, t0 + r) for r in range(R)] for t0 in t0s]
            mins = [fold(kn[g], w + t0s[g]) for g in range(G)]
            pre, _ = before_(mins)
            handed, warm = (kn, [as_segment_b(m) for m in after(mins)]), True
            for g, t0 in enumerate(t0s):
                yield (b, t0, *rows_to_windows(kb[g], kn[g], suf[g], pre[g], t0))
            continue
        if S > 1 and not warm:
            noted = [fold([load(base, s * Q + t) for t in range(Q)], s * Q) for s in range(S)]
        later = after(noted)  # minimum over the later passes of segment b
        before = _NONE  # minimum over the earlier passes of segment b + 1
        for s in range(S):
            t0s = [s * Q + g * R for g in range(G)]
            kb = [[load(base, t0 + r) for r in range(R)] for t0 in t0s]
            kn = [[load(base + w, t0 + r) for r in range(R)] for t0 in t0s]
            suf = after([fold(kb[g], t0s[g]) for g in range(G)])
            pre, total = before_([fold(kn[g], w + t0s[g]) for g in range(G)])
            for g, t0 in enumerate(t0s):
                yield (b, t0, *rows_to_windows(kb[g], kn[g], _left_wins(suf[g], later[s]),
                                               _left_wins(before, pre[g]), t0))
            before = _left_wins(before, total)
            if walk:
                noted[s] = as_segment_b(total)
        warm = walk


def _split_argmins(hu, L, w, off, G, R, walk=False):
    """Kernel 3 over all chunks by the split: (L, C) stream positions."""
    C = hu.shape[1]
    am = np.full((L, C), -1, np.int64)
    for c in range(C):
        col = [int(v) for v in hu[off : off + L + w - 1, c]]
        for b, t0, _, args in _split_windows(col, L, w, G, R, walk):
            for r, a in enumerate(args):
                if t0 + r < w and b * w + t0 + r < L:
                    am[b * w + t0 + r, c] = c * L + b * w + a
    return am


def _split_emissions(hu, flags, L, w, off, cap, G, R, walk=True):
    """Kernel 2's device-memory route by the split: `prev` of a group's first
    window is the last window of the group before, of the pass before, or of
    the block before, as ``EmitSink`` takes it."""
    C = hu.shape[1]
    pos = np.full((cap, C), -1, np.int64)
    hsh = np.zeros((cap, C), np.uint64)
    count = np.zeros(C, np.int64)
    for c in range(C):
        col = [int(v) for v in hu[off : off + L + w - 1, c]]
        running, prev_s, last_s = 0, -1, None
        for b, t0, keys, args in _split_windows(col, L, w, G, R, walk):
            base = b * w
            prev = prev_s if t0 % (G * R) == 0 else last_s
            new_prev_s = None
            for r in range(R):
                t = t0 + r
                s = base + args[r]
                live = t < w and base + t < L
                f = int(flags[base + t, c]) if live else 0
                if live and f & 1 and (f & 2 or s != prev):
                    if running < cap:
                        pos[running, c] = c * L + s
                        hsh[running, c] = keys[r]
                    running += 1
                prev = s
                if t == w - 1 or (t < w and r == R - 1 and t0 // R % G == G - 1):
                    new_prev_s = s
            last_s = base + args[R - 1]
            if new_prev_s is not None:
                prev_s = new_prev_s
        count[c] = running
    return pos, hsh, count


def _repeat_stream(n, seed):
    """Seeded bases with N runs, a homopolymer and an alternating stretch."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    codes[n // 7 : n // 7 + 9] = 4
    codes[n // 2 : n // 2 + 3] = 4
    codes[n // 3 : n // 3 + 400] = 1
    codes[2 * n // 3 : 2 * n // 3 + 400 : 2] = 0
    codes[2 * n // 3 + 1 : 2 * n // 3 + 401 : 2] = 1
    return codes


# (w, G, R): one pass and several, more groups than rows, one row a group,
# a last pass that the segment fills only in part
_SPLITS = [(3, 4, 2), (16, 1, 4), (16, 2, 8), (16, 64, 8), (40, 3, 4), (40, 5, 8), (40, 7, 1),
           (200, 8, 8), (200, 4, 4), (333, 16, 2)]


@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("w,G,R", _SPLITS)
def test_split_argmins_match_plain(w, G, R, walk):
    """The row-group split against ``window_argmin_ref``, on few-valued
    hashes (ties everywhere, top bit set) and on a stream's real hashes; a
    block of windows by itself (a list of chunks) and the blocks in turn, each
    handing its second segment on (all chunks)."""
    rng = np.random.default_rng(w * G + R)
    L = 3 * w + 5  # a short last block of windows
    h = _ALPHABET[rng.integers(0, _ALPHABET.shape[0], size=(L + w - 1 + 2, 5))]
    h[:, 3] = 2**64 - 1  # the value that stands for "no row"
    want = sc.window_argmin_ref(torch.from_numpy(h.view(np.int64)), L, w, 2)
    assert np.array_equal(_split_argmins(h, L, w, 2, G, R, walk), want.numpy())
    if w <= 40:
        k = 15
        hh, _, _, C, L = _chunked_hashes(_repeat_stream(6_000, w), k, w)
        sel = torch.arange(0, C, max(1, C // 6))
        want = sc.window_argmin_ref(hh, L, w, k - 1, sel).numpy()
        got = _split_argmins(u64.as_u64(hh)[:, sel.numpy()], L, w, k - 1, G, R, walk)
        assert np.array_equal(got + (sel.numpy() - np.arange(sel.shape[0])) * L, want)


@pytest.mark.parametrize("w,G,R", _SPLITS)
def test_split_emissions_match_plain(w, G, R):
    """The split with the emission step against ``window_emit_ref``: lists,
    padding and true counts, with forced and invalid windows on block and
    pass seams and a capacity that some chunks exceed."""
    rng = np.random.default_rng(7 * w + G + R)
    L = 3 * w + 5
    C = 6
    h = _ALPHABET[rng.integers(0, _ALPHABET.shape[0], size=(L + w - 1, C))]
    h[:, 4] = rng.integers(0, 2**63, size=h.shape[0], dtype=np.uint64)  # few ties: few emissions
    flags = np.ones((L, C), np.int8)
    flags[rng.integers(0, L, size=12), rng.integers(0, C, size=12)] = 0
    flags[rng.integers(0, L, size=12), rng.integers(0, C, size=12)] = 3
    flags[np.arange(0, L, w), 1] = 3         # forced on every block's first window
    flags[np.arange(w - 1, L, w), 2] = 0     # invalid on every block's last
    flags[np.arange(0, L, G * R), 5] |= 2    # forced on pass seams
    for cap in (3, L):
        want = sc.window_emit_ref(torch.from_numpy(h.view(np.int64)), torch.from_numpy(flags),
                                  L, w, 0, cap)
        pos, hsh, count = _split_emissions(h, flags, L, w, 0, cap, G, R)
        assert np.array_equal(pos, want[0].numpy())
        assert np.array_equal(hsh, u64.as_u64(want[1]))
        assert np.array_equal(count, want[2].numpy())
    assert int(count.max()) > 3


def test_split_emissions_on_a_stream():
    """The same on a stream's own hashes and flags (N runs, a homopolymer, an
    alternating stretch), against the plain version and the contract."""
    k, w = 15, 24
    h, _, flags, C, L = _chunked_hashes(_repeat_stream(12_000, 3), k, w)
    cap = sc._slot_cap(L, w)
    want = sc.window_emit_ref(h, flags, L, w, k - 1, cap)
    assert int((want[2] > cap).sum()) >= 1  # the repeats overflow
    for G, R in ((2, 8), (5, 2)):
        pos, hsh, count = _split_emissions(u64.as_u64(h), flags.numpy(), L, w, k - 1, cap, G, R)
        assert np.array_equal(pos, want[0].numpy())
        assert np.array_equal(hsh, u64.as_u64(want[1]))
        assert np.array_equal(count, want[2].numpy())


@pytest.mark.parametrize("w,tile,threads", [(10, 1, 32), (10, 4, 32), (1000, 1, 128),
                                            (1000, 4, 512), (5000, 4, 512), (20000, 1, 512),
                                            (100, 2, 32), (10, 32, 64), (1000, 32, 512)])
def test_split_threads(w, tile, threads):
    """A thread for every 8 rows and chunk, in whole warps that hold whole
    row groups, at most 512."""
    assert sc.split_threads(w, tile) == threads
    assert threads % 32 == 0 and threads % tile == 0 and threads <= sc.SPLIT_MAX_THREADS
    assert sc.split_threads(w, tile, 256) == min(threads, 256)


@pytest.mark.parametrize("C,w,gmem,argmin", [
    (32577, 1000, (8, 128), (32, 512)), (3345, 10000, (8, 128), (32, 512)),
    (499, 8363, (1, 256), (4, 512)), (209, 20000, (1, 256), (1, 512)),
    (65536, 10, (8, 32), (32, 64)), (981, 4243, (2, 128), (8, 512)),
    (500, 100_000, (1, 256), (4, 512)), (3, 1 << 25, (1, 512), (1, 512))])
def test_split_launches(C, w, gmem, argmin, monkeypatch):
    """(chunks, threads) a thread block on a card of 132 SMs: the widest tile
    that fills the card and whose passes' minima fit in shared memory."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    assert sc.gmem_launch(C, w, None) == gmem
    assert sc.argmin_launch(C, w, None) == argmin
    for tile, threads in (gmem, argmin):
        passes = -(-w // (threads // tile * sc.SPLIT_ROWS))
        assert passes == 1 or 24 * passes * tile <= 200_000
        assert threads % 32 == 0 and threads % tile == 0


def test_window_ops_refuse_windows_the_kernels_cannot_hold():
    h = torch.zeros((8, 2), dtype=torch.int64)
    for w in (0, sc.MAX_WINDOW + 1):
        with pytest.raises(ValueError):
            sc.window_argmin(h, 4, w, 0)


# -- the flag pass -------------------------------------------------------------------


def _flags_by_windows(val, L, w, off):
    """The two bits, window by window."""
    C = val.shape[1]
    out = np.zeros((L, C), np.int8)
    for c in range(C):
        before = False
        for j in range(L):
            ok = bool(val[off + j : off + j + w, c].all())
            out[j, c] = ok | ((ok and not before) << 1)
            before = ok
    return out


def _bit_len(x):
    """Bits of each uint32 up to its highest set one (0 for 0)."""
    x = x.astype(np.uint64)
    n = np.zeros(x.shape, np.int64)
    for b in range(32):
        n = np.where(x >> np.uint64(b) != 0, b + 1, n)
    return n


def _flag_summary_np(val, L, w, off):
    """The flag kernel's summary and scan (csrc/flags.cu): masks (tiles, C)
    uint32, bit r for an invalid element 32t + r; P, the last invalid
    element of tiles 0 .. t."""
    n_el, C = L + w - 1, val.shape[1]
    T = -(-n_el // 32)
    masks = np.zeros((T, C), np.uint32)
    for e in range(n_el):
        masks[e // 32] |= (val[off + e] == 0).astype(np.uint32) << np.uint32(e % 32)
    P = np.full((T, C), -1, np.int64)
    run = np.full(C, -1, np.int64)
    for t in range(T):
        run = np.maximum(run, np.where(masks[t] != 0, 32 * t + _bit_len(masks[t]) - 1, -1))
        P[t] = run
    return masks, P


def _flags_by_passes(val, L, w, off, rows):
    """The flag kernel's walk over its summary: a segment of up to ``rows``
    windows (``flag_segments``) starts from P of the tile before the one its
    first window ends in, then takes the tiles where its windows end one at
    a time: the
    window ending at row r of tile t is valid iff the last invalid element
    before the tile is below 32t + r - w + 1 and the tile's mask, smeared
    upward by min(w, 32) - 1 rows, is clear at r; bit1 compares with the
    row before, the last row of the tile before for r = 0."""
    C = val.shape[1]
    masks, P = _flag_summary_np(val, L, w, off)
    full = np.uint64(0xFFFFFFFF)
    out = np.full((L, C), -1, np.int8)
    for j0, j1 in sc.flag_segments(L, w, rows).tolist():
        e0, e1 = j0 + w - 1, j1 + w - 1
        ta, tb = e0 // 32, (e1 - 1) // 32
        carry = P[ta - 1].copy() if ta else np.full(C, -1, np.int64)
        prev = (carry < 32 * ta - w).astype(np.uint64)
        for t in range(ta, tb + 1):
            base = 32 * t
            m = masks[t].astype(np.uint64)
            k = carry - base + w
            shifted = (full << np.clip(k, 0, 31).astype(np.uint64)) & full
            ok_a = np.where(k <= 0, full, np.where(k >= 32, 0, shifted)).astype(np.uint64)
            s, cover = m.copy(), 1
            while cover < min(w, 32):
                sh = min(cover, min(w, 32) - cover)
                s = (s | (s << np.uint64(sh))) & full
                cover += sh
            ok = ok_a & ~s & full
            first = ok & ~(((ok << np.uint64(1)) & full) | prev)
            prev = ok >> np.uint64(31)
            carry = np.where(m != 0, base + _bit_len(m) - 1, carry)
            for r in range(max(e0 - base, 0), min(e1 - base, 32)):
                j = base + r - w + 1
                assert (out[j] == -1).all()  # every window written once
                out[j] = ((ok >> np.uint64(r)) & np.uint64(1)) | (
                    ((first >> np.uint64(r)) & np.uint64(1)) << np.uint64(1))
    assert (out >= 0).all()
    return out


def _flags_three_ways(val, L, w, off, rows):
    """``window_flags`` on the CPU, the kernel's passes and the two bits
    stated window by window agree, also on a pitched val whose pad columns
    hold 0s or 1s; returns the flags."""
    want = _flags_by_windows(val, L, w, off)
    with timers.recording(True):
        got = sc.window_flags(torch.from_numpy(val), L, w, off)
        counts = timers.trace_counts()["counters"]
    assert counts["launch:flags_plain"] == 1 and "launch:flags" not in counts
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_flags_by_passes(val, L, w, off, rows), want)
    for pad in (0, 1):
        vp = sc.pitched(val.shape[0], val.shape[1], torch.int8, torch.device("cpu"))
        sc._padded(vp).fill_(pad)  # whatever the pad columns hold must not reach a flag
        vp.copy_(torch.from_numpy(val))
        fp = sc.window_flags(vp, L, w, off)
        assert fp.stride(0) == vp.stride(0) and np.array_equal(fp.numpy(), want)
    return want


@pytest.mark.parametrize("w,rows,off", [(3, 1000, 4), (16, 40, 4), (16, 16, 3), (40, 100, 32),
                                        (200, 333, 8), (200, 10_000, 5)])
def test_window_flags_three_ways(w, rows, off):
    """``window_flags_ref`` against the two bits stated window by window and
    against the kernel's passes (masks of 32-row tiles, their max-scan P,
    segments of ``rows`` windows walked a tile at a time from their carry),
    on pitched and unpitched valid flags."""
    rng = np.random.default_rng(w + rows)
    L, C = 3 * w + 7, 9
    val = np.ones((off + L + w - 1 + 3, C), np.int8)
    val[rng.integers(0, val.shape[0], size=25), rng.integers(0, C - 2, size=25)] = 0
    val[:off, :] = 0                      # rows before `off` do not count
    val[off + w : off + w + 3, 1] = 0     # a run
    val[off, 2] = 0                       # the first element
    val[off + L + w - 2, 3] = 0           # the last
    val[:, C - 2] = 0
    want = _flags_three_ways(val, L, w, off, rows)
    assert want[:, C - 1].tolist() == [3] + [1] * (L - 1) and not want[:, C - 2].any()


@pytest.mark.parametrize("w,rows", [(1, 8), (31, 16), (32, 32), (33, 8), (70, 16), (100, 256)])
def test_window_flags_edges(w, rows):
    """Windows of 1 and around a tile's 32 rows, windows longer than a
    segment, an invalid element on a tile's first and on its last row, an
    offset that is not a multiple of 32, a column with every element
    invalid, and 21 columns (not a multiple of 16)."""
    rng = np.random.default_rng(7 * w + rows)
    L, C, off = 2 * w + 45, 21, 37
    n_el = L + w - 1
    val = (rng.random((off + n_el + 5, C)) > 0.02).astype(np.int8)
    val[:, 3] = 0                                  # every element invalid
    val[:, 4:8] = 1
    val[off + np.arange(0, n_el, 32), 4] = 0       # a tile's first row
    val[off + np.arange(31, n_el, 32), 5] = 0      # a tile's last row
    val[off + n_el - 1, 6] = 0                     # the last element
    val[off, 7] = 0                                # the first
    want = _flags_three_ways(val, L, w, off, rows)
    assert not want[:, 3].any()
    if w < 32:  # windows between the marked rows stay valid
        assert want[:, 4].any() and want[:, 5].any()
    assert want[L - 1, 6] == 0 and want[0, 7] == 0


@pytest.mark.parametrize("w,off", [(1, 0), (33, 37), (100, 5)])
def test_flag_summary_plain_version(w, off):
    """``flag_summary`` on the CPU (its plain version) against masks and P
    built bit by bit with numpy."""
    rng = np.random.default_rng(w)
    L, C = 3 * w + 50, 19
    val = (rng.random((off + L + w + 4, C)) > 0.05).astype(np.int8)
    val[:, 2] = 0
    val[off + 31, 5] = 0
    masks, P = sc.flag_summary(torch.from_numpy(val), L, w, off)
    want_m, want_p = _flag_summary_np(val, L, w, off)
    assert masks.dtype == P.dtype == torch.int32
    assert masks.shape == P.shape == (-(-(L + w - 1) // 32), C)
    assert np.array_equal(masks.numpy().view(np.uint32), want_m)
    assert np.array_equal(P.numpy(), want_p)


@pytest.mark.parametrize("C,L,w", [(32_577, 4_121, 1000), (6_670, 20_123, 5000),
                                   (3_345, 40_125, 10_000), (209, 80_274, 20_000)])
def test_flag_launch(C, L, w):
    """The walk's geometry on a card of 132 SMs at the chip's shapes: every
    window owned by exactly one thread, enough blocks for the card, the
    threads' rows independent of w, and a thread's masks a few tiles."""
    rows, blocks = sc.flag_launch(C, L, w)
    seg = sc.flag_segments(L, w, rows)
    groups, segs = -(-C // sc.FLAG_COLS), seg.shape[0]
    assert rows == sc.FLAG_ROWS and segs <= -(-L // rows) + 1
    assert (blocks - 1) * sc.FLAG_THREADS < groups * segs <= blocks * sc.FLAG_THREADS
    owned = np.zeros(L, np.int64)
    for j0, j1 in seg.tolist():
        assert 0 <= j0 < j1 <= L and j1 - j0 <= rows
        owned[j0:j1] += 1
    assert (owned == 1).all()
    assert blocks >= 2 * 132
    for w2 in (1, w + 999):  # as many threads whatever w
        assert abs(sc.flag_launch(C, L, w2)[1] - blocks) <= -(-groups // sc.FLAG_THREADS)
    # a segment's windows end in one tile of masks (rows = 32, tile-aligned)
    ends = seg + w - 1
    assert ((ends[:, 1] - 1) // 32 - ends[:, 0] // 32 <= max(0, rows // 32 - 1)).all()
    # masks and P: a row a tile, whole 128-byte lines of 32 columns for the
    # scan's blocks and whole 64-column groups for the summary's warps
    T, m_pitch = sc.flag_scratch(C, L, w)
    assert T * 32 >= L + w - 1 > (T - 1) * 32 and m_pitch % 128 == 0 and m_pitch >= C


def test_window_flags_refuses_misaligned_val():
    """The kernel loads 16 bytes of a row at a time: a val whose start or
    pitch is off 16 bytes is refused."""
    buf = torch.zeros(40 * 32 + 16, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16
    sc._check_flag_val(buf[base : base + 40 * 32].view(40, 32))
    with pytest.raises(ValueError, match="16-byte aligned"):
        sc._check_flag_val(buf[base + 1 : base + 1 + 40 * 32].view(40, 32))
    with pytest.raises(ValueError, match="multiple of 16"):
        sc._check_flag_val(buf[base : base + 40 * 24].view(40, 24))
    sc._check_flag_val(sc.pitched(40, 21, torch.int8, torch.device("cpu")))


def test_window_flags_refuses_short_input():
    with pytest.raises(ValueError, match="valid rows"):
        sc.window_flags(torch.ones((10, 2), dtype=torch.int8), 8, 4, 0)


class _Flags(Exception):
    """Carries the `flags` input of the JAX package's window/emission kernel."""


@pytest.mark.parametrize("k,w", [(15, 16), (32, 40)])
def test_window_flags_match_the_jax_package(k, w, monkeypatch):
    """The flags that ``_sketch_fused(multi=True)`` hands its window/emission
    kernel (raw row r: the window of k-mers ending at rows r .. r + w - 1),
    caught on their way in, against ``window_flags_ref`` on the same layout."""
    from ntjoin_tpu.ops import sketch_pallas as sp

    class Spy:
        @staticmethod
        def __wrapped__(lo, hi, scal, w, flags=None, **kw):
            raise _Flags(np.asarray(flags))

    rng = np.random.default_rng(k + w)
    stream = _joined([rng.integers(0, 4, size=ln) for ln in (9_000, 50, 7_000, w + k - 1, 30)], k)
    n = stream.shape[0]
    buf = _pallas_buffer(stream, n, k, w)
    monkeypatch.setattr(sp, "_window_emit_chunked", Spy)
    with pytest.raises(_Flags) as caught:
        sp._sketch_fused.__wrapped__(jnp.asarray(buf), n, k, w, 4096 + _CHUNKS, multi=True,
                                     interpret=True)
    jflags = caught.value.args[0]
    rows_out = jflags.shape[0]
    assert jflags.shape == (rows_out, _CHUNKS) and rows_out >= k - 1 + -(-(n - k + 1) // _CHUNKS)
    L = -(-(n - k + 1) // _CHUNKS)
    flat = np.full(_CHUNKS * L + rows_out + w, 4, dtype=np.int8)
    flat[:n] = stream
    codes = sc._chunk_view(torch.from_numpy(flat), L, _CHUNKS, rows_out + w).clone()
    codes[L + w + k - 2 :] = 4  # past a chunk's halo the JAX layout holds padding
    _, val = sc.hash_chunked_ref(codes, k)
    got = sc.window_flags_ref(val, rows_out, w, 0)
    assert np.array_equal(got.numpy(), jflags.astype(np.int8))
    assert set(np.unique(jflags)) == {0, 1, 3}
