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
from ntjoin_tpu_torch.ops import u64

# few distinct values (many ties), some with the top bit set (unsigned order)
_ALPHABET = np.array([3, 7, 2**63, 2**63 + 1, 2**64 - 2, 5], dtype=np.uint64)


@pytest.mark.parametrize("w", [16, 12])  # w % 8 == 0 takes the sublane-tiled kernel
def test_window_argmin_matches_pallas(w):
    rng = np.random.default_rng(w)
    L = 3 * w
    n_el = L + w - 1
    h = _ALPHABET[rng.integers(0, _ALPHABET.shape[0], size=(n_el, _CHUNKS))]
    sc.reset_counts()
    am = sc.window_argmin(torch.from_numpy(h.view(np.int64)), L, w, 0)
    assert sc.COUNTS["window_plain"] == 1 and sc.COUNTS["window"] == 0
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
    sc.reset_counts()
    pos, canon = _port_stream(codes, n, k, w)
    jpos, jcanon = _pallas_stream(_pallas_buffer(codes, n, k, w), n, k, w)
    assert pos.tolist() == jpos.tolist()
    assert canon.tolist() == jcanon.tolist()
    ref = sketch_codes(codes.view(np.uint8), k, w)
    assert pos.tolist() == ref.positions.tolist()
    assert derive_hash(canon, k).tolist() == ref.hashes.tolist()
    assert sc.COUNTS["window_emit_plain"] == 1 and sc.COUNTS["exact_runs"] == 0


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
    sc.reset_counts()
    pos, canon = _port_stream(codes.view(np.int8), n, k, w)
    assert sc.COUNTS["exact_runs"] == 1 and sc.COUNTS["window_plain"] == 1
    jpos, jcanon = _pallas_stream(_pallas_buffer(codes.view(np.int8), n, k, w), n, k, w)
    assert pos.tolist() == jpos.tolist() and canon.tolist() == jcanon.tolist()
    ref = sketch_codes(codes, k, w)
    assert pos.tolist() == ref.positions.tolist()
    # runs inside and at the edges of records of a batch
    recs = [codes[:30_000], codes[30_000:], codes[4_990:5_230]]
    for rec, got in zip(recs, sc.sketch_records_torch(recs, k, w, "cpu")):
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
    sc.reset_counts()
    got = sc.sketch_codes_torch(codes, k, w, "cpu")
    assert sc.COUNTS["exact_runs"] == 1
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
    sc.reset_counts()
    pos, canon = _port_stream(codes, n, k, w, slot_cap=slot_cap)
    assert sc.COUNTS["exact_runs"] == 1 and sc.COUNTS["window_plain"] == 1
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
    sc.reset_counts()
    pos, canon = _port_stream(stream, n, k, w)
    assert sc.COUNTS["window_emit_plain"] == 1 and sc.COUNTS["exact_runs"] == 0
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
