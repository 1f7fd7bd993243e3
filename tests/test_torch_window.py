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
