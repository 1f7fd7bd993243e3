"""Host (NumPy) closed-form minimizer sketch — the bit-exactness oracle.

This is NOT a rolling-hash loop.  The ntHash2 recurrence
``h_{i+1} = srol(h_i) ^ seed[s_{i+1}]`` is linearised: ``srol`` is a bit
permutation, so the hash of the k-mer starting at position ``p`` has the
closed form

    fwd(p) = srol^{p+k-1}( P[p+k] ^ P[p] ),     P = prefix-xor of srol^{-i}(seed[s_i])
    rev(p) = srol^{-p}   ( Q[p+k] ^ Q[p] ),     Q = prefix-xor of srol^{+i}(seed[rc(s_i)])

which turns the whole-genome sketch into two parallel prefix-xor scans plus
elementwise variable-distance rotations — the same dataflow the TPU kernels
use (see ``ops/sketch_jax.py``).  This module keeps everything in native
uint64 NumPy and serves as the differential-testing oracle for the device
paths.

Semantics replicated from btllib's ``indexlr`` (invoked by the reference at
``ntJoin:204-205``; TSV contract parsed at reference ``ntjoin_utils.py:173-185``):

* canonical hash = (forward + reverse-complement) mod 2^64 per k-mer
  (the ntHash2 strand-neutral combiner; a legacy ``min`` mode reproduces the
  older golden TSV artifacts),
* k-mers containing a non-ACGT base are skipped entirely (the window slides
  over the surviving k-mers, not over genomic positions),
* a record yields no minimizers when ``k > len`` or ``w > len - k + 1`` or
  fewer than ``w`` valid k-mers exist,
* each length-w window contributes its leftmost minimal k-mer (ties by
  position); consecutive windows with the same argmin emit once,
* the emitted value is multi-hash variant 1, ``nte(canonical, k, 1)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from njref.constants import (
    CODE_INVALID,
    MULTI_SEED,
    MULTI_SHIFT,
    ROT_HIGH_BITS,
    ROT_LOW_BITS,
    SEEDS,
    SROL_PERIOD,
    srol_n,
)

_U64 = np.uint64
_MASK_LOW = _U64((1 << ROT_LOW_BITS) - 1)
_MASK_HIGH = _U64((1 << ROT_HIGH_BITS) - 1)
_MAXU64 = _U64(0xFFFFFFFFFFFFFFFF)

# Base-code lookup for ASCII bytes: ACGT (either case) -> 0..3, rest -> 4.
_CODE_LUT = np.full(256, CODE_INVALID, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase

# srol^e(seed[c]) for e in [0, SROL_PERIOD), c in {A,C,G,T,invalid}.
# The invalid column is 0 so gathers never fault; validity is masked apart.
_SROL_SEED = np.zeros((SROL_PERIOD, 5), dtype=_U64)
for _e in range(SROL_PERIOD):
    for _c in range(4):
        _SROL_SEED[_e, _c] = _U64(srol_n(SEEDS[_c], _e))


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (A=0 C=1 G=2 T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[raw]


def _srol_var(x: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Elementwise srol^n(x) for uint64 x and per-element exponents n >= 0.

    n must already be uint64: numpy's signed modulo is ~30x slower than the
    unsigned one, so all exponent arithmetic stays unsigned.
    """
    n_low = n % _U64(ROT_LOW_BITS)
    n_high = n % _U64(ROT_HIGH_BITS)
    low = x & _MASK_LOW
    high = x >> _U64(ROT_LOW_BITS)
    low = ((low << n_low) | (low >> (_U64(ROT_LOW_BITS) - n_low))) & _MASK_LOW
    high = ((high << n_high) | (high >> (_U64(ROT_HIGH_BITS) - n_high))) & _MASK_HIGH
    return (high << _U64(ROT_LOW_BITS)) | low


def canonical_hashes(
    codes: np.ndarray, k: int, canonical: str = "add"
) -> tuple[np.ndarray, np.ndarray]:
    """Canonical ntHash2 for every k-mer start position.

    ``canonical`` picks the strand-symmetric combiner: ``"add"`` is
    ``(forward + reverse) mod 2^64`` — the current ntHash2/btllib definition
    the reference test expectations bind (verified against the w=500 cut
    coordinates in reference ``tests/ntjoin_test.py:128-150``); ``"min"`` is
    the legacy ``min(forward, reverse)`` that produced the golden TSVs under
    ``tests/expected_outputs``.

    Returns ``(hashes, valid)`` of length ``len(codes) - k + 1``; ``valid`` is
    False where the k-mer window touches a non-ACGT base (such positions carry
    an unspecified hash value).
    """
    n = codes.shape[0]
    if n < k:
        return np.empty(0, dtype=_U64), np.empty(0, dtype=bool)
    # unsigned exponent arithmetic throughout (signed % is very slow)
    period = _U64(SROL_PERIOD)
    idx_u = np.arange(n, dtype=_U64)
    exp_rev = idx_u % period
    exp_fwd = (period - exp_rev) % period

    codes_i = codes.astype(np.intp)
    rc = np.where(codes_i < 4, 3 - codes_i, 4)
    flat = _SROL_SEED.ravel()
    s_fwd = flat[exp_fwd.astype(np.intp) * 5 + codes_i]
    s_rev = flat[exp_rev.astype(np.intp) * 5 + rc]

    p = np.zeros(n + 1, dtype=_U64)
    np.bitwise_xor.accumulate(s_fwd, out=p[1:])
    q = np.zeros(n + 1, dtype=_U64)
    np.bitwise_xor.accumulate(s_rev, out=q[1:])

    nk = n - k + 1
    starts = np.arange(nk, dtype=np.int64)
    starts_u = np.arange(nk, dtype=_U64)
    e_fwd = (starts_u + _U64(k - 1)) % period
    e_rev = (period - (starts_u % period)) % period
    fwd = _srol_var(p[starts + k] ^ p[starts], e_fwd)
    rev = _srol_var(q[starts + k] ^ q[starts], e_rev)
    canon = fwd + rev if canonical == "add" else np.minimum(fwd, rev)

    bad = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(codes >= CODE_INVALID, out=bad[1:])
    valid = (bad[starts + k] - bad[starts]) == 0
    return canon, valid


def derive_hash(base: np.ndarray | int, k: int, variant: int = 1):
    """Multi-hash variant of the canonical base hash (the emitted value)."""
    mult = _U64((variant ^ (k * MULTI_SEED)) & 0xFFFFFFFFFFFFFFFF)
    t = np.asarray(base, dtype=_U64) * mult
    return t ^ (t >> _U64(MULTI_SHIFT))


def _window_lexmin(h: np.ndarray, w: int) -> np.ndarray:
    """Leftmost argmin of every length-w window of ``h``.

    Block two-scan formulation: split into blocks of w, compute running
    (value, leftmost-index) minima left-to-right and right-to-left inside each
    block, then each window is the combine of one suffix and one prefix part.
    Returns the argmin index per window (length ``len(h) - w + 1``).
    """
    n = h.shape[0]
    nw = n - w + 1
    nb = -(-n // w)
    pad = nb * w - n
    hp = np.concatenate([h, np.full(pad, _MAXU64)]) if pad else h
    hb = hp.reshape(nb, w)

    # Prefix: argmin updates only on strict decrease -> leftmost tie kept.
    pre_min = np.minimum.accumulate(hb, axis=1)
    upd = np.empty((nb, w), dtype=bool)
    upd[:, 0] = True
    upd[:, 1:] = pre_min[:, 1:] != pre_min[:, :-1]
    col = np.broadcast_to(np.arange(w, dtype=np.int64), (nb, w))
    pre_arg = np.maximum.accumulate(np.where(upd, col, -1), axis=1)

    # Suffix: scan reversed rows; update on ties too so the smallest original
    # index (scanned last) wins.
    hr = hb[:, ::-1]
    suf_min_r = np.minimum.accumulate(hr, axis=1)
    upd_r = hr == suf_min_r
    suf_arg_r = np.maximum.accumulate(np.where(upd_r, col, -1), axis=1)

    i_u = np.arange(nw, dtype=_U64)
    w_u = _U64(w)
    b_lo = (i_u // w_u).astype(np.int64)
    j_lo = np.arange(nw, dtype=np.int64) - b_lo * w
    hi_u = i_u + _U64(w - 1)
    b_hi = (hi_u // w_u).astype(np.int64)
    j_hi = hi_u.astype(np.int64) - b_hi * w

    suf_val = suf_min_r[b_lo, w - 1 - j_lo]
    suf_pos = b_lo * w + (w - 1 - suf_arg_r[b_lo, w - 1 - j_lo])
    pre_val = pre_min[b_hi, j_hi]
    pre_pos = b_hi * w + pre_arg[b_hi, j_hi]

    take_suf = (suf_val < pre_val) | ((suf_val == pre_val) & (suf_pos <= pre_pos))
    return np.where(take_suf, suf_pos, pre_pos)


@dataclass(frozen=True)
class Sketch:
    """Ordered minimizer sketch of one sequence record."""

    positions: np.ndarray  # int64 genomic start positions
    hashes: np.ndarray  # uint64 emitted hash values (variant 1)


def sketch_codes(
    codes: np.ndarray, k: int, w: int, canonical: str = "add"
) -> Sketch:
    """Ordered minimizer sketch of an encoded sequence (oracle path)."""
    empty = Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=_U64))
    n = codes.shape[0]
    if k > n or w > n - k + 1:
        return empty
    canon, valid = canonical_hashes(codes, k, canonical)
    vpos = np.flatnonzero(valid)
    if vpos.shape[0] < w:
        return empty
    vh = canon[vpos]
    arg = _window_lexmin(vh, w)
    keep = np.empty(arg.shape[0], dtype=bool)
    keep[0] = True
    keep[1:] = arg[1:] != arg[:-1]
    sel = arg[keep]
    return Sketch(positions=vpos[sel], hashes=derive_hash(vh[sel], k))


def sketch_seq(seq: str | bytes, k: int, w: int, canonical: str = "add") -> Sketch:
    """Ordered minimizer sketch of an ASCII sequence."""
    return sketch_codes(encode(seq), k, w, canonical)
