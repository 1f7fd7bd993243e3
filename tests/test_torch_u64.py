"""int64 hash helpers of the port against the python-int definitions, and
the seed tables and chunk-layout converters against the JAX package."""
import numpy as np
import pytest
import torch

from ntjoin_tpu.constants import nte, srol, srol_n
from ntjoin_tpu.ops.nthash_np import derive_hash
from ntjoin_tpu.ops.sketch_pallas import _tables
from ntjoin_tpu_torch.ops import u64
from ntjoin_tpu_torch.ops.sketch_cuda import from_jax_chunks, seed_tables, to_jax_chunks

RNG = np.random.default_rng(5)
EDGES = [0, 1, 2**32 - 1, 2**32, 2**33, 2**63 - 1, 2**63, 2**64 - 1]
VALS = np.concatenate([
    np.array(EDGES, dtype=np.uint64),
    RNG.integers(0, 2**64 - 1, size=120, dtype=np.uint64, endpoint=True),
])
OTHER = RNG.integers(0, 2**64 - 1, size=VALS.shape[0], dtype=np.uint64, endpoint=True)


def _py(f, vals=VALS):
    return np.array([f(int(v)) for v in vals], dtype=np.uint64)


def test_bits_roundtrip_and_wrapping_arithmetic():
    a, b = u64.from_u64(VALS), u64.from_u64(OTHER)
    assert (u64.as_u64(a) == VALS).all()
    assert (u64.as_u64(a + b) == VALS + OTHER).all()  # wraps mod 2^64
    assert (u64.as_u64(a ^ b) == (VALS ^ OTHER)).all()
    assert (u64.ult(a, b).numpy() == (VALS < OTHER)).all()
    assert not u64.ult(a, a).any()
    assert u64.s64(2**64 - 1) == -1 and u64.s64(2**63) == u64.SIGN


@pytest.mark.parametrize("n", [1, 5, 27, 32, 63])
def test_lshr_is_logical(n):
    got = u64.as_u64(u64.lshr(u64.from_u64(VALS), n))
    assert (got == (VALS >> np.uint64(n))).all()


def test_srol1_sror1():
    x = u64.from_u64(VALS)
    assert (u64.as_u64(u64.srol1(x)) == _py(srol)).all()
    assert (u64.as_u64(u64.sror1(u64.srol1(x))) == VALS).all()
    assert (u64.as_u64(u64.srol1(u64.sror1(x))) == VALS).all()


@pytest.mark.parametrize("n", [0, 1, 7, 31, 32, 33, 62, 64, 1022])
def test_srol_n(n):
    got = u64.as_u64(u64.srol_n(u64.from_u64(VALS), n))
    assert (got == _py(lambda v: srol_n(v, n))).all()


@pytest.mark.parametrize("k", [15, 32])
def test_derive_hash(k):
    got = u64.as_u64(u64.derive_hash(u64.from_u64(VALS), k))
    assert (got == _py(lambda v: nte(v, k, 1))).all()
    assert (got == derive_hash(VALS, k)).all()


@pytest.mark.parametrize("k", [8, 15, 32])
def test_seed_tables_match_pallas_tables(k):
    got = seed_tables(k).view(np.uint64)
    for row, tab in zip(got, _tables(k)):
        want = [int(lo) | (int(hi) << 32) for lo, hi in tab]
        assert row.tolist() == want


def test_jax_chunk_layout_roundtrip():
    lo = RNG.integers(0, 2**32, size=(4, 16, 128), dtype=np.uint64).astype(np.uint32)
    hi = RNG.integers(0, 2**32, size=(4, 16, 128), dtype=np.uint64).astype(np.uint32)
    x = from_jax_chunks(lo, hi)
    assert x.dtype == torch.int64 and tuple(x.shape) == (4, 2048)
    want = lo.astype(np.uint64).reshape(4, -1) | (hi.astype(np.uint64).reshape(4, -1) << np.uint64(32))
    assert (u64.as_u64(x) == want).all()
    lo2, hi2 = to_jax_chunks(x)
    assert (lo2 == lo).all() and (hi2 == hi).all()
