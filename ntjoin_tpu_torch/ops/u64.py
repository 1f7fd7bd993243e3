"""64-bit hash arithmetic on int64 tensors.

The ntHash2 values are unsigned 64-bit, but PyTorch on the CPU has no
``uint64`` add.  Hashes therefore live in ``int64`` tensors with the same
bits: add, multiply and xor wrap exactly as they would unsigned, unsigned
order is signed order after flipping the top bit (:func:`ult`), and every
right shift goes through :func:`lshr` because ``>>`` on ``int64`` is
arithmetic.  The counterparts on python ints are ``constants``
(``srol``, ``srol_n``, ``nte``) and ``ops.nthash_np.derive_hash``.
"""
from __future__ import annotations

import numpy as np
import torch

from ntjoin_tpu_torch.constants import MULTI_SEED, MULTI_SHIFT, ROT_HIGH_BITS, ROT_LOW_BITS

SIGN = -(1 << 63)  # int64 with only the top bit set


def s64(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 value with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def as_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits (host copy)."""
    return x.cpu().numpy().view(np.uint64)


def from_u64(x: np.ndarray) -> torch.Tensor:
    """uint64 numpy array -> int64 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint64).view(np.int64))


def lshr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift by a constant ``0 < n < 64``."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b``."""
    return (a ^ SIGN) < (b ^ SIGN)


_BIT32 = 1 << 32
_BIT33 = 1 << 33
_SROL1_KEEP = s64(0xFFFFFFFDFFFFFFFF)  # clears bit 33, where bit 63 lands
_SROR1_KEEP = s64(~((1 << 32) | (1 << 63)))


def srol1(x: torch.Tensor) -> torch.Tensor:
    """One split rotation: bits [0, 33) and [33, 64) rotate left by one."""
    return ((x << 1) & _SROL1_KEEP) | (lshr(x, 63) << 33) | (lshr(x, 32) & 1)


def sror1(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`srol1`."""
    return (
        (lshr(x, 1) & _SROR1_KEEP) | ((x & 1) << 32) | ((x & _BIT33) << 30)
    )


def srol_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` split rotations by a constant, each bit group on its own."""
    n_lo = n % ROT_LOW_BITS
    n_hi = n % ROT_HIGH_BITS
    lo = x & ((1 << ROT_LOW_BITS) - 1)
    hi = lshr(x, ROT_LOW_BITS)
    if n_lo:
        lo = ((lo << n_lo) | (lo >> (ROT_LOW_BITS - n_lo))) & ((1 << ROT_LOW_BITS) - 1)
    if n_hi:
        hi = ((hi << n_hi) | (hi >> (ROT_HIGH_BITS - n_hi))) & ((1 << ROT_HIGH_BITS) - 1)
    return (hi << ROT_LOW_BITS) | lo


def derive_hash(x: torch.Tensor, k: int, variant: int = 1) -> torch.Tensor:
    """Multi-hash variant of the canonical hash: the value a sketch emits."""
    t = x * s64(variant ^ (k * MULTI_SEED))
    return t ^ lshr(t, MULTI_SHIFT)
