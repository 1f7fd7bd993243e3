"""Bloom filter for repeat k-mer masking — deterministic and persistable.

Counterpart of the btllib Bloom filter the reference's ``read_minimizers``
optionally consults to drop repeat minimizers (``ntjoin_utils.py:182``): a
minimizer whose k-mer sequence is in the repeat filter is treated like a
duplicate and removed from the assembly's sketch.

Hashing uses canonical ntHash over the k-mer bytes (the same rolling-hash
family btllib BFs use), NOT Python ``hash()`` — so filters are identical
across processes/runs (PYTHONHASHSEED-independent) and a filter built once
can be saved and shared, matching btllib's file-based repeat BFs.  The
PyTorch port's copy of ``ntjoin_tpu/utils/bloom.py``.
"""
from __future__ import annotations

import io
import json

import numpy as np

from ntjoin_tpu_torch.ops.nthash_np import canonical_hashes, derive_hash, encode
from ntjoin_tpu_torch.utils.atomic import atomic_write

_MAGIC = b"NTJBF1\n"


class BloomFilter:
    def __init__(self, size_bits: int = 1 << 24, num_hashes: int = 3):
        self.size = int(size_bits)
        self.num_hashes = num_hashes
        self.bits = np.zeros((self.size + 63) // 64, dtype=np.uint64)

    def _indices(self, item: str | bytes):
        if isinstance(item, str):
            item = item.encode()
        k = len(item)
        codes = encode(item)
        # canonical ntHash of the whole k-mer (deterministic across
        # processes); multi-hash variants via the nte derivation
        base = int(canonical_hashes(codes, k)[0][0])
        for i in range(self.num_hashes):
            yield int(derive_hash(base, k, variant=i + 1)) % self.size

    def insert(self, item: str | bytes) -> None:
        for idx in self._indices(item):
            self.bits[idx >> 6] |= np.uint64(1 << (idx & 63))

    def contains(self, item: str | bytes) -> bool:
        return all(
            self.bits[idx >> 6] & np.uint64(1 << (idx & 63))
            for idx in self._indices(item)
        )

    # -- persistence (btllib repeat BFs are loaded from files) -----------

    def save(self, path: str) -> None:
        header = json.dumps(
            {"size_bits": self.size, "num_hashes": self.num_hashes}
        ).encode()
        with atomic_write(path, mode="wb") as fh:
            fh.write(_MAGIC)
            fh.write(len(header).to_bytes(4, "little"))
            fh.write(header)
            fh.write(self.bits.tobytes())

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        with open(path, "rb") as fh:
            magic = fh.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not an ntjoin-tpu Bloom filter")
            hlen = int.from_bytes(fh.read(4), "little")
            meta = json.loads(fh.read(hlen))
            bf = cls(meta["size_bits"], meta["num_hashes"])
            raw = fh.read()
        bits = np.frombuffer(raw, dtype=np.uint64)
        if bits.shape != bf.bits.shape:
            raise ValueError(f"{path}: truncated Bloom filter payload")
        bf.bits = bits.copy()
        return bf
