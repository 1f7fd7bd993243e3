"""FASTA reading for the plain reference: whole files in memory.

Record ids are the first whitespace-separated token of the header, as
btllib's SeqReader and ``samtools faidx`` take them.
"""
from __future__ import annotations

import numpy as np

from njref.nthash_np import _CODE_LUT


def read_fasta(path: str) -> list[tuple[str, bytes]]:
    """(id, sequence bytes with line breaks removed) of each record, in
    order."""
    with open(path, "rb") as fh:
        data = fh.read()
    out = []
    for chunk in data.split(b">")[1:]:
        head, _, body = chunk.partition(b"\n")
        name = (head.split() or [b""])[0].decode()
        out.append((name, body.replace(b"\n", b"").replace(b"\r", b"")))
    return out


def encode(seq: bytes) -> np.ndarray:
    """ASCII bases -> uint8 codes (A=0 C=1 G=2 T=3, other=4)."""
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


class FastaStore:
    """Names, lengths and slices of one assembly's records, held in memory."""

    def __init__(self, records: list[tuple[str, bytes]]):
        self._seq = {name: seq.decode("ascii") for name, seq in records}

    def names(self) -> list[str]:
        return list(self._seq)

    def length(self, name: str) -> int:
        return len(self._seq[name])

    def subseq(self, name: str, start: int, end: int) -> str:
        """Bases [start, end) of a record (0-based, half-open)."""
        seq = self._seq[name]
        start = max(0, min(start, len(seq)))
        return seq[start:max(start, min(end, len(seq)))]


def reverse_complement(seq: str) -> str:
    """Reverse complement with the full IUPAC alphabet (reference
    ``ntjoin_utils.py:145-150``)."""
    return seq[::-1].translate(_RC_TABLE)


_RC_TABLE = str.maketrans(
    "ACGTUNMRWSYKVHDBacgtunmrwsykvhdb",
    "TGCAANKYWSRMBDHVtgcaankywsrmbdhv",
)
