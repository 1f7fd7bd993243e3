"""Per-assembly minimizer sketches and the cross-assembly shared index.

Array-first re-design of the reference's dict-of-dicts data model
(``list_mx_info`` / ``list_mxs`` at reference ``ntjoin.py:212-219``):

* an :class:`AssemblySketch` holds one assembly's minimizer stream as flat
  (hash, position, contig) arrays in contig-major sketch order, already
  deduplicated within the assembly (semantics of reference
  ``ntjoin_utils.read_minimizers:167-193`` — any hash occurring twice in one
  assembly is dropped entirely),
* a :class:`SharedIndex` intersects the assemblies (semantics of reference
  ``ntjoin_utils.filter_minimizers:152-165``) and assigns dense node ids to
  the surviving hashes, giving O(1) vectorized hash -> (contig, position)
  lookups per assembly — these node ids are the graph's vertex space.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


_U64 = np.uint64


def unique_only(hashes: np.ndarray, *companions: np.ndarray):
    """Keep only entries whose hash occurs exactly once, preserving order."""
    uniq, counts = np.unique(hashes, return_counts=True)
    singles = uniq[counts == 1]
    mask = np.isin(hashes, singles, assume_unique=False)
    return (hashes[mask],) + tuple(c[mask] for c in companions)


@dataclass
class AssemblySketch:
    """One assembly's deduplicated, ordered minimizer stream."""

    name: str  # assembly label (TSV path in the reference convention)
    weight: float
    contig_names: list[str]
    hash: np.ndarray  # uint64, contig-major position order
    pos: np.ndarray  # int64
    ctg: np.ndarray  # int32 contig index

    @classmethod
    def from_stream(cls, name, weight, contig_names, hashes, pos, ctg):
        hashes = np.asarray(hashes, dtype=_U64)
        pos = np.asarray(pos, dtype=np.int64)
        ctg = np.asarray(ctg, dtype=np.int32)
        h, p, c = unique_only(hashes, pos, ctg)
        return cls(name, weight, contig_names, h, p, c)


class SharedIndex:
    """Hashes shared by every assembly, with dense node ids.

    ``node_hash[i]`` is the i-th shared hash (ascending); per assembly ``a``,
    ``pos[a][i]`` / ``ctg[a][i]`` give that hash's position and contig there,
    and ``streams[a]`` is the assembly's ordered minimizer stream restricted
    to shared hashes, as (node_id, contig_index) arrays — the input to graph
    edge generation.
    """

    def __init__(self, assemblies: list[AssemblySketch]):
        self.assemblies = assemblies
        if not assemblies:
            raise ValueError("need at least one assembly")
        all_h = np.concatenate([a.hash for a in assemblies])
        uniq, counts = np.unique(all_h, return_counts=True)
        self.node_hash = uniq[counts == len(assemblies)]
        n = self.node_hash.shape[0]
        self.pos = np.zeros((len(assemblies), n), dtype=np.int64)
        self.ctg = np.zeros((len(assemblies), n), dtype=np.int32)
        self.streams: list[tuple[np.ndarray, np.ndarray]] = []
        for a, asm in enumerate(assemblies):
            mask = np.isin(asm.hash, self.node_hash, assume_unique=True)
            h = asm.hash[mask]
            ids = np.searchsorted(self.node_hash, h).astype(np.int32)
            self.pos[a, ids] = asm.pos[mask]
            self.ctg[a, ids] = asm.ctg[mask]
            self.streams.append((ids, asm.ctg[mask]))

    @property
    def num_nodes(self) -> int:
        return self.node_hash.shape[0]

    def target_extremes(self, target_idx: int) -> dict[int, tuple[int, int]]:
        """Per-target-contig (min, max) position over *shared* minimizers.

        Mirrors reference ``find_mx_min_max`` (``ntjoin_assemble.py:688-702``):
        extremes are taken over minimizers that are graph vertices.
        """
        ids, ctgs = self.streams[target_idx]
        out: dict[int, tuple[int, int]] = {}
        if ids.size == 0:
            return out
        poss = self.pos[target_idx, ids]
        nc = int(ctgs.max()) + 1
        mins = np.full(nc, np.iinfo(np.int64).max)
        maxs = np.full(nc, -1)
        np.minimum.at(mins, ctgs, poss)
        np.maximum.at(maxs, ctgs, poss)
        for c in np.flatnonzero(maxs >= 0):
            out[int(c)] = (int(mins[c]), int(maxs[c]))
        return out
