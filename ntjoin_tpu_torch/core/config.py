"""Run configuration for the scaffolding engine.

Mirrors the parameter surface of the reference pipeline: the Make variable
tier (reference ``ntJoin:33-87``) and the argparse tier
(``ntjoin_run.py:17-53``), folded into one dataclass.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ScaffoldConfig:
    """All knobs of a scaffolding run (defaults = reference defaults)."""

    # Inputs: reference minimizer TSVs (or FASTAs) and their weights.
    references: list[str] = field(default_factory=list)  # TSV paths (FILES)
    target: str = ""  # target minimizer TSV path (-s)
    target_weight: float = 1.0  # -l
    reference_weights: list[float] = field(default_factory=list)  # -r

    prefix: str = "out"  # -p
    n: int = 1  # minimum edge weight
    k: int = 32  # sketch k-mer size
    w: int = 1000  # sketch window size (only used when sketching from FASTA)
    g: int = 20  # minimum gap size
    G: int = 0  # maximum gap size (0 = unbounded)
    mkt: bool = False  # Mann-Kendall orientation
    m: int = 90  # % monotone pairs required for orientation vote
    t: int = 1  # worker parallelism for path finding
    agp: bool = False
    no_cut: bool = False
    overlap: bool = False
    overlap_gap: int = 20
    overlap_k: int = 15
    overlap_w: int = 10
    btllib_t: int = 4  # accepted for CLI parity; reader threads are internal

    # Framework extensions (no reference counterpart)
    keep_segments_fa: bool = False  # write the masked overlap segments to <prefix>.segments.fa
    write_dot: bool = True  # emit the .mx.dot graph artifact
    verbose: bool = True
    # "device" (the default) = torch shared-index + edge tally
    # (ops/device_index.py), components and path passes on the Scaffolder's
    # device; "host" = NumPy filters/graph, the explicit opt-in.  Byte-equal
    # by construction.
    index_backend: str = "device"

    def validate(self) -> None:
        if not self.target:
            raise ValueError("target minimizer TSV (-s) is required")
        if not self.references:
            raise ValueError("at least one reference TSV is required")
        if len(self.reference_weights) != len(self.references):
            raise ValueError(
                "ERROR: The length of supplied reference weights (-r) and "
                "number of assembly minimizer TSV inputs must be equal."
            )
