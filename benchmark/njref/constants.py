"""Hash constants for the ntHash2 rolling-hash family.

These constants define the minimizer-identity contract of the framework: the
values emitted by the sketch stage must be bit-identical to the ones produced
by btllib's ``indexlr`` tool (the sketcher the reference pipeline shells out
to; see reference ``ntJoin:204-205``), because downstream graph node identity,
DOT dumps and overlap-trim tie-breaking are all keyed on them (reference
``ntjoin_utils.py:167-193``, ``ntjoin_overlap.py:78-79``).

Verified against the golden sketch artifacts shipped with the reference test
suite (``tests/expected_outputs/ref.fa.k32.w1000.tsv``):

* per-base seeds are the classic ntHash seeds,
* one base step applies the ntHash2 "split rotation" (33-bit low group and
  31-bit high group rotate independently),
* the canonical k-mer hash is ``(forward + reverse-complement) mod 2^64``
  (current btllib/ntHash2; pinned by the w=500 cut coordinates asserted in
  the reference's pytest suite) — the golden TSV artifacts predate this and
  used ``min(forward, reverse)``, kept as a legacy mode,
* minimizer *selection* compares canonical hashes,
* the *emitted* hash is the second multi-hash variant
  ``nte(canonical, k, 1)``.
"""

# Per-base 64-bit seeds (A, C, G, T). Index by 2-bit base code.
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T)

# Multi-hash derivation constants (hash variant i = nte(base, k, i)).
MULTI_SEED = 0x90B45D39FB6DA1FA
MULTI_SHIFT = 27

# Split-rotation group sizes: bits [0, 33) and [33, 64) rotate independently.
ROT_LOW_BITS = 33
ROT_HIGH_BITS = 31
# srol has period lcm(33, 31); exponents can be reduced mod this.
SROL_PERIOD = ROT_LOW_BITS * ROT_HIGH_BITS  # 1023

# Base encoding used throughout the framework: A=0 C=1 G=2 T=3, anything
# else (N, IUPAC ambiguity codes, gaps) = CODE_INVALID.  The reverse
# complement of a valid code c is 3 - c.
CODE_INVALID = 4


def srol_n(x: int, n: int) -> int:
    """n split rotations via independent group rotations (python ints)."""
    n_low = n % ROT_LOW_BITS
    n_high = n % ROT_HIGH_BITS
    low = x & ((1 << ROT_LOW_BITS) - 1)
    high = x >> ROT_LOW_BITS
    low = ((low << n_low) | (low >> (ROT_LOW_BITS - n_low))) & ((1 << ROT_LOW_BITS) - 1)
    high = ((high << n_high) | (high >> (ROT_HIGH_BITS - n_high))) & ((1 << ROT_HIGH_BITS) - 1)
    return (high << ROT_LOW_BITS) | low
