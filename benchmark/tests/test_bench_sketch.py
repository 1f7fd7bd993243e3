"""The reference's torch sketch is the NumPy closed form's (``nthash_np``,
a frozen copy of the port's oracle) on records with N runs, edges and
several (k, w); on the card too where there is one."""
import numpy as np
import pytest

from njref.nthash_np import encode, sketch_codes
from njref.sketch import sketch_records


def _records(seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(30):
        n = int(rng.integers(1, 5000))
        s = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=n)
        if i % 3 == 0 and n > 60:
            a = int(rng.integers(0, n - 50))
            s[a:a + int(rng.integers(1, 50))] = ord("N")
        recs.append(s.tobytes())
    return recs + [b"", b"NNNN", b"ACGT" * 300]


def _same(recs, k, w, device):
    got = sketch_records(recs, k, w, device)
    for rec, (pos, h) in zip(recs, got):
        want = sketch_codes(encode(rec), k, w)
        assert np.array_equal(want.positions, pos) and np.array_equal(want.hashes, h)


@pytest.mark.parametrize("k,w", [(32, 1000), (32, 100), (15, 10), (5, 1), (32, 3)])
def test_matches_closed_form(k, w):
    _same(_records(k * 7 + w), k, w, "cpu")


def test_blocks_split_records(monkeypatch):
    import njref.sketch as sk

    monkeypatch.setattr(sk, "BLOCK_BASES", 3000)
    _same(_records(3), 32, 100, "cpu")


def test_control_changes_the_sketch():
    recs = _records(4)
    a = sketch_records(recs, 32, 100)
    b = sketch_records(recs, 32, 100, hash_bits=32)
    assert any(not np.array_equal(x[1], y[1]) for x, y in zip(a, b))


@pytest.mark.chip
def test_matches_closed_form_on_card(cuda):
    _same(_records(9), 32, 1000, cuda)
