"""The minimizer TSV's text: the native formatter (``nj_format_minimizers``,
``emit/writers.write_minimizer_tsv``) against the port's Python formatter
and the JAX package's writer, byte for byte, and the Python formatter
where the library is absent, counted by ``tsv_fallback_records``."""
import numpy as np
import pytest

from ntjoin_tpu_torch.emit import writers
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.ops.nthash_np import Sketch, sketch_seq
from ntjoin_tpu_torch.utils import timers

K = 12
TOP = 2**64 - 1


def _seq(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Records with lowercase runs, an N run, an empty sketch and a long
    one; their sketches, some hand-made (hashes 0 and 2^64-1, position
    0, a k-mer that ends the record)."""
    rng = np.random.default_rng(5)
    long = _seq(rng, 40_000)
    recs = {
        "first desc": _seq(rng, 300),
        "lower": _seq(rng, 100) + _seq(rng, 200).lower() + _seq(rng, 100),
        "none": _seq(rng, 500),
        "gapped": _seq(rng, 400) + "N" * 50 + _seq(rng, 400),
        "long": long,
        "tiny": "ACG",
    }
    path = tmp_path_factory.mktemp("tsv") / "a.fa"
    path.write_text("".join(f">{name}\n{seq}\n" for name, seq in recs.items()))
    names = [name.split()[0] for name in recs]
    seqs = list(recs.values())
    sk = [sketch_seq(s, K, 20) for s in seqs]
    sk[0] = Sketch(positions=np.array([0, 5, 300 - K], dtype=np.int64),
                   hashes=np.array([0, TOP, 12345], dtype=np.uint64))
    sk[2] = Sketch(positions=np.empty(0, np.int64), hashes=np.empty(0, np.uint64))
    assert len(sk[4].positions) > 1000 and len(sk[1].positions) > 10
    assert len(sk[5].positions) == 0
    return str(path), names, seqs, sk


def _native(out, path, sketches, with_seq):
    with native.FastaSource(path) as src:
        writers.write_minimizer_tsv(str(out), src, sketches, K, with_seq=with_seq)
    return out.read_bytes()


def _python(out, path, sketches, with_seq):
    with native.FastaSource(path) as src:
        writers._write_minimizer_tsv_py(str(out), src, sketches, K, with_seq)
    return out.read_bytes()


def _jax(out, path, sketches, with_seq):
    from ntjoin_tpu.emit.writers import write_minimizer_tsv
    from ntjoin_tpu.io.fasta import read_fasta

    write_minimizer_tsv(str(out), read_fasta(path), sketches, K, with_seq=with_seq)
    return out.read_bytes()


@pytest.fixture
def library():
    if not native.available():
        pytest.skip("no g++ to build the native library")


@pytest.mark.parametrize("with_seq", [True, False])
@pytest.mark.parametrize("chunk", [writers.TSV_CHUNK, 700, 1])
def test_native_text_is_python_and_jax_text(fasta, tmp_path, monkeypatch, library,
                                            with_seq, chunk):
    """Byte for byte, with chunks that end inside records' lines (and a
    chunk smaller than any line)."""
    path, names, seqs, sk = fasta
    monkeypatch.setattr(writers, "TSV_CHUNK", chunk)
    got = _native(tmp_path / "n.tsv", path, sk, with_seq)
    assert got == _python(tmp_path / "p.tsv", path, sk, with_seq)
    assert got == _jax(tmp_path / "j.tsv", path, sk, with_seq)
    lines = got.decode().split("\n")
    kmer = f":{seqs[0][:K]}" if with_seq else ""
    assert lines[0].startswith(f"first\t0:0{kmer} {TOP}:5")
    assert lines[2] == "none\t" and lines[5] == "tiny\t" and lines[6] == ""
    assert any(c.islower() for c in lines[1].split("\t")[1]) == with_seq


def test_the_python_formatter_serves_without_the_library(fasta, tmp_path, monkeypatch,
                                                         library):
    """No library: the same bytes, and ``tsv_fallback_records`` counts
    every record the Python formatter wrote; 0 with the library."""
    path, names, _, sk = fasta
    with timers.recording(True):
        want = _native(tmp_path / "n.tsv", path, sk, True)
        assert timers.COUNTERS["tsv_fallback_records"] == 0
        monkeypatch.setattr(native, "_load", lambda: None)
        got = _native(tmp_path / "p.tsv", path, sk, True)
        assert timers.COUNTERS["tsv_fallback_records"] == len(names)
        _native(tmp_path / "p2.tsv", path, sk, False)
        assert timers.COUNTERS["tsv_fallback_records"] == 2 * len(names)
    assert got == want


def test_a_kmer_outside_its_record_is_refused(fasta, tmp_path, library):
    path, _, _, sk = fasta
    bad = list(sk)
    bad[5] = Sketch(positions=np.array([0], dtype=np.int64), hashes=np.array([1], np.uint64))
    with pytest.raises(ValueError, match="tiny"):
        _native(tmp_path / "bad.tsv", path, bad, True)
    assert not (tmp_path / "bad.tsv").exists()
