"""The port's streamed sketch stage (``io/native.py`` ``FastaSource``,
``ops/sketch_records.py`` fed by a source, ``cli._ensure_sketch``) against
the JAX package: each record's codes against ``nthash_np.encode`` of the
JAX reader's record, the sketch stage's TSV and ``AssemblySketch`` byte for
byte against ``ntjoin_tpu.cli._ensure_sketch``, the batches against
``_batches``, the code bytes held against one batch, and the Python
heap of the stage under ``tracemalloc``, and the ``.fai`` the reader's
rows give against ``write_fai`` of both packages on awkward files."""
import gzip
import shutil
import tracemalloc

import numpy as np
import pytest
import torch

from ntjoin_tpu import cli as jax_cli
from ntjoin_tpu.io import native as jax_native
from ntjoin_tpu.io.fasta import read_fasta as jax_read_fasta
from ntjoin_tpu.io.fasta import write_fai as jax_write_fai
from ntjoin_tpu.ops import nthash_np as jax_np
from ntjoin_tpu.utils.timers import StageTimers as JaxTimers
from ntjoin_tpu_torch import cli
from ntjoin_tpu_torch.io import native
from ntjoin_tpu_torch.io.fasta import write_fai
from ntjoin_tpu_torch.ops import sketch_records as sr
from ntjoin_tpu_torch.utils.timers import StageTimers
from ntjoin_tpu_torch.utils import timers

K, W = 32, 100
_IUPAC = np.frombuffer(b"RYKMSWBDHVN", dtype=np.uint8)
_UPPER = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_records(rng, n_records: int, lo: int, hi: int) -> list[np.ndarray]:
    """ASCII records: mixed case, N runs, single IUPAC letters, an empty
    record."""
    recs = []
    for i in range(n_records):
        s = _UPPER[rng.integers(0, 4, size=int(rng.integers(lo, hi)))]
        if i % 3 == 1:
            for a in rng.integers(0, max(1, s.shape[0] - 400), size=3):
                s[a : a + int(rng.integers(1, 400))] = ord("N")
        if i % 4 == 2:
            s[rng.integers(0, s.shape[0], size=5)] = _IUPAC[rng.integers(0, 11, size=5)]
        if i % 5 == 3:
            a = int(rng.integers(0, s.shape[0] // 2))
            s[a : a + s.shape[0] // 3] += 32  # lowercase
        recs.append(s)
    recs.insert(n_records // 2, np.empty(0, dtype=np.uint8))
    return recs


def _write_fasta(path, recs: list[np.ndarray], width: int) -> None:
    """FASTA lines of ``width`` bases (0: one line a record); every third
    header carries metadata after the id."""
    out = []
    for i, s in enumerate(recs):
        out.append(f">rec{i}" + (" len=%d some metadata" % s.shape[0] if i % 3 == 0 else ""))
        body = s.tobytes().decode()
        step = width or max(1, len(body))
        out.extend(body[a : a + step] for a in range(0, len(body), step))
    data = ("\n".join(out) + "\n").encode()
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("width", [0, 1, 60, 80])
@pytest.mark.parametrize("reader", ["native", "python", "gz"])
def test_codes_into_is_the_jax_encode(tmp_path, monkeypatch, reader, width):
    """``codes_into`` (into int8 and uint8 views), ``codes``, ``seq``,
    ``view``, names and lengths against the JAX reader's records and
    ``nthash_np.encode``; the native reader, the Python fallback and the
    gzip path."""
    if reader == "native" and not native.available():
        pytest.skip("no g++ to build the native library")
    rng = np.random.default_rng(20 + width)
    recs = _random_records(rng, 12, 1, 3000)
    fa = tmp_path / ("x.fa.gz" if reader == "gz" else "x.fa")
    _write_fasta(fa, recs, width)
    want = jax_read_fasta(str(fa))
    if reader == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    with native.FastaSource(str(fa)) as src:
        assert (src._h is not None) == (reader == "native")
        assert src.names == [r.id for r in want] and len(src) == len(want) == len(recs)
        assert src.lengths.dtype == np.int64
        assert src.lengths.tolist() == [len(r.seq) for r in want]
        buf = torch.full((int(src.lengths.sum()) + 7,), 9, dtype=torch.int8).numpy()
        off = 0
        for i, rec in enumerate(want):
            codes = jax_np.encode(rec.seq)
            n = codes.shape[0]
            src.codes_into(i, buf[off : off + n])
            assert buf[off : off + n].view(np.uint8).tolist() == codes.tolist()
            assert src.codes(i).dtype == np.uint8 and src.codes(i).tolist() == codes.tolist()
            assert src.seq(i) == rec.seq
            assert src.view(i).tobytes() == rec.seq.encode()
            assert src.clean(i) == (n == 0 or int(codes.max()) < 4)
            assert src.clean(i, np.empty(7, dtype=np.uint8)) == src.clean(i)
            off += n
        assert buf[off:].tolist() == [9] * 7  # nothing written past the records
        with pytest.raises(ValueError, match="contiguous 1-byte buffer"):
            src.codes_into(0, np.empty(len(want[0].seq) + 1, dtype=np.uint8))
    if reader == "native":
        with pytest.raises(ValueError, match="closed"):
            src.codes(0)


def _stage_assembly(rng) -> list[np.ndarray]:
    """~0.5 Mbp: records of 2-20 kbp, a third with N runs, one N-free record
    and one with N runs between the two paths' patched bounds."""
    recs = _random_records(rng, 40, 2_000, 20_000)
    long_clean = _UPPER[rng.integers(0, 4, size=42_000)]
    long_gapped = _UPPER[rng.integers(0, 4, size=45_000)]
    long_gapped[20_000:20_300] = ord("N")
    return recs[:10] + [long_gapped] + recs[10:25] + [long_clean] + recs[25:]


# the fused path takes records up to 50,000 bases, the general path up to
# 40,000: the 45 kbp gapped record goes to the host, the 42 kbp clean one
# to the card after its path is probed
_BOUNDS = {False: 50_000, True: 40_000}


def _patch_batches(monkeypatch, bases: int = 60_000) -> None:
    monkeypatch.setattr(sr, "BATCH_BASES", bases)
    monkeypatch.setattr(sr, "record_bound", lambda device, general=False: _BOUNDS[general])


@pytest.mark.parametrize("backend,reader", [("torch", "native"), ("torch", "python"),
                                            ("native", "native"), ("numpy", "native"),
                                            ("numpy", "python")])
def test_sketch_stage_matches_jax_cli(tmp_path, monkeypatch, backend, reader):
    """The port's ``_ensure_sketch`` (each path in several batches, one
    host record; the native reader or the Python one) writes the TSV of
    ``ntjoin_tpu.cli._ensure_sketch`` byte for byte and returns the same
    ``AssemblySketch``."""
    if reader == "native" and not native.available():
        pytest.skip("no g++ to build the native library")
    recs = _stage_assembly(np.random.default_rng(5))
    _patch_batches(monkeypatch)
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    _write_fasta(port / "a.fa", recs, 70)
    shutil.copy(port / "a.fa", ref / "a.fa")
    sketch = cli._sketcher(backend, "cpu")
    if reader == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    with timers.recording(True):
        tsv, got = cli._ensure_sketch(str(port / "a.fa"), K, W, True, sketch, StageTimers())
        counts = timers.trace_counts()["counters"]
    if backend == "torch":
        assert counts["sketch_route:host_records"] == 1
        assert counts["sketch_route:general_records"] > 5
        assert counts["sketch_route:general_batches"] >= 2 and counts["launch:hash_plain"] >= 4
    jtsv, want = jax_cli._ensure_sketch(str(ref / "a.fa"), K, W, True, jax_np.sketch_codes,
                                        JaxTimers())
    assert open(tsv, "rb").read() == open(jtsv, "rb").read()
    assert got.contig_names == want.contig_names and len(got.contig_names) == len(recs)
    for name in ("hash", "pos", "ctg"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.hash.shape[0] > 1000
    assert (port / "a.fa.fai").read_bytes() == (ref / "a.fa.fai").read_bytes()


def _captured(monkeypatch) -> list:
    """Each launched batch as (general, stream bytes, data bases, offsets)."""
    seen = []
    real = sr._sketch_batch

    def spy(host, total, offsets, k, w, device, sketch, slot_cap, plain):
        seen.append((sketch is sr.sketch_general_torch, host.numpy().tobytes(), total,
                     offsets.tolist()))
        return real(host, total, offsets, k, w, device, sketch, slot_cap, plain)

    monkeypatch.setattr(sr, "_sketch_batch", spy)
    return seen


def _expected_batches(codes: list[np.ndarray], k: int, w: int) -> dict:
    """``_batches`` of each path's device records, each as ``pack_batch``
    joins it: {general: [(stream bytes, data bases, offsets)]}."""
    paths = {False: [], True: []}
    for i, c in enumerate(codes):
        general = bool((c >= 4).any())
        if c.shape[0] <= _BOUNDS[general]:
            paths[general].append((i, c))
    out = {}
    for general, entries in paths.items():
        out[general] = []
        sized = [(i, c.shape[0]) for i, c in entries]
        for b in sr._batches(sized, k, min(sr.BATCH_BASES, _BOUNDS[general])):
            host, total, offsets = sr.pack_batch([codes[i] for i, _ in b], k, w)
            out[general].append((host.numpy().tobytes(), total, offsets.tolist()))
    return out


@pytest.mark.parametrize("fed", ["source", "list"])
def test_batches_are_those_of_batches(tmp_path, monkeypatch, fed):
    """Fed by a ``FastaSource`` or by a list of arrays, each path's batches
    hold the records ``_batches`` gives, in its order, in the stream
    ``pack_batch`` makes of them; the sketches equal the oracle's."""
    recs = _stage_assembly(np.random.default_rng(9))
    _write_fasta(tmp_path / "a.fa", recs, 60)
    _patch_batches(monkeypatch)
    seen = _captured(monkeypatch)
    with native.FastaSource(str(tmp_path / "a.fa")) as src:
        codes = [src.codes(i) for i in range(len(src))]
        got = sr.sketch_records_torch(src if fed == "source" else codes, K, W, "cpu")
    want = _expected_batches(codes, K, W)
    assert len(want[False]) >= 3 and len(want[True]) >= 2
    for general in (False, True):
        assert [s[1:] for s in seen if s[0] == general] == want[general], general
    for g, c in zip(got, codes):
        r = jax_np.sketch_codes(c, K, W)
        assert g.positions.tolist() == r.positions.tolist()
        assert g.hashes.tolist() == r.hashes.tolist()


def test_codes_held_max_is_one_batch_a_path(tmp_path, monkeypatch):
    """The most code bytes held at once: one buffer of the largest batch's
    stream (of either path), the largest host record or the probe's block,
    one of them at a time, and far below the assembly's bases."""
    recs = _stage_assembly(np.random.default_rng(13))
    _write_fasta(tmp_path / "a.fa", recs, 60)
    _patch_batches(monkeypatch)
    with timers.recording(True), native.FastaSource(str(tmp_path / "a.fa")) as src:
        sr.sketch_records_torch(src, K, W, "cpu")
        held = timers.trace_counts()["counters"]["sketch:codes_held_max"]
        codes = [src.codes(i) for i in range(len(src))]
    total = sum(c.shape[0] + K - 1 for c in codes)
    batch = max(sr.stream_len(t, K, W) for streams in _expected_batches(codes, K, W).values()
                for _, t, _ in streams)
    host = max(c.shape[0] for c in codes if c.shape[0] > _BOUNDS[bool((c >= 4).any())])
    probe = min(max(c.shape[0] for c in codes), native.PROBE_BASES)
    assert held == max(batch, host, probe)
    assert batch > sr.BATCH_BASES // 2 and max(batch, host, probe) < total / 3


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_sketch_stage_holds_under_a_byte_a_base(tmp_path, monkeypatch, backend):
    """Under ``tracemalloc`` the sketch stage of a ~4 Mbp assembly (80
    records of 50 kbp, batches of 2^20 bases) peaks below one byte a base on
    the Python heap, its batch buffer and probe block included: no record's
    ``str`` and no list of every record's codes."""
    if backend == "native" and not native.available():
        pytest.skip("no g++ to build the native library")
    monkeypatch.setattr(sr, "BATCH_BASES", 1 << 20)
    rng = np.random.default_rng(3)
    recs = [_UPPER[rng.integers(0, 4, size=50_000)] for _ in range(80)]
    _write_fasta(tmp_path / "a.fa", recs, 80)
    bases = sum(r.shape[0] for r in recs)
    sketch = cli._sketcher(backend, "cpu")
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        with timers.recording(True):
            _, got = cli._ensure_sketch(str(tmp_path / "a.fa"), K, 1000, True, sketch,
                                        StageTimers())
            held = timers.trace_counts()["counters"].get("sketch:codes_held_max", 0)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got.hash.shape[0] > 4000
    assert peak < bases, f"{peak} bytes on the Python heap for {bases} bases"
    assert held < peak


# A line longer than the readers' 1 MiB read buffers.
_LONG = 1_300_000

# FASTA files whose lines are awkward for an index: each gives the same
# records to both readers and the same .fai to every writer.
_AWKWARD = {
    "crlf": b">a desc\r\nACGTACGT\r\nACGTACGT\r\nACG\r\n>b\r\nTTTT\r\nTT\r\n",
    "cr_cr_lf": b">a x\r\r\nACGT\r\r\nACGT\r\r\nAC\r\r\n>b\r\r\nGG\r\r\n>c\r\n\r\r\nA\r\n",
    "blank_in_record": b">a\nACGT\nACGT\n\nACGT\nAC\n>b\nACGT\nA\n",
    "blank_between_records": b">a\nACGT\nACGT\nAC\n\n>b\nACGT\nAC\n\n\n>c\nGGGG\n",
    "short_last_line": b">a\nACGTACGT\nACGTACGT\nA\n>b\nACGTACGT\nACGTACG\n",
    "line_longer_than_first": b">a\nACGT\nACGTACGT\nAC\n>b\nACG\nACGTA\n",
    "empty_record": b">a\n>b\nACGT\nAC\n>c\n>d\n",
    "description_after_space_and_tab": b">a some words\nACGT\n>b\tmore\twords\nAC\n>c \tx\nG\n",
    "no_final_newline": b">a\nACGT\nACGT\nAC\n>b\nACGT\nACG",
    "nul_in_line": b">a\nAC\x00T\nACGT\nA\n>b x\x00y\nACGT\n>c\x00d\nA\x00\n",
    "line_longer_than_read_buffer": b">a\n" + b"ACGT" * (_LONG // 4) + b"\nACGT\n>" + b"b" * _LONG
    + b" d\nACGTACGT\n" + b"T" * _LONG + b"\nAC\n",
    "widths_change_partway": b">a\nACGTACGT\nACGTACGT\nACGT\nACGT\nAC\n>b\nACGTACGT\nACGT\n",
}


@pytest.mark.parametrize("case", sorted(_AWKWARD))
def test_fai_from_reader_rows_is_write_fai(tmp_path, case):
    """The ``.fai`` the native reader's rows give (``fai_text``) is byte for
    byte the port's ``write_fai`` (``nj_write_fai``, a second read) and the
    JAX package's, and the reader's records are the JAX package's native
    reader's (``nj_fasta_open``)."""
    if not native.available() or not jax_native.available():
        pytest.skip("no native library on this machine")
    fa = tmp_path / "x.fa"
    fa.write_bytes(_AWKWARD[case])
    port, jax = tmp_path / "port.fai", tmp_path / "jax.fai"
    write_fai(str(fa), str(port))
    jax_write_fai(str(fa), str(jax))
    with native.FastaSource(str(fa)) as src:
        text = src.fai_text()
        got = [(name, src.seq(i)) for i, name in enumerate(src.names)]
    assert text == port.read_bytes() == jax.read_bytes()
    assert text.count(b"\n") == len(got) >= 2
    assert got == [(r.id, r.seq) for r in jax_native.read_fasta_native(str(fa))]
    rows = [line.split(b"\t") for line in text.splitlines()]
    for col, got_col in zip((2, 3, 4), (src.offsets, src.line_bases, src.line_bytes)):
        assert got_col.dtype == np.int64 and got_col.tolist() == [int(r[col]) for r in rows]


def test_python_reader_keeps_no_rows(tmp_path, monkeypatch):
    """Without the native library (and for a gzipped file) the source has
    no rows, and ``fai_text`` says so."""
    _write_fasta(tmp_path / "x.fa", [_UPPER[:3], _UPPER[:2]], 2)
    _write_fasta(tmp_path / "x.fa.gz", [_UPPER[:3], _UPPER[:2]], 2)
    with native.FastaSource(str(tmp_path / "x.fa.gz")) as src:
        assert src.offsets is None and src.fai_text() is None and src.names == ["rec0", "rec1"]
    monkeypatch.setattr(native, "_load", lambda: None)
    with native.FastaSource(str(tmp_path / "x.fa")) as src:
        assert src.line_bases is None and src.fai_text() is None and len(src) == 2
