"""ctypes bindings for the native host library (``native/ntjoin_native.cpp``).

Optional acceleration: a C++ streaming FASTA parser and the sequential
rolling-hash sketcher (the host-native indexlr equivalent).  Callers check
:func:`available` and take the pure-python/NumPy paths where it is False;
:class:`FastaSource` hands out one assembly's records from the C++ reader,
or from the Python reader where the library is not there.

The port keeps its own build of the library: ``native/ntjoin_native.cpp``,
read where it is, and the port's FASTA reader
(``ntjoin_tpu_torch/native/fasta_reader.cpp``) are compiled with ``g++`` and
the flags of ``native/Makefile`` into
``ntjoin_tpu_torch/_build/libntjoin_native.so`` on first use, and rebuilt
whenever either source is newer.  :func:`available` is False only where
there is no compiler (or no source) to make a fresh library; a compiler
that is present and fails is an error.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_ERROR: BaseException | None = None  # the failed build's exception, raised on every call
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(os.path.dirname(_PKG), "native", "ntjoin_native.cpp")
READER_PATH = os.path.join(_PKG, "native", "fasta_reader.cpp")
LIB_PATH = os.path.join(_PKG, "_build", "libntjoin_native.so")
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread")


def build() -> bool:
    """Make ``LIB_PATH`` fresh: compile ``SRC_PATH`` and ``READER_PATH``
    unless the library is newer than both.  False where that cannot be done
    (a source missing, or no ``g++``) - a stale library is never loaded;
    raises when the compiler fails."""
    srcs = (SRC_PATH, READER_PATH)
    if not all(os.path.exists(src) for src in srcs):
        return False
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
            os.path.getmtime(src) for src in srcs):
        return True
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp, *srcs],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {' '.join(srcs)} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    return True


def _load():
    """The loaded library, or None where :func:`build` says it cannot be
    made.  A build that failed raises its error again on every call."""
    global _LIB, _TRIED, _ERROR
    if _ERROR is not None:
        raise _ERROR
    if _TRIED:
        return _LIB
    try:
        made = build()
    except Exception as exc:
        _ERROR = exc
        raise
    _TRIED = True
    if not made:
        return None
    lib = ctypes.CDLL(LIB_PATH)
    lib.nj_sketch.restype = ctypes.c_int64
    lib.nj_sketch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.nj_sketch_mt.restype = ctypes.c_int64
    lib.nj_sketch_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.nj_canonical_hashes.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.nj_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_write_fai.restype = ctypes.c_int64
    lib.nj_write_fai.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.nj_write_dot.restype = ctypes.c_int64
    lib.nj_write_dot.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
    ]
    lib.nj_reader_open.restype = ctypes.c_void_p
    lib.nj_reader_open.argtypes = [ctypes.c_char_p]
    lib.nj_reader_count.restype = ctypes.c_int64
    lib.nj_reader_count.argtypes = [ctypes.c_void_p]
    lib.nj_reader_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nj_reader_names.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nj_reader_seq_ptr.restype = ctypes.c_void_p
    lib.nj_reader_seq_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.nj_reader_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_reader_close.argtypes = [ctypes.c_void_p]
    lib.nj_format_minimizers.restype = ctypes.c_int64
    lib.nj_format_minimizers.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nj_walk_chain.restype = ctypes.c_int64
    lib.nj_walk_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def sketch_codes_native(codes: np.ndarray, k: int, w: int, threads: int = 0):
    """Rolling-hash sketch via the C++ library (bit-identical to the oracle).

    threads=0 uses all CPUs; tile-parallel with exact seam handling (N-free
    records; N-containing records run single-threaded).
    """
    from ntjoin_tpu_torch.ops.nthash_np import Sketch

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = codes.shape[0]
    if k > n or w > n - k + 1:
        return Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))
    cap = n - k + 2
    pos = np.empty(cap, dtype=np.int64)
    hashes = np.empty(cap, dtype=np.uint64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    threads = threads or (os.cpu_count() or 1)
    count = lib.nj_sketch_mt(
        codes.ctypes.data, n, k, w, threads,
        pos.ctypes.data, hashes.ctypes.data, cap,
    )
    return Sketch(positions=pos[:count].copy(), hashes=hashes[:count].copy())


def sketch_seq_host(seq: str | bytes, k: int, w: int):
    """Sketch an ASCII sequence on the fastest available host path.

    Native C++ encode + rolling sketch when the library is loadable, NumPy
    oracle otherwise — bit-identical either way (enforced by the parity
    suites).  This is the host analogue of the reference's in-process
    ``btllib.Indexlr`` use for overlap re-sketching
    (``ntjoin_assemble.py:478-479``).
    """
    lib = _load()
    if lib is None:
        from ntjoin_tpu_torch.ops.nthash_np import sketch_seq

        return sketch_seq(seq, k, w)
    from ntjoin_tpu_torch.ops.nthash_np import Sketch

    raw = seq.encode("ascii") if isinstance(seq, str) else bytes(seq)
    n = len(raw)
    if k > n or w > n - k + 1:
        return Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))
    codes = np.empty(n, dtype=np.uint8)
    lib.nj_encode(raw, n, codes.ctypes.data)
    cap = n - k + 2
    pos = np.empty(cap, dtype=np.int64)
    hashes = np.empty(cap, dtype=np.uint64)
    count = lib.nj_sketch(codes.ctypes.data, n, k, w, pos.ctypes.data,
                          hashes.ctypes.data, cap)
    return Sketch(positions=pos[:count].copy(), hashes=hashes[:count].copy())


def read_fasta_native(path: str):
    """Parse FASTA via the C++ reader; returns list of FastaRecord."""
    from ntjoin_tpu_torch.io.fasta import FastaRecord

    if _load() is None:
        raise RuntimeError("native library unavailable")
    with FastaSource(path) as src:
        return [FastaRecord(name, src.seq(i)) for i, name in enumerate(src.names)]


# Bases a probe of a record's path encodes at a time (FastaSource.clean).
PROBE_BASES = 1 << 20


# Columns of ``nj_reader_rows``: bases, name bytes, ``.fai`` name bytes,
# ``.fai`` length, offset, line bases, line bytes.
_ROW_COLS = 7


class FastaSource:
    """The records of one FASTA file, read once and handed out one record
    at a time; a context manager that closes the reader on exit.

    Where the native library is available (and the file is not gzipped),
    the C++ reader (``nj_reader_open``, ``native/fasta_reader.cpp``) holds
    the file's bases, one byte a base, and ``codes_into`` encodes a record
    from them (``nj_reader_codes``) into any buffer, the pinned batch
    buffer included: no Python ``str`` of a record is made unless ``seq``
    asks for it.  Elsewhere the same interface sits over ``io/fasta.py``'s
    Python reader.  A file the native reader cannot open raises: it never
    switches reader.

    ``names`` (record ids), ``lengths`` (int64 bases a record) and
    ``len()`` describe the records; ``view(i)`` is record i's bytes as a
    uint8 array, a view of the reader's buffer valid until ``close``.  The
    native reader also keeps the file's ``.fai`` rows from the same scan:
    ``offsets``, ``line_bases`` and ``line_bytes`` (int64 a record; None
    where the Python reader serves), and ``fai_text`` gives the index's
    bytes; both outlive ``close``.
    """

    def __init__(self, path: str):
        self.path = path
        self._h = None
        self._records = None
        self._bases = None  # (address, uint8 array) of the reader's buffer, made by view
        self.offsets = self.line_bases = self.line_bytes = None
        lib = None if path.endswith(".gz") else _load()
        if lib is None:
            from ntjoin_tpu_torch.io.fasta import read_fasta

            self._records = read_fasta(path)
            self.names = [r.id for r in self._records]
            self.lengths = np.array([r.length for r in self._records], dtype=np.int64)
            return
        h = lib.nj_reader_open(path.encode())
        if not h:
            raise FileNotFoundError(path)
        self._lib, self._h = lib, h
        rows = np.empty((lib.nj_reader_count(h), _ROW_COLS), dtype=np.int64)
        lib.nj_reader_rows(h, rows.ctypes.data)
        blob = ctypes.create_string_buffer(int(rows[:, 1].sum()))
        lib.nj_reader_names(h, blob)
        blob, ends = blob.raw, np.cumsum(rows[:, 1]).tolist()
        raw = [blob[a:b] for a, b in zip([0] + ends, ends)]
        # a name ends at its first NUL, as C strings and the index's writer end it
        self.names = [r.split(b"\0", 1)[0].decode() for r in raw]
        self._fai_names = [r[:n].split(b"\0", 1)[0] for r, n in zip(raw, rows[:, 2].tolist())]
        self.lengths, self._fai_lengths, self.offsets, self.line_bases, self.line_bytes = (
            rows[:, c].copy() for c in (0, 3, 4, 5, 6))

    def fai_text(self) -> bytes | None:
        """The file's ``.fai`` index, byte for byte what ``write_fai`` writes
        (``nj_write_fai``), from the rows the native reader kept; None where
        the Python reader served."""
        if self.offsets is None:
            return None
        cols = (self._fai_lengths, self.offsets, self.line_bases, self.line_bytes)
        return b"".join(b"%s\t%d\t%d\t%d\t%d\n" % (name, *row)
                        for name, *row in zip(self._fai_names, *(c.tolist() for c in cols)))

    def __len__(self) -> int:
        return len(self.names)

    def __enter__(self) -> FastaSource:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Free the reader's bytes and hand the freed heap back to the
        system: the bytes of many short records lie below later
        allocations, where ``free`` alone keeps them resident."""
        if self._h is None and self._records is None:
            return
        if self._h is not None:
            self._lib.nj_reader_close(self._h)
            self._h = None
            self._bases = None
        self._records = None
        trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc only
        if trim is not None:
            trim(0)

    def _ptr(self, i: int) -> int:
        if self._h is None:
            raise ValueError(f"{self.path}: the source is closed")
        return self._lib.nj_reader_seq_ptr(self._h, i)

    def view(self, i: int) -> np.ndarray:
        """Record i's bytes (uint8): a view of the reader's buffer, valid
        until the source closes."""
        if self._records is not None:
            return np.frombuffer(self._records[i].seq.encode("latin-1"), dtype=np.uint8)
        start = self._ptr(i)
        if self._bases is None:
            # the reader keeps the records' bases back to back in one buffer:
            # one array over all of it, so that a record's view is a slice
            # and not a ctypes array type of its own length
            first, last = self._ptr(0), self._ptr(len(self) - 1) + int(self.lengths[-1])
            self._bases = (first, np.frombuffer((ctypes.c_char * (last - first)).from_address(
                first), dtype=np.uint8))
        first, bases = self._bases
        return bases[start - first : start - first + int(self.lengths[i])]

    def seq(self, i: int) -> str:
        """Record i's text, made when asked."""
        if self._records is not None:
            return self._records[i].seq
        return ctypes.string_at(self._ptr(i), int(self.lengths[i])).decode("latin-1")

    def _encode(self, i: int, start: int, out: np.ndarray) -> None:
        """Codes of record i's bases [start, start + out.size) into out."""
        if self._records is not None:
            from ntjoin_tpu_torch.ops.nthash_np import encode

            out[:] = encode(self._records[i].seq[start : start + out.shape[0]])
            return
        self._lib.nj_encode(ctypes.c_char_p(self._ptr(i) + start), out.shape[0],
                            out.ctypes.data)

    def codes_into(self, i: int, out: np.ndarray) -> None:
        """Record i's base codes (A=0 C=1 G=2 T=3, other=4) into ``out``, a
        contiguous int8 or uint8 array of exactly its length (a slice of a
        pinned buffer's ``numpy()`` view serves)."""
        n = int(self.lengths[i])
        if out.shape != (n,) or out.dtype.itemsize != 1 or not out.flags.c_contiguous:
            raise ValueError(f"record {i} needs a contiguous 1-byte buffer of {n}, "
                             f"got {out.dtype} {out.shape}")
        if self._records is None:
            self._ptr(i)  # refuse a closed source before the C++ call
            self._lib.nj_reader_codes(self._h, i, out.ctypes.data)
        else:
            self._encode(i, 0, out)

    def codes(self, i: int) -> np.ndarray:
        """Record i's base codes in an array of their own."""
        out = np.empty(int(self.lengths[i]), dtype=np.uint8)
        self.codes_into(i, out)
        return out

    def clean(self, i: int, scratch: np.ndarray | None = None) -> bool:
        """Whether record i holds only A, C, G and T (either case), read
        ``PROBE_BASES`` at a time (into ``scratch`` when given); it stops
        at the first block with another letter."""
        n = int(self.lengths[i])
        if n == 0:
            return True
        if scratch is None:
            scratch = np.empty(min(n, PROBE_BASES), dtype=np.uint8)
        for a in range(0, n, scratch.shape[0]):
            part = scratch[: min(scratch.shape[0], n - a)]
            self._encode(i, a, part)
            if part.max() >= 4:
                return False
        return True
