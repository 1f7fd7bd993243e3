"""ctypes bindings for the native host library (``native/ntjoin_native.cpp``).

Optional acceleration: a C++ streaming FASTA parser and the sequential
rolling-hash sketcher (the host-native indexlr equivalent).  Callers check
:func:`available` and take the pure-python/NumPy paths where it is False;
:class:`FastaSource` hands out one assembly's records from the C++ reader,
or from the Python reader where the library is not there.

The port keeps its own build of the library: the source is read where it
is, compiled with ``g++`` and the flags of ``native/Makefile`` into
``ntjoin_tpu_torch/_build/libntjoin_native.so`` on first use, and rebuilt
whenever the source is newer.  :func:`available` is False only where there
is no compiler (or no source) to make a fresh library; a compiler that is
present and fails is an error.
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
LIB_PATH = os.path.join(_PKG, "_build", "libntjoin_native.so")
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread")


def build() -> bool:
    """Make ``LIB_PATH`` fresh: compile ``SRC_PATH`` unless the library is
    newer than it.  False where that cannot be done (no source, or no
    ``g++``) - a stale library is never loaded; raises when the compiler
    fails."""
    if not os.path.exists(SRC_PATH):
        return False
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC_PATH):
        return True
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp, SRC_PATH],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC_PATH} ({res.returncode}):\n{res.stderr}")
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
    lib.nj_fasta_open.restype = ctypes.c_void_p
    lib.nj_fasta_open.argtypes = [ctypes.c_char_p]
    lib.nj_fasta_count.restype = ctypes.c_int64
    lib.nj_fasta_count.argtypes = [ctypes.c_void_p]
    lib.nj_fasta_len.restype = ctypes.c_int64
    lib.nj_fasta_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.nj_fasta_name.restype = ctypes.c_int64
    lib.nj_fasta_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.nj_fasta_seq.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_fasta_seq_ptr.restype = ctypes.c_void_p
    lib.nj_fasta_seq_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.nj_fasta_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_fasta_close.argtypes = [ctypes.c_void_p]
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

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    h = lib.nj_fasta_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        out = []
        cap = 4096
        name_buf = ctypes.create_string_buffer(cap)
        for i in range(lib.nj_fasta_count(h)):
            need = lib.nj_fasta_name(h, i, name_buf, cap)
            if need >= cap:  # metadata-stuffed header: grow and re-read
                cap = int(need) + 1
                name_buf = ctypes.create_string_buffer(cap)
                lib.nj_fasta_name(h, i, name_buf, cap)
            n = lib.nj_fasta_len(h, i)
            # single copy via string_at; latin-1 decode is a memcpy for the
            # byte-for-byte FASTA alphabet
            raw = ctypes.string_at(lib.nj_fasta_seq_ptr(h, i), n)
            out.append(FastaRecord(name_buf.value.decode(), raw.decode("latin-1")))
        return out
    finally:
        lib.nj_fasta_close(h)


# Bases a probe of a record's path encodes at a time (FastaSource.clean).
PROBE_BASES = 1 << 20


class FastaSource:
    """The records of one FASTA file, read once and handed out one record
    at a time; a context manager that closes the reader on exit.

    Where the native library is available (and the file is not gzipped),
    the C++ reader (``nj_fasta_open``) holds the file's bases, one byte a
    base, and ``codes_into`` encodes a record from them (``nj_fasta_codes``)
    into any buffer, the pinned batch buffer included: no Python ``str`` of
    a record is made unless ``seq`` asks for it.  Elsewhere the same
    interface sits over ``io/fasta.py``'s Python reader.  A file the native
    reader cannot open raises: it never switches reader.

    ``names`` (record ids), ``lengths`` (int64 bases a record) and
    ``len()`` describe the records; ``view(i)`` is record i's bytes as a
    uint8 array, a view of the reader's buffer valid until ``close``.
    """

    def __init__(self, path: str):
        self.path = path
        self._h = None
        self._records = None
        lib = None if path.endswith(".gz") else _load()
        if lib is None:
            from ntjoin_tpu_torch.io.fasta import read_fasta

            self._records = read_fasta(path)
            self.names = [r.id for r in self._records]
            self.lengths = np.array([r.length for r in self._records], dtype=np.int64)
            return
        h = lib.nj_fasta_open(path.encode())
        if not h:
            raise FileNotFoundError(path)
        self._lib, self._h = lib, h
        count = lib.nj_fasta_count(h)
        self.lengths = np.array([lib.nj_fasta_len(h, i) for i in range(count)], dtype=np.int64)
        self.names = []
        cap = 4096
        buf = ctypes.create_string_buffer(cap)
        for i in range(count):
            need = lib.nj_fasta_name(h, i, buf, cap)
            if need >= cap:  # metadata-stuffed header: grow and re-read
                cap = int(need) + 1
                buf = ctypes.create_string_buffer(cap)
                lib.nj_fasta_name(h, i, buf, cap)
            self.names.append(buf.value.decode())

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
            self._lib.nj_fasta_close(self._h)
            self._h = None
        self._records = None
        trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc only
        if trim is not None:
            trim(0)

    def _ptr(self, i: int) -> int:
        if self._h is None:
            raise ValueError(f"{self.path}: the source is closed")
        return self._lib.nj_fasta_seq_ptr(self._h, i)

    def view(self, i: int) -> np.ndarray:
        """Record i's bytes (uint8): a view of the reader's buffer, valid
        until the source closes."""
        if self._records is not None:
            return np.frombuffer(self._records[i].seq.encode("latin-1"), dtype=np.uint8)
        n = int(self.lengths[i])
        return np.frombuffer((ctypes.c_char * n).from_address(self._ptr(i)), dtype=np.uint8)

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
            self._lib.nj_fasta_codes(self._h, i, out.ctypes.data)
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
