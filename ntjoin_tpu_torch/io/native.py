"""ctypes bindings for the native host library (``native/ntjoin_native.cpp``).

Optional acceleration: a C++ streaming FASTA parser and the sequential
rolling-hash sketcher (the host-native indexlr equivalent).  Callers check
:func:`available` and take the pure-python/NumPy paths where it is False.

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
