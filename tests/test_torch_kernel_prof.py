"""What the port's profiler runs, on the CPU: the ``stop_after`` hooks of
``sketch_fused_torch`` against the ops' plain versions, the full call
against the NumPy oracle, the copy's plain version, the ``STAGES`` timers,
and the profiler's refusal to run without a GPU.  Integer outputs: the
comparisons are exact (tolerance zero)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntjoin_tpu.ops.nthash_np import derive_hash, sketch_codes
from ntjoin_tpu_torch import kernel_prof
from ntjoin_tpu_torch.ops import membw
from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.ops import sketch_records as sr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stream(k, w, n=1 << 16):
    """A seeded 2^16-base stream padded to its layout."""
    codes = np.random.default_rng(16).integers(0, 4, size=n).astype(np.int8)
    C, L = sc.layout(n, k, w)
    flat = np.full(C * L + w + k - 2, 4, dtype=np.int8)
    flat[:n] = codes
    return codes, torch.from_numpy(flat), C, L


@pytest.mark.parametrize("k,w", [(32, 1000), (15, 10)])
def test_stop_after_hooks(k, w):
    codes, flat, C, L = _stream(k, w)
    n = codes.shape[0]
    rows, off = L + w + k - 2, k - 1
    h, val = sc.sketch_fused_torch(flat, n, k, w, stop_after="hash")
    h_ref, val_ref = sc.hash_chunked_ref(sc._chunk_view(flat, L, C, rows), k)
    assert torch.equal(h, h_ref) and torch.equal(val, val_ref)

    got = sc.sketch_fused_torch(flat, n, k, w, stop_after="window")
    cap = sc._slot_cap(L, w)
    want = sc.window_emit_ref(h_ref, sc.window_flags(val_ref, L, w, off), L, w, off, cap)
    assert len(got) == 3
    for g, r in zip(got, want):
        assert torch.equal(g, r)

    pos, canon = sc.sketch_fused_torch(flat, n, k, w)
    oracle = sketch_codes(codes.astype(np.uint8), k, w)
    assert pos.numpy().tolist() == oracle.positions.tolist()
    assert derive_hash(canon.numpy().view(np.uint64), k).tolist() == oracle.hashes.tolist()
    with pytest.raises(ValueError):
        sc.sketch_fused_torch(flat, n, k, w, stop_after="compact")


@pytest.mark.parametrize("dtype,shape", [(torch.int32, (64, 2048)), (torch.uint32, (7, 3)),
                                         (torch.int8, (1001,))])
def test_copy_words_plain_version(dtype, shape):
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 100, size=shape).astype(np.int8))
    x = x.to(torch.int32).to(dtype) if dtype != torch.int8 else x
    sc.reset_counts()
    y = membw.copy_words(x)
    assert sc.COUNTS["copy_plain"] == 1 and sc.COUNTS["copy"] == 0
    assert y.dtype == x.dtype and torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(membw.copy_words_ref(x), x)


def test_ablate_marginals_add_up():
    """The ``ablate`` stage's split: the flag op has a time of its own, and
    the parts sum to the whole call."""
    m = kernel_prof.marginals(t_hash=0.8, t_flags=0.25, t_win=2.5, t_full=3.25)
    assert m["hash_ms"] == 0.8 and m["flags_ms"] == 0.25
    assert m["window_ms"] == pytest.approx(1.45) and m["compaction_ms"] == pytest.approx(0.75)
    parts = m["hash_ms"] + m["flags_ms"] + m["window_ms"] + m["compaction_ms"]
    assert parts == pytest.approx(m["full_ms"])


@pytest.mark.parametrize("plain", [False, True])
def test_fused_call_counts_the_flag_op(plain):
    """On the CPU, and with ``plain=True`` anywhere, the fused call takes the
    flag op's plain version, once a call."""
    codes, flat, C, L = _stream(15, 10, 1 << 12)
    sc.reset_counts()
    sc.sketch_fused_torch(flat, codes.shape[0], 15, 10, plain=plain)
    assert sc.COUNTS["flags_plain"] == 1 and sc.COUNTS["flags"] == 0
    assert sc.COUNTS["hash_plain"] == 1 and sc.COUNTS["window_emit_plain"] == 1
    assert set(sc.KERNELS) >= {"flags", "window", "window_emit_gmem"}
    assert all(sc.COUNTS[name] == 0 for name in sc.KERNELS)


def test_copy_rows_at_the_bench_size():
    """The copy array of the original profiler at 2^27 bases: 66,688 rows
    of 2048 words, 546 MB."""
    assert kernel_prof.copy_rows(1 << 27) == 66_688
    assert kernel_prof.copy_rows(1 << 27) * 2048 * 4 == 546_308_096


def test_stages_filled_by_a_cpu_sketch():
    rng = np.random.default_rng(8)
    recs = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (9000, 4000, 30)]
    recs[0][3000:3200] = 4
    sr.STAGES.clear()
    got = sr.sketch_records_torch(recs, 15, 10, "cpu")
    assert set(sr.STAGES) == {"plan", "pack", "device", "split"}
    assert all(v >= 0 for v in sr.STAGES.values())
    for g, c in zip(got, recs):
        assert g.positions.tolist() == sketch_codes(c, 15, 10).positions.tolist()


def test_profiler_refuses_without_cuda():
    res = subprocess.run([sys.executable, "-m", "ntjoin_tpu_torch.kernel_prof", "link"],
                         cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""


def test_split_bench_variants_still_match_the_sources(tmp_path):
    """``split_bench variant`` rewrites the kernels' sources by text: every
    pattern must still be found, and the copy must hold the edits."""
    from ntjoin_tpu_torch import split_bench

    split_bench.variant(str(tmp_path), ["noscan", "noload", "nostore", "rows=4", "threads=1024",
                                        "noballot", "flagrows=64", "flagthreads=256"])
    pkg = tmp_path / "ntjoin_tpu_torch"
    header = (pkg / "csrc" / "vanherk.cuh").read_text()
    assert "constexpr int kRows = 4;" in header and "constexpr int kMaxThreads = 1024;" in header
    assert header.count("return none;") == 1 and "pre = suf = none;" in header
    assert "0x9E3779B97F4A7C15ull" in header
    assert "0xFFFFFFF0u" in (pkg / "csrc" / "window.cu").read_text()
    wrapper = (pkg / "ops" / "sketch_cuda.py").read_text()
    assert "\nSPLIT_ROWS = 4\n" in wrapper and "\nSPLIT_MAX_THREADS = 1024\n" in wrapper
    flags = (pkg / "csrc" / "flags.cu").read_text()  # the summary's ballots, the walk's shape
    assert "__ballot_sync" not in flags
    assert "constexpr int kWalkRows = 64, kWalkThreads = 256;" in flags
    assert "\nFLAG_ROWS = 64\n" in wrapper and "\nFLAG_THREADS = 256\n" in wrapper
    assert not (pkg / "_build").exists()
    with pytest.raises(SystemExit, match="unknown part"):
        split_bench.variant(str(tmp_path / "other"), ["nothing"])


def test_split_bench_refuses_without_cuda():
    res = subprocess.run([sys.executable, "-m", "ntjoin_tpu_torch.split_bench", "times"],
                         cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 2 and "no CUDA device" in res.stderr and res.stdout == ""
