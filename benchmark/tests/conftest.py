"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
repo root.  Tests marked ``chip`` need a CUDA card and skip without one,
deciding inside the test."""
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
    import torch

    # the tests fork jobs from this process, which also runs torch on the
    # CPU: a child forked after an OpenMP pool started can hang in it
    torch.set_num_threads(1)


TINY_CONFIG = {
    "words": {"reference_weights": "2 2", "target_weight": "1", "k": "32", "w": "1000",
              "n": "1", "g": "20", "G": "0", "overlap": "True", "mkt": "False"},
    "chromosomes": {"c1": 160000, "c2": 130000},
    "repeats": {"share": 0.12, "families": 12, "unit_bp": [300, 3000], "divergence": [0.02, 0.15]},
    "references": [
        {"file": "ref1.fa", "snp_rate": 0.001, "bounds_shift_bp": 0,
         "n_runs": {"ends_bp": 1000, "blocks": [[60000, 5000]], "scattered_bp": 3000,
                    "scattered_run_bp": [500, 1500]}},
        {"file": "ref2.fa", "snp_rate": 0.001, "bounds_shift_bp": 20000},
    ],
    "target": {"file": "target.fa", "error_rate": 0.0001},
}
TINY_TRAFFIC = {"contig_n50_bp": 12000, "contig_min_bp": 1000, "length_sigma": 1.0,
                "contig_spacing_bp": [-100, 500], "scaffold_share": 0.2,
                "scaffold_contigs": [2, 5], "scaffold_gap_bp": [10, 1000], "reverse_share": 0.3}
CPU_WORDS = ["backend=torch", "device=cpu"]


@pytest.fixture
def tiny():
    import copy

    return copy.deepcopy(TINY_CONFIG), copy.deepcopy(TINY_TRAFFIC)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
