"""``peak_rss_gb`` follows the job's own memory: a job that holds half a GB
more reads about half a GB more (a tiny cell through the port's
``backend=torch device=cpu``)."""
import time

import numpy as np
from conftest import CPU_WORDS

from njbench import harness, job

EXTRA = 500_000_000  # bytes the planted job holds beside its work


def _peak_gb(cfg, tr, seed):
    run = harness.run_cell(cfg, tr, seed, 0.0, False, time.perf_counter(), need_cuda=False,
                           extra_words=CPU_WORDS)
    assert all(j["ok"] for j in run["jobs"])
    return harness.load_reader("peak_rss_gb")(run)


def test_peak_rss_moves_with_the_jobs_memory(tiny, monkeypatch):
    cfg, tr = tiny
    seed = 2**31 + 77
    base = _peak_gb(cfg, tr, seed)
    real = job.call

    def holds_more(words):
        extra = np.ones(EXTRA // 8)  # every page touched
        rc = real(words)
        del extra
        return rc

    monkeypatch.setattr(job, "call", holds_more)
    more = _peak_gb(cfg, tr, seed)
    assert abs((more - base) - EXTRA / 1e9) < 0.1 * EXTRA / 1e9, (base, more)
