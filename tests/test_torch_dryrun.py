"""The port's multi-shard dry run (``ntjoin_tpu_torch/dryrun.py``, the
counterpart of ``__graft_entry__.dryrun_multichip``) on CPU shards, the
plain versions: each step holds itself against its oracle and raises on a
disagreement."""
import os
import subprocess
import sys

import pytest
import torch

from ntjoin_tpu_torch.dryrun import dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_devices", [8, 3])
def test_dryrun_multichip_on_cpu_shards(n_devices):
    dryrun_multichip(n_devices, "cpu")


def test_dryrun_needs_the_card_it_names(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="not available"):
        dryrun_multichip(2, "cuda")


def test_dryrun_command_line():
    res = subprocess.run([sys.executable, "-m", "ntjoin_tpu_torch.dryrun", "4", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "dryrun_multichip: ok"
