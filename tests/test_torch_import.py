"""The PyTorch port and its chip smoke script import no JAX.

Checked in a fresh interpreter: this test process has JAX loaded already
(``conftest.py`` imports it)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "module",
    ["ntjoin_tpu_torch", "ntjoin_tpu_torch.cli", "ntjoin_tpu_torch.ops.sketch_cuda",
     "ntjoin_tpu_torch.ops.membw", "ntjoin_tpu_torch.ops.device_index",
     "ntjoin_tpu_torch.ops.cc", "ntjoin_tpu_torch.ops.device_paths",
     "ntjoin_tpu_torch.graph.mingraph", "ntjoin_tpu_torch.graph.paths",
     "ntjoin_tpu_torch.core.scaffolder", "ntjoin_tpu_torch.kernel_prof", "chip_smoke"],
)
def test_imports_no_jax(module):
    code = (
        f"import importlib, sys; importlib.import_module({module!r}); "
        "jax = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')); "
        "assert not jax, jax"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert res.returncode == 0, res.stderr
