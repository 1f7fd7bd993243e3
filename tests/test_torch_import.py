"""The PyTorch port and its chip smoke script import neither JAX nor the JAX
package (``ntjoin_tpu``): the port stands alone.

Checked in a fresh interpreter: this test process has JAX loaded already
(``conftest.py`` imports it)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules() -> list[str]:
    """Every module of the port, from the files on disk (sorted, so every
    test worker collects the same cases)."""
    out = []
    for root, dirs, files in os.walk(os.path.join(REPO, "ntjoin_tpu_torch")):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build", "csrc"))
        pkg = os.path.relpath(root, REPO).replace(os.sep, ".")
        for f in sorted(files):
            if f == "__init__.py":
                out.append(pkg)
            elif f.endswith(".py"):
                out.append(f"{pkg}.{f[:-3]}")
    return out


MODULES = _port_modules() + ["chip_smoke"]


def test_every_copied_layer_is_listed():
    for name in ("constants", "cli", "kernel_prof", "ops.nthash_np", "ops.intervals",
                 "ops.sketch_cuda", "ops.membw", "ops.device_index", "ops.cc",
                 "ops.device_paths", "ops.u64", "utils.atomic", "utils.timers", "io.native",
                 "io.fasta", "core.pathnode", "core.config", "core.assembly",
                 "core.orientation", "core.overlap_region", "core.overlap_trim", "core.paths",
                 "core.scaffolder", "graph.mingraph", "graph.paths", "emit.writers",
                 "ops.mannkendall", "ops.sketch_general", "utils.bloom", "analysis", "run",
                 "parallel.mesh", "parallel.distributed", "parallel.pipeline", "ops.filters",
                 "dryrun", "bench", "perf_scale", "scaling_proxy"):
        assert f"ntjoin_tpu_torch.{name}" in MODULES, name


@pytest.mark.parametrize("module", MODULES)
def test_imports_no_jax(module):
    code = (
        f"import importlib, sys; importlib.import_module({module!r}); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ntjoin_tpu')); "
        "assert not bad, bad"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert res.returncode == 0, res.stderr
