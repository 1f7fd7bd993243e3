"""Device-memory copy: the bandwidth calibration of the per-stage profiler
(``ntjoin_tpu_torch/kernel_prof.py``), a CUDA kernel (``csrc/copy.cu``) and
its plain PyTorch version.  Port of the two ``pallas_copy`` kernels of
``scripts/kernel_prof.py``.

The wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor; launches count in ``launch:copy`` (``utils/timers.py``).
"""
from __future__ import annotations

import torch

from ntjoin_tpu_torch.ops import sketch_cuda as sc
from ntjoin_tpu_torch.utils import timers


def copy_words_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a new tensor equal to ``x``."""
    timers.count("launch:copy_plain")
    return torch.empty_like(x).copy_(x)


def copy_words(x: torch.Tensor) -> torch.Tensor:
    """A copy of the contiguous tensor ``x``: the copy kernel for a CUDA
    tensor, ``copy_words_ref`` for a CPU one."""
    if not sc._on_cuda(x):
        return copy_words_ref(x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("copy_words: want a contiguous tensor on a 16-byte boundary")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = sc._lib().nj_copy(x.data_ptr(), y.data_ptr(), x.numel() * x.element_size(),
                                sc._stream(x))
    sc._launched(err, "copy")
    return y
