"""PyTorch and CUDA port of ntjoin_tpu for NVIDIA Hopper GPUs.

The minimizer sketch runs in hand-written CUDA kernels
(``ops/sketch_cuda.py``); the scaffold stages reuse the JAX package's host
layers (``ntjoin_tpu.core``, ``graph``, ``emit``, ``io``), which import no JAX.
This package never imports JAX.
"""
