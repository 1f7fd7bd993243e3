"""PyTorch and CUDA port of ntjoin_tpu for NVIDIA Hopper GPUs.

A package of its own: the minimizer sketch runs in hand-written CUDA kernels
(``ops/sketch_cuda.py``), the graph stages as torch ops (``ops/``), and the
host layers (``core``, ``graph``, ``emit``, ``io``, ``utils``) are the port's
own copies of the JAX package's.  It imports neither JAX nor ``ntjoin_tpu``.
"""
