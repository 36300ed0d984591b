"""PyTorch/CUDA port of LIA-TPU.

The JAX package ``lia_tpu`` is the reference: this package mirrors its layout
module by module (``config``, ``models``, ``ops``, ``engine``, ``utils``) and
keeps its tensor layouts (stacked ``[L, ...]`` parameters, head-major
``[L, B, N_kv, S, D]`` KV), so trees convert without transposes. Every Pallas
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``).

Importing the package has no side effects: no CUDA context, no build.
"""
