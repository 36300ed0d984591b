"""Tensor ops: norms, KV cache, attention front doors and the CUDA kernels."""
