"""Normalization ops with fp32 statistics (port of ``lia_tpu/ops/norms.py``).

Plain PyTorch: the reductions are small next to the matmuls around them, and
fp32 accumulation is the only thing that must be enforced by hand.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """LayerNorm over the last axis; returns x.dtype. ``F.layer_norm`` keeps the
    statistics and the affine step in fp32 for bf16 inputs and rounds once, as
    the reference does, in one launch."""
    return F.layer_norm(x, (x.shape[-1],), scale.to(x.dtype), bias.to(x.dtype), eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm over the last axis with fp32 statistics (llama-style)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
