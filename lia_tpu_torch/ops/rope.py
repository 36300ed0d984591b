"""Rotary position embeddings (port of ``lia_tpu/ops/rope.py``).

The rotation is elementwise and runs in plain PyTorch before attention, as
the reference runs it in jnp outside every kernel: the attention kernels take
rotated Q and K. fp32 math, cast back to the input's type.

Two pairings:

- llama "half rotation" (``rotate_half``): pairs ``(x[i], x[i + r/2])``;
- gpt-j / chatglm "interleaved" (``rotate_every_two``): pairs ``(x[2i], x[2i+1])``.

With ``rotary_dim`` below the head width (gpt-j, gpt-neox's ``rotary_pct``)
only the leading ``rotary_dim`` dims rotate and the rest pass through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, theta: float, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, S, 1, r/2] of ``positions`` [B, S]: the part that Q and K
    of one layer share."""
    angles = positions.float()[..., None] * rope_frequencies(r, theta, positions.device)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, interleaved: bool = False) -> torch.Tensor:
    """x [B, S, N, D] rotated over its first ``2 * cos.shape[-1]`` dims."""
    r = 2 * cos.shape[-1]
    xf = x[..., :r].float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    else:
        x1, x2 = xf[..., : r // 2], xf[..., r // 2:]
        rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    rot = rot.to(x.dtype)
    if r == x.shape[-1]:
        return rot
    return torch.cat([rot, x[..., r:]], dim=-1)


def apply_rope(
    x: torch.Tensor,  # [B, S, N, D]
    positions: torch.Tensor,  # [B, S] int
    theta: float,
    rotary_dim: Optional[int] = None,
    interleaved: bool = False,
) -> torch.Tensor:
    """Rotate Q or K by position-dependent angles."""
    r = rotary_dim if rotary_dim is not None else x.shape[-1]
    cos, sin = rope_angles(positions, theta, r)
    return rotate(x, cos, sin, interleaved)
