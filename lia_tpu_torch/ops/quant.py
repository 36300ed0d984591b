"""INT8 KV cache quantization (port of the KV half of ``lia_tpu/ops/quant.py``).

One symmetric scale per token per head: codes int8 ``[..., S, D]``, scales f32
``[..., S]``. Rounding (half to even) and clipping follow the reference, so
codes and scales are bit-equal for equal inputs. Weight quantization is not
ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QuantizedKV(NamedTuple):
    """INT8 KV plane(s) with per-token scales: ``q`` int8 [..., S, D], ``s`` f32 [..., S]."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):  # logical (dequantized) shape
        return self.q.shape


def is_quantized_kv(x: Any) -> bool:
    return isinstance(x, QuantizedKV)


def quantize_kv(x: torch.Tensor) -> QuantizedKV:
    """Quantize head-major K/V [..., S, D] with one symmetric scale per token."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)  # [..., S]
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127).to(torch.int8)
    return QuantizedKV(q, scale)


def dequantize_kv(kv: QuantizedKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (kv.q.float() * kv.s[..., None]).to(dtype)
