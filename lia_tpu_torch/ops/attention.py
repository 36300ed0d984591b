"""Attention ops (port of ``lia_tpu/ops/attention.py``, the aligned-batch path).

Layouts as in the reference: hidden [B, S, H]; Q [B, S, N, D]; K/V head-major
[B, N_kv, S_kv, D]. GQA reshapes Q to [B, S, N_kv, G, D]; K/V heads are never
replicated.

:func:`attend` is the general masked golden model. The front doors
:func:`attend_prefill`, :func:`attend_decode_fresh` and :func:`attend_decode`
go through the kernel wrappers of :mod:`lia_tpu_torch.ops.cuda_attention`: the
CUDA kernel for a CUDA tensor, its plain version for a CPU tensor. ALiBi
biases are not ported yet; the front doors raise when a context carries one.

:func:`attend_prefill_host` and :func:`attend_decode_host` are the tiered
scheduler's host tier (policies 1, 2 and 4 place attention on the CPU): the
golden model over CPU tensors, as the reference runs its host functions with
Pallas disabled. They never reach a kernel wrapper.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.quant import dequantize_kv, is_quantized_kv

NEG_INF = -1e30  # large-negative additive mask; avoids NaNs from true -inf rows


def attend(
    q: torch.Tensor,  # [B, Sq, N, D]
    k: torch.Tensor,  # [B, N_kv, Skv, D] (head-major)
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, Sq, Skv] bool — True = attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """General masked attention, fp32 softmax. Returns [B, Sq, N, D]."""
    B, Sq, N, D = q.shape
    Nkv = k.shape[1]
    G = N // Nkv
    scale = scale if scale is not None else D**-0.5
    qg = q.reshape(B, Sq, Nkv, G, D).float() * scale
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float())
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, N, D).to(q.dtype)


def causal_mask(input_mask: torch.Tensor, window: Optional[int] = None) -> torch.Tensor:
    """Causal ∧ padding (∧ sliding-window) mask for prefill: [B, S, S]."""
    S = input_mask.shape[1]
    ones = torch.ones((S, S), dtype=torch.bool, device=input_mask.device)
    causal = torch.tril(ones)
    if window is not None:
        causal &= torch.triu(ones, -(window - 1))
    return causal[None] & input_mask[:, None, :]


def decode_mask(slot_mask: torch.Tensor, length) -> torch.Tensor:
    """Key-validity mask for decode: [B, 1, S_max]."""
    B, S_max = slot_mask.shape
    pos = torch.arange(S_max, device=slot_mask.device)[None, :]
    lengths = torch.as_tensor(length, device=slot_mask.device).expand(B)[:, None]
    return (slot_mask & (pos < lengths))[:, None, :]


class PrefillAttn(NamedTuple):
    """Attention context for a prompt (built once, shared by all layers)."""

    input_mask: torch.Tensor  # [B, S] bool
    window: Optional[int] = None  # sliding-window width (mistral) or None
    bias: Optional[torch.Tensor] = None  # [B, N, S] key-positional bias (ALiBi)

    @property
    def mask(self) -> torch.Tensor:
        """[B, S, S] causal ∧ padding (∧ window), built on demand: the kernel
        path reads only ``input_mask``."""
        return causal_mask(self.input_mask, self.window)


class DecodeAttn(NamedTuple):
    """Attention context for one decode step over the KV cache."""

    slot_mask: torch.Tensor  # [B, S_max] bool
    length: torch.Tensor  # 0-dim int32 (device)
    bias: Optional[torch.Tensor] = None  # [B, N, S_max] key-positional bias (ALiBi)

    @property
    def mask(self) -> torch.Tensor:
        """[B, 1, S_max], built on demand."""
        return decode_mask(self.slot_mask, self.length)


def prefill_attn_ctx(input_mask, window=None, bias=None) -> PrefillAttn:
    return PrefillAttn(input_mask, window, bias)


def decode_attn_ctx(slot_mask, length, window=None, bias=None) -> DecodeAttn:
    """Decode context over the cache's valid slots. ``length`` is past-only (the
    query sits at position ``length``); with ``window``, slots ``<= length - window``
    leave the validity mask so the query sees exactly the last ``window`` positions."""
    if window is not None:
        pos = torch.arange(slot_mask.shape[1], device=slot_mask.device)[None, :]
        slot_mask = slot_mask & (pos > torch.as_tensor(length, device=slot_mask.device) - window)
    return DecodeAttn(slot_mask, length, bias)


def _no_bias(bias) -> None:
    if bias is not None:
        raise NotImplementedError("ALiBi attention biases are not ported yet")


def attend_prefill(q, k, v, ctx: PrefillAttn) -> torch.Tensor:
    """Prefill attention over a left-padded prompt (flash kernel / plain version)."""
    _no_bias(ctx.bias)
    return ca.flash_attention_prefill(q, k, v, ctx.input_mask, window=ctx.window)


def attend_decode_fresh(
    q: torch.Tensor,  # [B, 1, N, D]
    k_fresh: torch.Tensor,  # [B, N_kv, 1, D] (head-major), not quantized
    v_fresh: torch.Tensor,
    k_cache_full,  # [L, B, N_kv, S_max, D] — PAST tokens only (fresh not written)
    v_cache_full,
    layer_idx: int,
    ctx: DecodeAttn,  # slot_mask/length cover PAST tokens only
) -> torch.Tensor:
    """Decode attention over layer ``layer_idx`` of the stacked cache with the
    fresh token merged in the kernel (the cache write happens once per step,
    after all layers: :func:`lia_tpu_torch.models.transformer.decode_layers_scan`).
    Over an INT8 cache the kernel quantizes and dequantizes the fresh K/V
    itself, so attention sees exactly what later steps read back; the
    reference does that round trip before the call (its fresh K/V arrive as
    ``QuantizedKV``), the port's callers pass them unquantized."""
    _no_bias(ctx.bias)
    kf, vf = k_fresh.to(q.dtype), v_fresh.to(q.dtype)
    if is_quantized_kv(k_cache_full):
        return ca.decode_attention_fresh_int8(
            q, kf, vf, k_cache_full.q, k_cache_full.s, v_cache_full.q, v_cache_full.s,
            layer_idx, ctx.slot_mask, ctx.length,
        )
    return ca.decode_attention_fresh(
        q, kf, vf, k_cache_full, v_cache_full, layer_idx, ctx.slot_mask, ctx.length
    )


def attend_decode(q: torch.Tensor, k_cache, v_cache, ctx: DecodeAttn) -> torch.Tensor:
    """Decode attention over one layer plane [B, N_kv, S_max, D] that already
    holds this step's token (write-then-attend: ``ctx.length`` includes it).
    INT8 planes (:class:`QuantizedKV`) are dequantized to q's type first, as
    the reference does; then the ``decode_attention`` kernel (plain version on
    the CPU)."""
    _no_bias(ctx.bias)
    if is_quantized_kv(k_cache):
        k_cache, v_cache = dequantize_kv(k_cache, q.dtype), dequantize_kv(v_cache, q.dtype)
    return ca.decode_attention(q, k_cache, v_cache, ctx.slot_mask, ctx.length)


def attend_prefill_host(q, k, v, ctx: PrefillAttn) -> torch.Tensor:
    """Host-tier prefill attention: the golden model over the causal ∧ padding
    (∧ window) mask."""
    _no_bias(ctx.bias)
    return attend(q, k, v, ctx.mask)


def attend_decode_host(q: torch.Tensor, k_cache, v_cache, ctx: DecodeAttn) -> torch.Tensor:
    """Host-tier decode attention over one layer plane that already holds this
    step's token: the golden model (INT8 planes dequantized to q's type)."""
    _no_bias(ctx.bias)
    if is_quantized_kv(k_cache):
        k_cache, v_cache = dequantize_kv(k_cache, q.dtype), dequantize_kv(v_cache, q.dtype)
    return attend(q, k_cache, v_cache, ctx.mask)
