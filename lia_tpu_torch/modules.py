"""The public fused-op API, the ``ipex.llm.modules`` analog (port of
``lia_tpu/modules.py``).

Building blocks for users who assemble their own models, each a function
over tensors (or a re-export of the op behind it): ``RotaryEmbedding``,
``RMSNorm``, ``FastLayerNorm``, ``VarlenAttention``, ``PagedAttention``
and ``IndirectAccessKVCacheAttention`` (:func:`rotary_embedding`,
:func:`rms_norm`, :func:`fast_layer_norm`, :func:`varlen_attention`,
:func:`paged_attention`, :func:`indirect_access_kv_cache_attention`) and
the ``Linear*`` epilogue fusions (``linear_*``). On the card the attention
entries run the port's kernels: :func:`indirect_access_kv_cache_attention`
the decode kernel with the fresh token merged (``decode_attention_fresh``,
or ``decode_attention_fresh_int8`` over an int8 cache), :func:`paged_attention`
``paged_decode_attention``. :func:`varlen_attention` is plain code, as in
the reference.

The ``linear_*`` functions compose :func:`lia_tpu_torch.models.transformer.linear`
with an epilogue; ``w`` may be a raw ``[K, N]`` weight or a
:class:`~lia_tpu_torch.ops.quant.QuantizedWeight`, which goes through the
quantized-matmul kernels. Beams reorder the cache up front
(:func:`beam_reorder`) instead of reading through an indirection table.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lia_tpu_torch.models.transformer import linear
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.kv_cache import KVCache, beam_reorder, init_cache
from lia_tpu_torch.ops.norms import layernorm as fast_layer_norm
from lia_tpu_torch.ops.norms import rmsnorm as rms_norm
from lia_tpu_torch.ops.paged import PagedKVCache, init_paged_cache, paged_attention, reshape_and_cache
from lia_tpu_torch.ops.rope import apply_rope

__all__ = [
    "rotary_embedding",
    "rms_norm",
    "fast_layer_norm",
    "varlen_attention",
    "indirect_access_kv_cache_attention",
    "PagedKVCache",
    "init_paged_cache",
    "reshape_and_cache",
    "paged_attention",
    "KVCache",
    "init_cache",
    "beam_reorder",
    "linear_silu",
    "linear_relu",
    "linear_gelu",
    "linear_new_gelu",
    "linear_mul",
    "linear_add",
    "linear_add_add",
    "linear2_silu_mul",
]


# -- MHA building blocks ------------------------------------------------------


def rotary_embedding(
    query: torch.Tensor,  # [B, S, N, D]
    key: torch.Tensor,  # [B, S, N_kv, D]
    positions: torch.Tensor,  # [B, S] int
    theta: float = 10000.0,
    rotary_dim: Optional[int] = None,
    interleaved: bool = False,
):
    """Rotate Q and K (``RotaryEmbedding``); ``interleaved`` is the GPT-J
    rotate-every-two pairing."""
    return (apply_rope(query, positions, theta, rotary_dim, interleaved),
            apply_rope(key, positions, theta, rotary_dim, interleaved))


def varlen_attention(
    query: torch.Tensor,  # [T, N, D]: sequences concatenated along tokens
    key: torch.Tensor,  # [T, N_kv, D]
    value: torch.Tensor,  # [T, N_kv, D]
    seqlens: torch.Tensor,  # [B] int, sum <= T
    scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Packed variable-length attention over concatenated sequences
    (``VarlenAttention``): each token attends only within its own segment
    (and causally when ``causal``); tokens past ``sum(seqlens)`` are padding
    and come back as zeros. Softmax in fp32; returns ``[T, N, D]`` in the
    query's type."""
    T, N, D = query.shape
    n_kv = key.shape[1]
    if n_kv != N:  # GQA/MQA: the kv heads broadcast over their query groups
        key = key.repeat_interleave(N // n_kv, dim=1)
        value = value.repeat_interleave(N // n_kv, dim=1)
    sc = scale if scale is not None else 1.0 / (D**0.5)
    bounds = torch.cumsum(torch.as_tensor(seqlens, device=query.device), 0)
    tok = torch.arange(T, device=query.device)
    seg = (tok[:, None] >= bounds[None, :]).sum(-1)  # segment id; padding lands in segment B
    valid = tok < bounds[-1]
    same = (seg[:, None] == seg[None, :]) & valid[:, None] & valid[None, :]
    if causal:
        same = same & (tok[:, None] >= tok[None, :])
    logits = torch.einsum("tnd,snd->nts", query.float(), key.float()) * sc
    logits = torch.where(same[None], logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(valid[None, :, None], probs, 0.0)  # fully masked padding rows
    return torch.einsum("nts,snd->tnd", probs, value.float()).to(query.dtype)


def indirect_access_kv_cache_attention(
    query: torch.Tensor,  # [B, 1, N, D]: a decode step
    key: torch.Tensor,  # [B, 1, N_kv, D] fresh K
    value: torch.Tensor,  # [B, 1, N_kv, D] fresh V
    cache: KVCache,
    layer_idx: int,
    beam_idx: Optional[torch.Tensor] = None,  # [B]: the beam reorder, first
):
    """Decode attention over the preallocated cache
    (``IndirectAccessKVCacheAttention``): attends over layer ``layer_idx``'s
    valid slots and the fresh token at slot ``cache.length``, then writes
    the fresh K/V there (in place); returns ``(attn_out [B, 1, N, D],
    cache)``. The kernel merges the fresh token itself (over an int8 cache
    it quantizes and dequantizes it first, as the slot will read back), so
    the result is the reference's write-then-attend. Call once per layer,
    then :func:`lia_tpu_torch.ops.kv_cache.advance` once per step."""
    if beam_idx is not None:
        cache = beam_reorder(cache, beam_idx)
    k_new, v_new = key.transpose(1, 2), value.transpose(1, 2)  # head-major [B, N_kv, 1, D]
    ctx = att.decode_attn_ctx(cache.mask, cache.length)
    out = att.attend_decode_fresh(query, k_new, v_new, cache.k, cache.v, layer_idx, ctx)
    kvc.write_token(cache.k, k_new, layer_idx, cache.length)
    kvc.write_token(cache.v, v_new, layer_idx, cache.length)
    return out, cache


# -- Linear epilogue fusions ----------------------------------------------------


def linear_silu(x, w, b=None):
    """silu(x @ w + b) (``LinearSilu``)."""
    return F.silu(linear(x, w, b))


def linear_relu(x, w, b=None):
    """relu(x @ w + b) (``LinearRelu``)."""
    return F.relu(linear(x, w, b))


def linear_gelu(x, w, b=None):
    """erf gelu(x @ w + b) (``LinearGelu``)."""
    return F.gelu(linear(x, w, b))


def linear_new_gelu(x, w, b=None):
    """tanh gelu(x @ w + b) (``LinearNewGelu``, GPT-J)."""
    return F.gelu(linear(x, w, b), approximate="tanh")


def linear_mul(x, w, other, b=None):
    """(x @ w + b) * other (``LinearMul``)."""
    return linear(x, w, b) * other


def linear_add(x, w, other, b=None):
    """(x @ w + b) + other (``LinearAdd``, the residual fold)."""
    return linear(x, w, b) + other


def linear_add_add(x, w, o1, o2, b=None):
    """(x @ w + b) + o1 + o2 (``LinearAddAdd``)."""
    return linear(x, w, b) + o1 + o2


def linear2_silu_mul(x, w_gate, w_up, b_gate=None, b_up=None):
    """silu(x @ w_gate) * (x @ w_up) (``Linear2SiluMul``, the SwiGLU gate)."""
    return F.silu(linear(x, w_gate, b_gate)) * linear(x, w_up, b_up)
