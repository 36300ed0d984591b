"""Attention ops (port of ``lia_tpu/ops/attention.py``).

Layouts as in the reference: hidden [B, S, H]; Q [B, S, N, D]; K/V head-major
[B, N_kv, S_kv, D]. GQA reshapes Q to [B, S, N_kv, G, D]; K/V heads are never
replicated.

:func:`attend` is the general masked golden model. The front doors
:func:`attend_prefill`, :func:`attend_prefill_cached`,
:func:`attend_decode_fresh`, :func:`attend_decode` and
:func:`attend_decode_beam` go through the kernel wrappers of
:mod:`lia_tpu_torch.ops.cuda_attention`: the CUDA kernel for a CUDA tensor,
its plain version for a CPU tensor. ALiBi families pass their per-head
slopes (:func:`alibi_slopes`, fp32 [N] on the tensors' device): a kernel adds
``slope * key_pos`` to each score itself, and a plain version builds the
reference's own [B, N, S] bias (:func:`alibi_prefill_bias`,
:func:`alibi_slot_bias`, :func:`alibi_beam_bias`). :func:`attend_decode_beam_golden`
keeps the reference's fallback for the beam cache (the per-beam concatenated
view through :func:`attend`) as the tests' golden side.

:func:`attend_prefill_host` and :func:`attend_decode_host` are the tiered
scheduler's host tier (policies 1, 2 and 4 place attention on the CPU): the
golden model's masked softmax over CPU tensors (decode through the CPU's
``scaled_dot_product_attention``), as the reference runs its host functions
with Pallas disabled. They never reach a kernel wrapper; with ALiBi they add
the reference's bias (:attr:`PrefillAttn.bias`, :attr:`DecodeAttn.bias`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import functools
import math

import torch
import torch.nn.functional as F

from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.quant import dequantize_kv, is_quantized_kv

NEG_INF = -1e30  # large-negative additive mask; avoids NaNs from true -inf rows


def attend(
    q: torch.Tensor,  # [B, Sq, N, D]
    k: torch.Tensor,  # [B, N_kv, Skv, D] (head-major)
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, Sq, Skv] bool — True = attend
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,  # [B, N, Skv] key-positional (ALiBi)
) -> torch.Tensor:
    """General masked attention, fp32 softmax. Returns [B, Sq, N, D].
    ``bias`` is a per-(head, key) additive logit term; ALiBi's relative form
    ``-slope * (q_pos - k_pos)`` reduces to the key-only ``slope * k_pos``
    because the per-row shift cancels in the softmax."""
    B, Sq, N, D = q.shape
    Nkv = k.shape[1]
    G = N // Nkv
    scale = scale if scale is not None else D**-0.5
    qg = q.reshape(B, Sq, Nkv, G, D).float() * scale
    scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float())
    if bias is not None:
        scores = scores + bias.reshape(B, Nkv, G, 1, k.shape[2]).float()
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


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes, fp32 [n_heads] (the closed form of the ALiBi
    paper, as HF's build_alibi_tensor: powers of 2^(-8/p), p the largest power
    of two <= n_heads, then the odd powers of the 2p base for the other heads).
    Made once a (head count, device), so a decode step copies nothing from the
    host."""
    return _alibi_slopes(n_heads, str(torch.device(device if device is not None else "cpu")))


@functools.lru_cache(maxsize=None)
def _alibi_slopes(n_heads: int, device: str) -> torch.Tensor:
    p = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(p) - 3)))
    slopes = [base ** (i + 1) for i in range(p)]
    if p < n_heads:
        base2 = 2.0 ** (-(2.0 ** -(math.log2(2 * p) - 3)))
        slopes += [base2 ** i for i in range(1, 2 * (n_heads - p), 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi_bias(slopes: torch.Tensor, key_pos: torch.Tensor) -> torch.Tensor:
    """Key-positional ALiBi bias [B, N, S] (fp32) from logical key positions [B, S]."""
    return slopes.float()[None, :, None] * key_pos.float()[:, None, :]


def alibi_prefill_bias(n_heads: int, positions: torch.Tensor, input_mask: torch.Tensor) -> torch.Tensor:
    """Prefill bias [B, N, S]: the keys' pad-aware logical positions (pads 0,
    masked out of attention anyway)."""
    return alibi_bias(alibi_slopes(n_heads, positions.device), positions.clamp(min=0) * input_mask)


def slot_positions(slot_mask: torch.Tensor, length=None, fresh_pos=None) -> torch.Tensor:
    """Logical positions of cache slots [B, S_max]: a valid slot's rank among
    the valid slots (0 elsewhere); with ``fresh_pos`` [B, 1], the (still
    invalid) slot at ``length`` (scalar or [B]) holds the fresh token's."""
    pos = (torch.cumsum(slot_mask.to(torch.int32), dim=1) - 1) * slot_mask
    if fresh_pos is not None:
        B = slot_mask.shape[0]
        at = torch.as_tensor(length, device=slot_mask.device).long().expand(B)
        pos = pos.scatter(1, at[:, None], fresh_pos.to(pos.dtype).reshape(B, 1))
    return pos


def alibi_slot_bias(n_heads: int, slot_mask: torch.Tensor, length=None, fresh_pos=None) -> torch.Tensor:
    """Bias over cache slots [B, N, S_max] at :func:`slot_positions`."""
    return alibi_bias(alibi_slopes(n_heads, slot_mask.device), slot_positions(slot_mask, length, fresh_pos))


def alibi_beam_bias(n_heads: int, prompt_mask: torch.Tensor, nb: int, T_max: int,
                    positions: torch.Tensor) -> torch.Tensor:
    """Bias over the beam cache's [prompt | tail | fresh] layout [B0 * nb, N,
    S_p + T_max + 1]: a prompt slot's rank among its group's valid slots, tail
    slot t at ``real_len + t``, the fresh token at ``positions`` [B0 * nb, 1]
    (the reference's ``_alibi_beam_bias``)."""
    pmask = prompt_mask.repeat_interleave(nb, dim=0)
    real_len = pmask.to(torch.int32).sum(dim=1, keepdim=True)
    tail_pos = real_len + torch.arange(T_max, dtype=torch.int32, device=pmask.device)[None, :]
    key_pos = torch.cat([slot_positions(pmask).to(torch.int32), tail_pos,
                         positions.to(torch.int32).reshape(-1, 1)], dim=1)
    return alibi_bias(alibi_slopes(n_heads, pmask.device), key_pos)


class PrefillAttn(NamedTuple):
    """Attention context for a prompt (built once, shared by all layers)."""

    input_mask: torch.Tensor  # [B, S] bool
    window: Optional[int] = None  # sliding-window width (mistral) or None
    slopes: Optional[torch.Tensor] = None  # [N] fp32 ALiBi slopes, or None

    @property
    def mask(self) -> torch.Tensor:
        """[B, S, S] causal ∧ padding (∧ window), built on demand: the kernel
        path reads only ``input_mask``."""
        return causal_mask(self.input_mask, self.window)

    @property
    def bias(self) -> Optional[torch.Tensor]:
        """The reference's ALiBi bias [B, N, S] (:func:`alibi_prefill_bias`),
        built on demand for the plain paths; None without slopes."""
        if self.slopes is None:
            return None
        return alibi_prefill_bias(self.slopes.shape[0], torch.cumsum(self.input_mask.to(torch.int32), dim=1) - 1,
                                  self.input_mask)


class DecodeAttn(NamedTuple):
    """Attention context for one decode step over the KV cache."""

    slot_mask: torch.Tensor  # [B, S_max] bool
    length: torch.Tensor  # 0-dim int32 (device)
    slopes: Optional[torch.Tensor] = None  # [N] fp32 ALiBi slopes, or None

    @property
    def mask(self) -> torch.Tensor:
        """[B, 1, S_max], built on demand."""
        return decode_mask(self.slot_mask, self.length)

    @property
    def bias(self) -> Optional[torch.Tensor]:
        """The reference's ALiBi bias over the valid slots below the length
        [B, N, S_max] (:func:`alibi_slot_bias`: each slot's rank), built on
        demand for the host tier; None without slopes."""
        if self.slopes is None:
            return None
        return alibi_slot_bias(self.slopes.shape[0], self.mask[:, 0])


def prefill_attn_ctx(input_mask, window=None, slopes=None) -> PrefillAttn:
    return PrefillAttn(input_mask, window, slopes)


def decode_attn_ctx(slot_mask, length, window=None, slopes=None) -> DecodeAttn:
    """Decode context over the cache's valid slots. ``length`` (scalar, or [B]
    with one length per row) is past-only (the query sits at position
    ``length``); with ``window``, slots ``<= length - window`` leave the validity
    mask so the query sees exactly the last ``window`` positions."""
    if window is not None:
        pos = torch.arange(slot_mask.shape[1], device=slot_mask.device)[None, :]
        lengths = torch.as_tensor(length, device=slot_mask.device).reshape(-1, 1)
        slot_mask = slot_mask & (pos > lengths - window)
    return DecodeAttn(slot_mask, length, slopes)


def attend_prefill(q, k, v, ctx: PrefillAttn) -> torch.Tensor:
    """Prefill attention over a left-padded prompt (flash kernel / plain version)."""
    return ca.flash_attention_prefill(q, k, v, ctx.input_mask, window=ctx.window, slopes=ctx.slopes)


def attend_prefill_cached(
    q: torch.Tensor,  # [B, C, N, D] chunk queries
    k_cache,  # [B, N_kv, S_max, D] cache plane (chunk already written)
    v_cache,
    base,  # int, 0-dim or [B]: cache length before the chunk
    slot_mask: torch.Tensor,  # [B, S_max] validity incl. the chunk's rows
    window: Optional[int] = None,
    slopes: Optional[torch.Tensor] = None,  # [N] ALiBi slopes
) -> torch.Tensor:
    """Chunk-over-cache causal attention (chunked prefill, prefix-cache
    admission): row t attends the valid slots up to ``base + t``. An INT8 plane
    is dequantized to q's type first, as the reference does; then the
    ``flash_attention_cached`` kernel (plain version on the CPU)."""
    if is_quantized_kv(k_cache):
        k_cache, v_cache = dequantize_kv(k_cache, q.dtype), dequantize_kv(v_cache, q.dtype)
    return ca.flash_attention_cached(q, k_cache, v_cache, base, slot_mask, window=window, slopes=slopes)


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
    kf, vf = k_fresh.to(q.dtype), v_fresh.to(q.dtype)
    if is_quantized_kv(k_cache_full):
        return ca.decode_attention_fresh_int8(
            q, kf, vf, k_cache_full.q, k_cache_full.s, v_cache_full.q, v_cache_full.s,
            layer_idx, ctx.slot_mask, ctx.length, slopes=ctx.slopes,
        )
    return ca.decode_attention_fresh(
        q, kf, vf, k_cache_full, v_cache_full, layer_idx, ctx.slot_mask, ctx.length, slopes=ctx.slopes
    )


def attend_decode(q: torch.Tensor, k_cache, v_cache, ctx: DecodeAttn) -> torch.Tensor:
    """Decode attention over one layer plane [B, N_kv, S_max, D] that already
    holds this step's token (write-then-attend: ``ctx.length`` includes it).
    INT8 planes (:class:`QuantizedKV`) are dequantized to q's type first, as
    the reference does; then the ``decode_attention`` kernel (plain version on
    the CPU)."""
    if is_quantized_kv(k_cache):
        k_cache, v_cache = dequantize_kv(k_cache, q.dtype), dequantize_kv(v_cache, q.dtype)
    return ca.decode_attention(q, k_cache, v_cache, ctx.slot_mask, ctx.length, slopes=ctx.slopes)


def attend_decode_beam(
    q: torch.Tensor,  # [B0*nb, 1, N, D]
    k_fresh: torch.Tensor,  # [B0*nb, N_kv, 1, D] (head-major); over an INT8 cache, dequantized
    v_fresh: torch.Tensor,
    cache,  # lia_tpu_torch.ops.kv_cache.BeamKVCache
    layer_idx: int,
    slopes: Optional[torch.Tensor] = None,  # [N] ALiBi slopes
) -> torch.Tensor:
    """Grouped-beam decode attention: the group's shared prompt plane ∪ this
    beam's generated tail ∪ the fresh token, one online softmax, through the
    ``decode_beam_attention`` kernel (``decode_beam_attention_int8`` over an
    INT8 cache, whose fresh K/V the caller passes already dequantized, as the
    reference does); their plain versions on the CPU. Per-group prompt starts
    (``prompt_len - popcount(prompt_mask[g])``) are counted on the device."""
    kp, vp, kt, vt = cache.prompt_k, cache.prompt_v, cache.tail_k, cache.tail_v
    kf, vf = k_fresh.to(q.dtype), v_fresh.to(q.dtype)
    lens = (cache.prompt_mask, cache.prompt_len, cache.tail_len, cache.nb)
    if is_quantized_kv(kp):
        return ca.decode_beam_attention_int8(q, kf, vf, kp.q, kp.s, vp.q, vp.s, kt.q, kt.s, vt.q, vt.s,
                                             layer_idx, *lens, slopes=slopes)
    return ca.decode_beam_attention(q, kf, vf, kp, vp, kt, vt, layer_idx, *lens, slopes=slopes)


def attend_decode_beam_golden(q, k_fresh, v_fresh, cache, layer_idx: int, bias=None) -> torch.Tensor:
    """The reference's golden fallback for the beam cache: expand the prompt
    per beam, concatenate [group prompt | own tail | fresh] and run
    :func:`attend` over the prompt mask, the valid tail slots and the fresh
    token (an INT8 cache dequantized to q's type first), with ``bias`` over
    that layout (:func:`alibi_beam_bias`)."""
    B = q.shape[0]
    nb = cache.nb

    def layer(plane):
        if is_quantized_kv(plane):
            return dequantize_kv(type(plane)(plane.q[layer_idx], plane.s[layer_idx]), q.dtype)
        return plane[layer_idx]

    group = torch.arange(B, device=q.device) // nb
    kt = layer(cache.tail_k)
    k_all = torch.cat([layer(cache.prompt_k)[group], kt, k_fresh.to(q.dtype)], dim=2)
    v_all = torch.cat([layer(cache.prompt_v)[group], layer(cache.tail_v), v_fresh.to(q.dtype)], dim=2)
    T_max = kt.shape[2]
    tail_valid = (torch.arange(T_max, device=q.device) < cache.tail_len)[None, :].expand(B, T_max)
    mask = torch.cat([cache.prompt_mask[group], tail_valid, torch.ones((B, 1), dtype=torch.bool, device=q.device)],
                     dim=1)[:, None, :]
    return attend(q, k_all, v_all, mask, bias=bias)


def attend_prefill_host(q, k, v, ctx: PrefillAttn) -> torch.Tensor:
    """Host-tier prefill attention: the golden model over the causal ∧ padding
    (∧ window) mask, with the reference's ALiBi bias where the context has
    slopes."""
    return attend(q, k, v, ctx.mask, bias=ctx.bias)


def attend_decode_host(q: torch.Tensor, k_cache, v_cache, ctx: DecodeAttn) -> torch.Tensor:
    """Host-tier decode attention over one layer plane that already holds this
    step's token (INT8 planes dequantized to q's type): the golden model's
    masked softmax, computed by the CPU's ``scaled_dot_product_attention``
    (fp32 softmax, masked slots at NEG_INF as in :func:`attend`) over the
    slots up to the longest row's length. The kv heads' G query heads are
    its query rows, so K/V are never repeated. With ALiBi the additive mask
    is the reference's bias (:attr:`DecodeAttn.bias`), masked slots still at
    NEG_INF, and the product runs in fp32: a bias of thousands rounded to
    bf16 would move the logits by units. On a serving batch's 1024-slot
    planes the golden einsums took ~13x as long."""
    n = min(int(torch.as_tensor(ctx.length).max()), ctx.slot_mask.shape[1])
    mask = ctx.mask[..., :n]  # [B, 1, n]
    if is_quantized_kv(k_cache):
        k_cache = dequantize_kv(type(k_cache)(k_cache.q[:, :, :n], k_cache.s[:, :, :n]), q.dtype)
        v_cache = dequantize_kv(type(v_cache)(v_cache.q[:, :, :n], v_cache.s[:, :, :n]), q.dtype)
    else:
        k_cache, v_cache = k_cache[:, :, :n], v_cache[:, :, :n]
    B, _, N, D = q.shape
    Nkv = k_cache.shape[1]
    dt = q.dtype if ctx.slopes is None else torch.float32
    if ctx.slopes is None:
        bias = torch.zeros(mask.shape, dtype=dt, device=q.device)[:, None]  # [B, 1, 1, n]
    else:
        bias = ctx.bias[..., :n].reshape(B, Nkv, N // Nkv, n)
    bias = bias.masked_fill(~mask[:, None], NEG_INF)
    out = F.scaled_dot_product_attention(q.reshape(B, Nkv, N // Nkv, D).to(dt), k_cache.to(dt), v_cache.to(dt),
                                         attn_mask=bias)
    return out.reshape(B, 1, N, D).to(q.dtype)
