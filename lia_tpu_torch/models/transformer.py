"""Functional transformer decoder (port of ``lia_tpu/models/transformer.py``,
the OPT main path: prefill, the fused-merge decode step, and the per-layer
write-then-attend decode layer that the tiered scheduler runs).

The model is a pure function over a parameter tree whose decoder layers are
stacked ``[L, ...]``, as in the reference. Where the reference scans over the
stacked layers (``lax.scan``), the port loops in Python and indexes each layer's
views; the decode loop keeps the cache read-only inside the layer loop and
commits every layer's fresh K/V with one write per step, as the reference does.

The projections, MLP and lm_head are plain matmuls (cuBLAS through torch),
as they are plain XLA dots in the reference, or, for a quantized weight
record, :func:`lia_tpu_torch.ops.quant.quantized_matmul` (the quantized-matmul
kernels); attention goes through the front doors of
:mod:`lia_tpu_torch.ops.attention`. RoPE, ALiBi and mixture of experts are not
ported yet and raise.

The layer functions take ``host=True`` for the tiered scheduler's host tier
(policies 1, 2 and 4 run layers or attention on the CPU): attention is then
the golden model (:func:`lia_tpu_torch.ops.attention.attend_prefill_host`,
:func:`~lia_tpu_torch.ops.attention.attend_decode_host`), as the reference
runs its host functions with Pallas disabled; on CPU tensors the quantized
linears take the plain matmuls (:func:`lia_tpu_torch.ops.quant.quantized_matmul`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from lia_tpu_torch.config import Activation, ModelConfig, Norm, torch_dtype
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.norms import layernorm, rmsnorm
from lia_tpu_torch.ops.quant import is_quantized, matmul_f32, quantized_matmul

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features the port does not run yet."""
    missing = [
        name for name, on in (
            ("RoPE", cfg.rope), ("ALiBi", cfg.alibi), ("mixture of experts", cfg.num_experts),
            ("encoder-decoder", cfg.encoder_decoder), ("vision tower", cfg.vision_hidden),
        ) if on
    ]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported yet")


def _layer(v: Any, idx: int) -> Any:
    if isinstance(v, dict):
        return layer_params(v, idx)
    if is_quantized(v):
        return v.map(lambda t: t[idx])
    return v[idx]


def layer_params(layers: Params, idx: int) -> Params:
    """Layer ``idx`` of the stacked layer tree, as views (a quantized record's
    codes, scales and zero-points each indexed)."""
    return {k: _layer(v, idx) for k, v in layers.items()}


# ---------------------------------------------------------------------------
# Linear / norm helpers
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: Any, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) for a ``[in, out]`` weight or a quantized record; returns x.dtype.

    The reference accumulates in fp32, adds the bias in fp32 and rounds once.
    A quantized product comes back in fp32 and takes the bias the same way.
    ``addmm`` folds the bias into the same product, so it rounds once too; the
    sums run in another order (and cuBLAS may reduce bf16 split-K partials in
    bf16), so bf16 results agree with the reference to a tolerance."""
    if is_quantized(w):
        y = quantized_matmul(x, w)
        if b is None:
            return y.to(x.dtype)
        # y + b in fp32, rounded once to x's type: one pass over y (the eager
        # decode loop pays for every launch)
        return torch.add(y, b, out=torch.empty_like(y, dtype=x.dtype))
    x2 = x.reshape(-1, x.shape[-1])
    y = x2 @ w if b is None else torch.addmm(b, x2, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == Norm.RMSNORM:
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)


def activation_fn(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == Activation.RELU:
        return F.relu(x)
    if cfg.activation == Activation.GELU:  # exact erf gelu (HF "gelu")
        return F.gelu(x)
    if cfg.activation == Activation.GELU_NEW:  # tanh approximation (HF "gelu_new")
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------


def qkv_project(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor):
    """Project hidden [B, S, H] → q [B, S, N, D] and head-major k/v [B, N_kv, S, D]."""
    if cfg.rope:
        raise NotImplementedError("RoPE is not ported yet")
    B, S, _ = x.shape
    N, Nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = lp["attn"]
    if "wqkv" in a:  # fused projection (ops/fuse.py): one matmul, sliced apart
        qd, kd = N * D, Nkv * D
        y = linear(x, a["wqkv"], a.get("bqkv"))
        q = y[..., :qd].reshape(B, S, N, D)
        k = y[..., qd : qd + kd].reshape(B, S, Nkv, D)
        v = y[..., qd + kd :].reshape(B, S, Nkv, D)
    else:
        q = linear(x, a["wq"], a.get("bq")).reshape(B, S, N, D)
        k = linear(x, a["wk"], a.get("bk")).reshape(B, S, Nkv, D)
        v = linear(x, a["wv"], a.get("bv")).reshape(B, S, Nkv, D)
    return q, k.transpose(1, 2), v.transpose(1, 2)


def mlp(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    m = lp["mlp"]
    if cfg.num_experts:
        raise NotImplementedError("mixture-of-experts MLPs are not ported yet")
    if cfg.activation == Activation.SILU:  # SwiGLU
        if "wg1" in m:
            y = linear(x, m["wg1"]).float()
            gate, up = F.silu(y[..., : cfg.ffn_size]), y[..., cfg.ffn_size :]
        else:
            gate = F.silu(linear(x, m["wg"]).float())
            up = linear(x, m["w1"]).float()
        return linear((gate * up).to(x.dtype), m["w2"], m.get("b2"))
    h = activation_fn(cfg, linear(x, m["w1"], m.get("b1")))
    return linear(h, m["w2"], m.get("b2"))


def attn_in(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor):
    """LN1 + QKV projection. Returns (q, k, v) with head-major k/v."""
    h = norm(cfg, lp["ln1"], x) if cfg.pre_norm else x
    return qkv_project(cfg, lp, h, positions)


def attn_core_prefill(cfg, q, k, v, k_layer, v_layer, start, attn_ctx: att.PrefillAttn, host: bool = False):
    """Prompt attention over the fresh chunk, then the cache write (in place)."""
    attn_out = (att.attend_prefill_host if host else att.attend_prefill)(q, k, v, attn_ctx)
    k_layer, v_layer = kvc.update_layer(k_layer, v_layer, k, v, start)
    return attn_out, k_layer, v_layer


def attn_core_decode(cfg, q, k, v, k_layer, v_layer, start, attn_ctx: att.DecodeAttn, host: bool = False):
    """Decode attention over one layer plane, update then attend: the fresh K/V
    are written at ``start`` (in place) and ``attn_ctx`` covers the cache
    INCLUDING them. The piece policies 2/4 run on the host over host KV."""
    k_layer, v_layer = kvc.update_layer(k_layer, v_layer, k, v, start)
    attn_out = (att.attend_decode_host if host else att.attend_decode)(q, k_layer, v_layer, attn_ctx)
    return attn_out, k_layer, v_layer


def attn_post_mlp(cfg: ModelConfig, lp: Params, residual: torch.Tensor, attn_out: torch.Tensor):
    """Out-proj + residual + LN2 + MLP + residual."""
    B, S = attn_out.shape[:2]
    h = linear(attn_out.reshape(B, S, -1), lp["attn"]["wo"], lp["attn"].get("bo"))
    if cfg.parallel_residual:
        mlp_norm = lp["ln1"] if cfg.parallel_shared_norm else lp["ln2"]
        return residual + h + mlp(cfg, lp, norm(cfg, mlp_norm, residual))
    x = residual + h
    if not cfg.pre_norm:
        x = norm(cfg, lp["ln1"], x)
    residual = x
    h = norm(cfg, lp["ln2"], x) if cfg.pre_norm else x
    x = residual + mlp(cfg, lp, h)
    if not cfg.pre_norm:
        x = norm(cfg, lp["ln2"], x)
    return x


def decoder_layer_prefill(cfg, lp, x, k_layer, v_layer, start, attn_ctx, positions, host: bool = False):
    """One decoder layer over a full (bucketed) prompt."""
    q, k, v = attn_in(cfg, lp, x, positions)
    attn_out, k_layer, v_layer = attn_core_prefill(cfg, q, k, v, k_layer, v_layer, start, attn_ctx, host)
    return attn_post_mlp(cfg, lp, x, attn_out), k_layer, v_layer


def decoder_layer_decode(cfg, lp, x, k_layer, v_layer, start, attn_ctx, positions, host: bool = False):
    """One decoder layer for one decode step, write-then-attend over its own
    cache plane (``start`` = the slot written, ``attn_ctx`` includes it)."""
    q, k, v = attn_in(cfg, lp, x, positions)
    attn_out, k_layer, v_layer = attn_core_decode(cfg, q, k, v, k_layer, v_layer, start, attn_ctx, host)
    return attn_post_mlp(cfg, lp, x, attn_out), k_layer, v_layer


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor, positions: torch.Tensor):
    """Token + learned position embedding. Ids outside the tables are clamped, as
    the reference's ``mode="clip"`` gather does: an out-of-range pad id must not
    bring a NaN row into attention."""
    table = params["embed_tokens"]
    x = table[tokens.clamp(0, table.shape[0] - 1)]
    if "proj_in" in params:
        x = linear(x, params["proj_in"])
    if cfg.embed_layernorm:
        x = norm(cfg, params["embed_norm"], x)
    if cfg.learned_pos:
        # OPT's offset-2 quirk: table row = position + 2; pads clamp to row 1
        pos_table = params["embed_positions"]
        pos = (positions.clamp(min=-1) + cfg.pos_offset).clamp(0, pos_table.shape[0] - 1)
        x = x + pos_table[pos]
    return x.to(torch_dtype(cfg.dtype))


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Hidden → vocab logits (fp32). Callers slice to the last token first.

    A quantized head (a transposed copy for tied embeddings) goes through
    :func:`quantized_matmul`; an int4 head's vocab is padded to a multiple of
    128, and the pad columns are sliced off before anything reads the logits
    (a zero logit could win an argmax)."""
    if "final_norm" in params:
        x = norm(cfg, params["final_norm"], x)
    if "proj_out" in params:
        x = linear(x, params["proj_out"])
    w = params["lm_head"] if "lm_head" in params else params["embed_tokens"].T
    if is_quantized(w):
        y = quantized_matmul(x, w)[..., : cfg.vocab_size]
    else:
        y = matmul_f32(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])
    if "lm_head_bias" in params:
        y = y + params["lm_head_bias"].float()
    return y


# ---------------------------------------------------------------------------
# Full-model prefill / decode
# ---------------------------------------------------------------------------


def prefill_layers(cfg, layers: Params, x, cache: kvc.KVCache, ctx: att.PrefillAttn, positions, n_layers: int):
    """Decoder layers ``0 .. n_layers-1`` of a stacked tree over a prompt, each
    writing its plane of ``cache`` in place at ``cache.length``; returns the
    hidden states. The cache's mask and length are not advanced."""
    for i in range(n_layers):
        x, _, _ = decoder_layer_prefill(
            cfg, layer_params(layers, i), x,
            kvc.index_layer_kv(cache.k, i), kvc.index_layer_kv(cache.v, i), cache.length, ctx, positions,
        )
    return x


def prefill_positions(input_mask: torch.Tensor) -> torch.Tensor:
    """Pad-aware positions of a left-padded prompt."""
    return torch.cumsum(input_mask.to(torch.int32), dim=1) - 1


def run_prefill_layers(cfg, params, tokens, input_mask, cache: kvc.KVCache):
    """Embed + all decoder layers; returns (hidden [B, S, H], cache). The cache is
    written in place and returned with its length advanced."""
    check_supported(cfg)
    positions = prefill_positions(input_mask)
    x = embed(cfg, params, tokens, positions)
    ctx = att.prefill_attn_ctx(input_mask, cfg.sliding_window)
    x = prefill_layers(cfg, params["layers"], x, cache, ctx, positions, cfg.num_layers)
    return x, kvc.advance(cache, input_mask, tokens.shape[1])


def prefill(cfg, params, tokens, input_mask, cache: kvc.KVCache) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Run the prompt; returns (last-token logits [B, V] fp32, cache)."""
    x, cache = run_prefill_layers(cfg, params, tokens, input_mask, cache)
    return lm_head(cfg, params, x[:, -1:, :])[:, 0, :], cache


def decode_layers_scan(cfg, layers: Params, x, ck, cv, start, ctx: att.DecodeAttn, positions, n_layers: int):
    """All decode layers for one token. The cache is read-only inside the loop:
    each layer's attention merges the fresh token in the kernel, and one write
    per step commits every layer's fresh K/V (:func:`kvc.write_token_all`, which
    quantizes them for an INT8 cache; the int8 kernel gives attention the same
    round trip). ``ctx``/``start`` describe the cache BEFORE this token."""
    k_new, v_new = [], []
    for idx in range(n_layers):
        lp = layer_params(layers, idx)
        residual = x
        q, k, v = attn_in(cfg, lp, x, positions)
        attn_out = att.attend_decode_fresh(q, k, v, ck, cv, idx, ctx)
        x = attn_post_mlp(cfg, lp, residual, attn_out)
        k_new.append(k)
        v_new.append(v)
    ck = kvc.write_token_all(ck, torch.stack(k_new), start)
    cv = kvc.write_token_all(cv, torch.stack(v_new), start)
    return x, ck, cv


def decode_step(cfg, params, tokens, positions, cache: kvc.KVCache) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One decode step: tokens/positions [B, 1] → (logits [B, V] fp32, cache)."""
    check_supported(cfg)
    x = embed(cfg, params, tokens, positions)
    ctx = att.decode_attn_ctx(cache.mask, cache.length, cfg.sliding_window)
    x, k_new, v_new = decode_layers_scan(
        cfg, params["layers"], x, cache.k, cache.v, cache.length, ctx, positions, cfg.num_layers
    )
    cache = cache._replace(k=k_new, v=v_new)
    B = tokens.shape[0]
    cache = kvc.advance(cache, torch.ones((B, 1), dtype=torch.bool, device=tokens.device), 1)
    return lm_head(cfg, params, x)[:, 0, :], cache
