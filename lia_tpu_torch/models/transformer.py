"""Functional transformer decoder (port of ``lia_tpu/models/transformer.py``,
the OPT main path: prefill, the fused-merge decode step, the per-layer
write-then-attend decode layer that the tiered scheduler runs, continuous
batching's chunked prefill and ragged decode step, the grouped-beam decode
step and the scoring pass).

The model is a pure function over a parameter tree whose decoder layers are
stacked ``[L, ...]``, as in the reference. Where the reference scans over the
stacked layers (``lax.scan``), the port loops in Python and indexes each layer's
views; the decode loop keeps the cache read-only inside the layer loop and
commits every layer's fresh K/V with one write per step, as the reference does.

The projections, MLP and lm_head are plain matmuls (cuBLAS through torch),
as they are plain XLA dots in the reference, or, for a quantized weight
record, :func:`lia_tpu_torch.ops.quant.quantized_matmul` (the quantized-matmul
kernels); attention goes through the front doors of
:mod:`lia_tpu_torch.ops.attention`. RoPE (:mod:`lia_tpu_torch.ops.rope`)
rotates Q and K before the head-major transpose for the families the port
holds against the reference (:func:`check_supported`); ALiBi and mixture of
experts are not ported yet and raise.

Two gated routes, off by default (:mod:`lia_tpu_torch.ops.dispatch`), as in
the reference: with the stacked-W4A8 gate, :func:`decode_layers_scan` hands
each layer its ``woq_int4_dyn`` / ``woq_int4z_dyn`` weights as references
into the stack (:class:`lia_tpu_torch.ops.quant.QuantizedWeightRef`); with
the fused-MLP gate, :func:`attn_post_mlp` runs a pre-norm layer's MLP block
that fits the kernel in one launch (:func:`_fused_mlp_viable`).

The layer functions take ``host=True`` for the tiered scheduler's host tier
(policies 1, 2 and 4 run layers or attention on the CPU): attention is then
the golden model (:func:`lia_tpu_torch.ops.attention.attend_prefill_host`,
:func:`~lia_tpu_torch.ops.attention.attend_decode_host`), as the reference
runs its host functions with Pallas disabled; on CPU tensors the quantized
linears take the plain matmuls (:func:`lia_tpu_torch.ops.quant.quantized_matmul`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from lia_tpu_torch.config import Activation, ModelConfig, Norm, torch_dtype
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import dispatch
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.norms import layernorm, rmsnorm
from lia_tpu_torch.ops.quant import (QuantizedKV, dequantize_kv, is_quantized, is_quantized_kv, matmul_f32,
                                     quantize_kv, quantized_matmul, stackable_ref, stacked_ref)
from lia_tpu_torch.ops.rope import rope_angles, rotate

Params = Dict[str, Any]

# families whose RoPE layouts the port's tests hold against the reference
ROPE_FAMILIES = ("llama", "gptj", "gpt_neox")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features the port does not run yet."""
    # stablelm is the llama layout with LayerNorm: not held against the reference yet
    stablelm = cfg.family == "llama" and cfg.norm == Norm.LAYERNORM
    rope_missing = cfg.rope and (cfg.family not in ROPE_FAMILIES or stablelm)
    missing = [
        name for name, on in (
            (f"RoPE in the {cfg.family} layout", rope_missing), ("ALiBi", cfg.alibi),
            ("mixture of experts", cfg.num_experts), ("encoder-decoder", cfg.encoder_decoder),
            ("vision tower", cfg.vision_hidden),
        ) if on
    ]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported yet")


def _layer(v: Any, idx: int, stack_index: Optional[torch.Tensor]) -> Any:
    if isinstance(v, dict):
        return layer_params(v, idx, stack_index)
    if stack_index is not None and stackable_ref(v):
        return stacked_ref(v, idx, stack_index)
    if is_quantized(v):
        return v.map(lambda t: t[idx])
    return v[idx]


def layer_params(layers: Params, idx: int, stack_index: Optional[torch.Tensor] = None) -> Params:
    """Layer ``idx`` of the stacked layer tree, as views (a quantized record's
    codes, scales and zero-points each indexed). Given ``stack_index`` (a
    device ``arange(L)``, :func:`layer_index`), a record the stacked W4A8
    kernel takes stays whole, as a :class:`~lia_tpu_torch.ops.quant.QuantizedWeightRef`."""
    return {k: _layer(v, idx, stack_index) for k, v in layers.items()}


@functools.lru_cache(maxsize=None)
def layer_index(n: int, device: str) -> torch.Tensor:
    """A device ``arange(n)`` (int32), made once per device: the layer indices
    the stacked W4A8 kernel reads, so no decode step copies one from the host."""
    return torch.arange(n, dtype=torch.int32, device=device)


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
    """Project hidden [B, S, H] → q [B, S, N, D] and head-major k/v [B, N_kv, S, D],
    q and k rotated (RoPE) at ``positions`` [B, S] before the transpose."""
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
    if cfg.rope:  # one set of angles for q and k
        cos, sin = rope_angles(positions, cfg.rope_theta, cfg.rotary_dim or D)
        q, k = rotate(q, cos, sin, cfg.rope_interleaved), rotate(k, cos, sin, cfg.rope_interleaved)
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
    if cfg.pre_norm and _fused_mlp_viable(cfg, lp, x):
        return _fused_mlp_call(cfg, lp, x)
    residual = x
    h = norm(cfg, lp["ln2"], x) if cfg.pre_norm else x
    x = residual + mlp(cfg, lp, h)
    if not cfg.pre_norm:
        x = norm(cfg, lp["ln2"], x)
    return x


def _fused_mlp_viable(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> bool:
    """The fused-MLP route (the reference's rules, :func:`lia_tpu_torch.ops.cuda_mlp.fused_mlp`):
    the gate on, separate unquantized ``w1`` (and ``wg``) and ``w2`` (not the
    fused ``wg1``), at most 256 rows, H % 128 == 0 and F % 512 == 0. The
    type is not a rule: on the card the kernel takes bf16 and raises for
    another type."""
    if not dispatch.fused_mlp_enabled():
        return False
    m = lp["mlp"]
    if "w1" not in m or "wg1" in m:
        return False
    if any(is_quantized(m.get(k)) for k in ("w1", "wg", "w2") if m.get(k) is not None):
        return False
    B, S, H = x.shape
    return B * S <= 256 and H % 128 == 0 and m["w1"].shape[-1] % 512 == 0


def _fused_mlp_call(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    from lia_tpu_torch.ops.cuda_mlp import fused_mlp

    B, S, H = x.shape
    m, ln = lp["mlp"], lp["ln2"]
    swiglu = cfg.activation == Activation.SILU
    y = fused_mlp(
        x.reshape(B * S, H), ln["scale"], ln.get("bias"), m["w1"], m.get("b1"),
        m["wg"] if swiglu else None, m["w2"], m.get("b2"),
        activation=cfg.activation.value, rms=cfg.norm == Norm.RMSNORM, eps=cfg.norm_eps,
    )
    return y.reshape(B, S, H)


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


def score_logprobs(cfg, params, tokens, input_mask, cache: kvc.KVCache) -> torch.Tensor:
    """Per-position next-token log-probs for scoring (lm-eval loglikelihood):
    [B, S, V] fp32, entry [b, t] scoring token[b, t + 1]."""
    x, _ = run_prefill_layers(cfg, params, tokens, input_mask, cache)
    return torch.log_softmax(lm_head(cfg, params, x).float(), dim=-1)


def prefill_chunk(cfg, params, tokens, chunk_mask, cache: kvc.KVCache) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Run ONE chunk of a longer prompt against the existing cache: tokens and
    chunk_mask [B, C] (False only as a left-pad prefix of a first chunk, so
    validity stays contiguous). Logical positions continue from the real
    tokens cached so far; each layer writes the chunk into its plane at
    ``cache.length`` (in place) and attends over the valid slots up to each
    row (:func:`lia_tpu_torch.ops.attention.attend_prefill_cached`). Returns the
    chunk's last-token logits [B, V] fp32 and the cache, its mask and length
    advanced."""
    check_supported(cfg)
    C = tokens.shape[1]
    base = cache.length
    prev_real = cache.mask.to(torch.int32).sum(dim=1)
    positions = prev_real[:, None] + torch.cumsum(chunk_mask.to(torch.int32), dim=1) - 1
    x = embed(cfg, params, tokens, positions)
    cache = kvc.advance(cache, chunk_mask, C)  # the mask now covers the chunk's slots
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        kl, vl = kvc.index_layer_kv(cache.k, i), kvc.index_layer_kv(cache.v, i)
        q, k, v = attn_in(cfg, lp, x, positions)
        kvc.update_layer(kl, vl, k, v, base)
        attn_out = att.attend_prefill_cached(q, kl, vl, base, cache.mask, cfg.sliding_window)
        x = attn_post_mlp(cfg, lp, x, attn_out)
    return lm_head(cfg, params, x[:, -1:, :])[:, 0, :], cache


def decode_layers_scan(cfg, layers: Params, x, ck, cv, start, ctx: att.DecodeAttn, positions, n_layers: int):
    """All decode layers for one token. The cache is read-only inside the loop:
    each layer's attention merges the fresh token in the kernel, and one write
    per step commits every layer's fresh K/V (:func:`kvc.write_token_all`, which
    quantizes them for an INT8 cache; the int8 kernel gives attention the same
    round trip). ``ctx``/``start`` describe the cache BEFORE this token. With
    the stacked-W4A8 gate on, each ``woq_int4_dyn`` / ``woq_int4z_dyn`` record
    reaches layer ``idx`` as a reference into its stack, the layer index read
    from device memory (the reference's ``_split_stacked_quant``)."""
    stack_index = layer_index(n_layers, str(x.device)) if dispatch.stacked_w4a8_enabled() else None
    k_new, v_new = [], []
    for idx in range(n_layers):
        lp = layer_params(layers, idx, stack_index)
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


def decode_step_ragged(cfg, params, tokens, logical_pos, cache: kvc.KVCache, active) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One decode step over a ragged batch (continuous batching): every row has
    its own cache length (``cache.length`` [B]) and logical position
    (``logical_pos`` [B]). Inactive rows still compute (fixed shapes), but
    their writes never become valid slots and their lengths do not advance
    (:func:`lia_tpu_torch.ops.kv_cache.advance_ragged`). Returns (logits [B, V]
    fp32, cache)."""
    check_supported(cfg)
    positions = logical_pos[:, None]
    x = embed(cfg, params, tokens, positions)
    ctx = att.decode_attn_ctx(cache.mask, cache.length, cfg.sliding_window)
    x, k_new, v_new = decode_layers_scan(
        cfg, params["layers"], x, cache.k, cache.v, cache.length, ctx, positions, cfg.num_layers
    )
    cache = kvc.advance_ragged(cache._replace(k=k_new, v=v_new), active)
    return lm_head(cfg, params, x)[:, 0, :], cache


def _stack_kv(parts):
    """Per-layer fresh K or V [B, N_kv, 1, D] (tensors or QuantizedKV) → [L, ...]."""
    if is_quantized_kv(parts[0]):
        return QuantizedKV(torch.stack([p.q for p in parts]), torch.stack([p.s for p in parts]))
    return torch.stack(parts)


def beam_fresh_kv(k: torch.Tensor, v: torch.Tensor, quantized: bool, dtype):
    """A beam layer's fresh K/V as the tail stores them and as attention sees
    them: over an INT8 cache quantized first and dequantized to ``dtype``, so
    attention sees exactly what later steps read back from the tail. Returns
    (k stored, v stored, k attended, v attended)."""
    if not quantized:
        return k, v, k, v
    kq, vq = quantize_kv(k), quantize_kv(v)
    return kq, vq, dequantize_kv(kq, dtype), dequantize_kv(vq, dtype)


def beam_decode_layers_scan(cfg, layers: Params, x, cache: kvc.BeamKVCache, positions, n_layers: int):
    """All decode layers for one token over the grouped beam cache
    (:class:`lia_tpu_torch.ops.kv_cache.BeamKVCache`), read-only inside the
    loop: each layer attends over its group's prompt, its own tail and the
    fresh token (:func:`lia_tpu_torch.ops.attention.attend_decode_beam`), and
    one commit per step writes every layer's fresh K/V into the tail and
    advances ``tail_len`` (:func:`lia_tpu_torch.ops.kv_cache.beam_commit_token`).
    Returns (hidden, cache)."""
    quantized = is_quantized_kv(cache.tail_k)
    k_new, v_new = [], []
    for idx in range(n_layers):
        lp = layer_params(layers, idx)
        residual = x
        q, k, v = attn_in(cfg, lp, x, positions)
        ks, vs, kf, vf = beam_fresh_kv(k, v, quantized, x.dtype)
        attn_out = att.attend_decode_beam(q, kf, vf, cache, idx)
        x = attn_post_mlp(cfg, lp, residual, attn_out)
        k_new.append(ks)
        v_new.append(vs)
    return x, kvc.beam_commit_token(cache, _stack_kv(k_new), _stack_kv(v_new))


def beam_decode_step(cfg, params, tokens, positions, cache: kvc.BeamKVCache) -> Tuple[torch.Tensor, kvc.BeamKVCache]:
    """One beam decode step over the grouped cache: tokens/positions [B0*nb, 1]
    → (logits [B0*nb, V] fp32, cache)."""
    check_supported(cfg)
    x = embed(cfg, params, tokens, positions)
    x, cache = beam_decode_layers_scan(cfg, params["layers"], x, cache, positions, cfg.num_layers)
    return lm_head(cfg, params, x)[:, 0, :], cache
