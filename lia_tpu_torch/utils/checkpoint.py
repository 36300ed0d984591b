"""Parameter initialisation and conversion (port of parts of ``lia_tpu/utils/checkpoint.py``).

Parameter trees are plain nested dicts of tensors with the reference's layout:
decoder layers stacked ``[L, ...]``, projections stored ``[in, out]``.

- :func:`init_dummy_params`: random weights from numpy's ``default_rng`` on the
  host. Leaves are drawn in the reference's order, so an fp32 config gives a tree
  bit-equal to ``lia_tpu.utils.checkpoint.init_dummy_params`` for the same seed
  (the reference draws bf16 leaves with a native generator; this port does not).
- :func:`device_dummy_params`: the same structure and scale, every leaf drawn on
  the device with a ``torch.Generator`` (a host randn of 6.7B parameters is
  minutes; this is seconds).
- :func:`params_from_jax`: the JAX package's tree (numpy or jax arrays) to torch
  tensors, keeping the stacked layout. bf16 leaves convert through their 16-bit
  pattern, so ``ml_dtypes`` is never imported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from lia_tpu_torch.config import Activation, ModelConfig, Norm, torch_dtype

Params = Dict[str, Any]


def _build_tree(
    cfg: ModelConfig,
    w: Callable[..., torch.Tensor],
    zeros: Callable[..., torch.Tensor],
    ones: Callable[..., torch.Tensor],
) -> Params:
    """The decoder-only parameter tree, with leaves drawn in the reference's order."""
    if cfg.encoder_decoder or cfg.family in ("git", "llava"):
        raise NotImplementedError(f"{cfg.family} parameters are not ported yet")
    H, F, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    E = cfg.embed_dim
    QD = cfg.num_heads * cfg.head_dim
    KD = cfg.num_kv_heads * cfg.head_dim

    def norm_p(*lead):
        p = {"scale": ones(*lead, H)}
        if cfg.norm == Norm.LAYERNORM:
            p["bias"] = zeros(*lead, H)
        return p

    attn: Params = {"wq": w(L, H, QD), "wk": w(L, H, KD), "wv": w(L, H, KD), "wo": w(L, QD, H)}
    if cfg.attn_bias:
        attn.update(bq=zeros(L, QD), bk=zeros(L, KD), bv=zeros(L, KD))
    if cfg.o_bias if cfg.o_bias is not None else cfg.attn_bias:
        attn["bo"] = zeros(L, H)
    if cfg.num_experts:
        Ex = cfg.num_experts
        mlp: Params = {
            "router": w(L, H, Ex), "wg": w(L, Ex, H, F), "w1": w(L, Ex, H, F), "w2": w(L, Ex, F, H),
        }
    elif cfg.activation == Activation.SILU:
        mlp = {"wg": w(L, H, F), "w1": w(L, H, F), "w2": w(L, F, H)}
    else:
        mlp = {"w1": w(L, H, F), "w2": w(L, F, H)}
        if cfg.mlp_bias:
            mlp.update(b1=zeros(L, F), b2=zeros(L, H))
    layers: Params = {"ln1": norm_p(L), "attn": attn, "mlp": mlp}
    if not cfg.parallel_shared_norm:
        layers["ln2"] = norm_p(L)
    params: Params = {"embed_tokens": w(cfg.vocab_size, E), "layers": layers}
    if cfg.embed_layernorm:
        params["embed_norm"] = {"scale": ones(H), "bias": zeros(H)}
    if cfg.learned_pos:
        params["embed_positions"] = w(cfg.max_position_embeddings + cfg.pos_offset, H)
    if cfg.word_embed_proj_dim:
        params["proj_in"] = w(E, H)
        params["proj_out"] = w(H, E)
    if cfg.final_norm:
        params["final_norm"] = norm_p()
    if not cfg.tie_embeddings:
        params["lm_head"] = w(E, cfg.vocab_size)
        if cfg.lm_head_bias:
            params["lm_head_bias"] = zeros(cfg.vocab_size)
    return params


def init_dummy_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.006) -> Params:
    """Random weights (normal × ``scale``, zero biases, unit norm gains) as CPU tensors."""
    rng = np.random.default_rng(seed)
    dt = torch_dtype(cfg.dtype)

    def w(*shape):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt)

    return _build_tree(cfg, w, zeros, ones)


def device_dummy_params(
    cfg: ModelConfig, seed: int = 0, scale: float = 0.006, device=None
) -> Params:
    """:func:`init_dummy_params`'s tree drawn directly on ``device`` (default ``"cuda"``)."""
    device = torch.device("cuda" if device is None else device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(scale)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    return _build_tree(cfg, w, zeros, ones)


def _leaf_from_jax(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable host copy (jax arrays export read-only buffers)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, identified by name
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"cannot convert a {a.dtype} leaf")
    return torch.from_numpy(a)


def params_from_jax(tree: Any) -> Any:
    """Convert the JAX package's parameter tree (nested dicts of numpy or jax
    arrays) to CPU tensors with the same keys, shapes, dtypes and values."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "fmt"):  # lia_tpu.ops.quant.QuantizedWeight
        raise NotImplementedError("quantized weights are not ported yet")
    return _leaf_from_jax(tree)


def to_device(tree: Any, device, dtype=None) -> Any:
    """Move every leaf of a parameter tree to ``device`` (optionally casting floats)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)
