"""Parameter initialisation and conversion (port of parts of ``lia_tpu/utils/checkpoint.py``).

Parameter trees are plain nested dicts of tensors with the reference's layout:
decoder layers stacked ``[L, ...]``, projections stored ``[in, out]``. A
quantized weight is a :class:`~lia_tpu_torch.ops.quant.QuantizedWeight` record.

- :func:`init_dummy_params`: random weights from numpy on the host, leaves in
  the reference's order. An fp32 config gives a tree bit-equal to
  ``lia_tpu.utils.checkpoint.init_dummy_params`` for the same seed (the
  reference draws bf16 leaves with a native generator; this port does not).
  With ``quant``, the layer weights are drawn directly as codes and scales
  with the reference's numpy fallbacks (:func:`randn_int8`,
  :func:`randn_int4`), bit-equal to its tree wherever its native library is
  absent, and the head is quantized as the reference does.
- :func:`device_dummy_params`: the same structure, every leaf drawn on the
  device with a ``torch.Generator`` (a host randn of 6.7B parameters is
  minutes; this is seconds).
- :func:`params_from_jax`: the JAX package's tree (numpy or jax arrays,
  quantized records included) to torch tensors, keeping the stacked layout.
  bf16 leaves convert through their 16-bit pattern, so ``ml_dtypes`` is never
  imported.
- :func:`params_from_hf_state_dict`: a Hugging Face OPT, llama-layout, GPT-J
  or GPT-NeoX state dict to the tree.
- :func:`to_device` places a tree on the accelerator; :func:`to_host` keeps it
  in host memory in the layout ``to_device`` gives it there, for the tiered
  scheduler's streamed layers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from lia_tpu_torch.config import Activation, ModelConfig, Norm, QuantConfig, torch_dtype
from lia_tpu_torch.ops.quant import (
    QuantizedWeight, head_config, is_quantized, quantize_head_2d, quantize_tied_head,
)

Params = Dict[str, Any]


def randn_int8(rows: int, cols: int, group: int, seed: int, scale: float):
    """Normal(0, scale) weights drawn directly as group-quantized int8: codes
    int8 ``[rows, cols]`` and scales f32 ``[rows // group, cols]`` (the
    reference's numpy fallback of its native generator)."""
    rng = np.random.default_rng(seed)
    q = np.clip(np.rint(rng.standard_normal((rows, cols), dtype=np.float32) / 3.0 * 127.0),
                -127, 127).astype(np.int8)
    s = np.full((rows // group, cols), scale * 3.0 / 127.0, np.float32)
    return q, s


def randn_int4(rows: int, cols: int, group: int, seed: int, scale: float):
    """Dummy weights drawn directly as packed nibbles: uint8 ``[rows // 2, cols]``
    and scales f32 ``[rows // group, cols]`` (the reference's numpy fallback)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 16, (rows, cols)).astype(np.uint8)
    packed = (q[0::2] & 0xF) | (q[1::2] << 4)
    s = np.full((rows // group, cols), scale / 4.3205, np.float32)
    return packed, s


def _formats(quant: QuantConfig):
    """(int4/nf4 format, int8 format) of directly drawn dummy weights."""
    dyn = quant.act_quant == "dynamic"
    fmt4 = "woq_nf4" if quant.weight_dtype == "nf4" else ("woq_int4_dyn" if dyn else "woq_int4")
    return fmt4, "woq_int8_dyn" if dyn else "woq_int8"


def _build_tree(
    cfg: ModelConfig,
    w: Callable[..., torch.Tensor],
    zeros: Callable[..., torch.Tensor],
    ones: Callable[..., torch.Tensor],
    wq: Optional[Callable[..., Any]] = None,
    head: Optional[Callable[[Params], Any]] = None,
) -> Params:
    """The decoder-only parameter tree, with leaves drawn in the reference's
    order. ``wq`` draws the stacked layer matmul weights (default ``w``);
    ``head``, given the tree so far, returns the (quantized) lm_head or None."""
    if cfg.encoder_decoder or cfg.family in ("git", "llava"):
        raise NotImplementedError(f"{cfg.family} parameters are not ported yet")
    wq = wq or w
    H, F, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    E = cfg.embed_dim
    QD = cfg.num_heads * cfg.head_dim
    KD = cfg.num_kv_heads * cfg.head_dim

    def norm_p(*lead):
        p = {"scale": ones(*lead, H)}
        if cfg.norm == Norm.LAYERNORM:
            p["bias"] = zeros(*lead, H)
        return p

    attn: Params = {"wq": wq(L, H, QD), "wk": wq(L, H, KD), "wv": wq(L, H, KD), "wo": wq(L, QD, H)}
    if cfg.attn_bias:
        attn.update(bq=zeros(L, QD), bk=zeros(L, KD), bv=zeros(L, KD))
    if cfg.o_bias if cfg.o_bias is not None else cfg.attn_bias:
        attn["bo"] = zeros(L, H)
    if cfg.num_experts:
        Ex = cfg.num_experts
        mlp: Params = {
            "router": w(L, H, Ex), "wg": wq(L, Ex, H, F), "w1": wq(L, Ex, H, F), "w2": wq(L, Ex, F, H),
        }
    elif cfg.activation == Activation.SILU:
        mlp = {"wg": wq(L, H, F), "w1": wq(L, H, F), "w2": wq(L, F, H)}
    else:
        mlp = {"w1": wq(L, H, F), "w2": wq(L, F, H)}
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
    qhead = head(params) if head else None
    if not cfg.tie_embeddings:
        params["lm_head"] = qhead if qhead is not None else w(E, cfg.vocab_size)
        if cfg.lm_head_bias:
            params["lm_head_bias"] = zeros(cfg.vocab_size)
    elif qhead is not None:
        params["lm_head"] = qhead
    return params


def _quantized(quant: Optional[QuantConfig]) -> bool:
    return quant is not None and quant.enabled


def init_dummy_params(
    cfg: ModelConfig, seed: int = 0, scale: float = 0.006, quant: Optional[QuantConfig] = None
) -> Params:
    """Random weights (normal × ``scale``, zero biases, unit norm gains) as CPU
    tensors; with ``quant``, layer weights drawn directly as codes + scales and
    the head quantized (a transposed copy for tied embeddings), as the
    reference's ``init_dummy_params(quant=...)``."""
    rng = np.random.default_rng(seed)
    dt = torch_dtype(cfg.dtype)
    counter = [seed]  # the reference's per-leaf seed for its native draws

    def w(*shape):
        if cfg.dtype == "bfloat16":
            counter[0] += 1  # the reference draws each bf16 leaf from a fresh seed
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dt)

    def wq(*shape):
        *lead, K, N = shape
        nl = int(np.prod(lead))
        g = K if quant.group_size <= 0 else quant.group_size
        counter[0] += 1
        fmt4, fmt8 = _formats(quant)
        if quant.weight_dtype in ("int4", "nf4"):
            q, s = randn_int4(nl * K, N, g, counter[0], scale)
            return QuantizedWeight(torch.from_numpy(q.reshape(*lead, K // 2, N)),
                                   torch.from_numpy(s.reshape(*lead, K // g, N)), fmt4)
        q, s = randn_int8(nl * K, N, g, counter[0], scale)
        return QuantizedWeight(torch.from_numpy(q.reshape(*lead, K, N)),
                               torch.from_numpy(s.reshape(*lead, K // g, N)), fmt8)

    def head(params):
        if not _quantized(quant) or not quant.quant_lm_head:
            return None
        E, V = cfg.embed_dim, cfg.vocab_size
        if cfg.tie_embeddings:
            return quantize_tied_head(params["embed_tokens"], quant)
        if E % (E if quant.group_size <= 0 else quant.group_size):
            return None
        if quant.weight_dtype == "int4" and V % 128:
            return quantize_head_2d(w(E, V), quant)
        return wq(E, V)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt)

    return _build_tree(cfg, w, zeros, ones, wq if _quantized(quant) else None, head)


def device_dummy_params(
    cfg: ModelConfig, seed: int = 0, scale: float = 0.006, device=None,
    quant: Optional[QuantConfig] = None,
) -> Params:
    """:func:`init_dummy_params`'s tree drawn directly on ``device`` (default ``"cuda"``).

    Quantized records have the reference's shapes and formats. Their codes are
    random (int8 normal × 127/3, clipped; int4/NF4 nibbles uniform in 1..15) and their
    scales ``scale·3/127`` (int8) or ``scale/4.3205`` (int4, NF4), so the
    dequantized weights have about the spread of the fp dummy and 32 layers of
    them stay finite. The head takes the layout :func:`head_config` gives it
    (int4 heads padded to a multiple of 128), drawn the same way."""
    device = torch.device("cuda" if device is None else device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(scale)

    def codes(weight_dtype: str, *shape):
        *lead, K, N = shape
        out = torch.empty((*lead, K if weight_dtype == "int8" else K // 2, N), dtype=torch.int8
                          if weight_dtype == "int8" else torch.uint8, device=device)
        for part in out if out.dim() > 2 else [out]:  # a layer at a time: the draws are 4x the codes
            if weight_dtype == "int8":
                a = torch.randn((K, N), generator=gen, device=device).mul_(127.0 / 3.0)
                part.copy_(a.round_().clamp_(-127, 127))
            else:  # nibbles in 1..15, as the host generator draws them: int4 codes c - 8 of mean 0
                c = torch.randint(1, 16, (K, N), generator=gen, device=device, dtype=torch.uint8)
                part.copy_(c[: K // 2] | (c[K // 2 :] << 4))
        return out

    def record(weight_dtype: str, group: int, fmt: str, *shape):
        *lead, K, N = shape
        ng = 1 if group <= 0 else K // group
        sv = scale * 3.0 / 127.0 if weight_dtype == "int8" else scale / 4.3205
        s = torch.full((*lead, ng, N), sv, dtype=torch.float32, device=device)
        return QuantizedWeight(codes(weight_dtype, *shape), s, fmt)

    def wq(*shape):
        fmt4, fmt8 = _formats(quant)
        fmt = fmt8 if quant.weight_dtype == "int8" else fmt4
        return record(quant.weight_dtype, quant.group_size, fmt, *shape)

    def head(params):
        if not _quantized(quant) or not quant.quant_lm_head:
            return None
        E, V = cfg.embed_dim, cfg.vocab_size
        if not cfg.tie_embeddings and E % (E if quant.group_size <= 0 else quant.group_size):
            return None
        if not cfg.tie_embeddings and not (quant.weight_dtype == "int4" and V % 128):
            return wq(E, V)
        hqc, Vp = head_config(E, V, quant)
        fmt4, fmt8 = _formats(hqc)
        return record(hqc.weight_dtype, hqc.group_size, fmt8 if hqc.weight_dtype == "int8" else fmt4, E, Vp)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    return _build_tree(cfg, w, zeros, ones, wq if _quantized(quant) else None, head)


def _leaf_from_jax(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable host copy (jax arrays export read-only buffers)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, identified by name
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"cannot convert a {a.dtype} leaf")
    return torch.from_numpy(a)


def params_from_jax(tree: Any) -> Any:
    """Convert the JAX package's parameter tree (nested dicts of numpy or jax
    arrays and ``QuantizedWeight`` records) to CPU tensors with the same keys,
    shapes, dtypes and values; a record keeps its format and its ``z``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "fmt"):  # lia_tpu.ops.quant.QuantizedWeight
        return QuantizedWeight(_leaf_from_jax(tree.q), _leaf_from_jax(tree.s), tree.fmt,
                               None if tree.z is None else _leaf_from_jax(tree.z))
    return _leaf_from_jax(tree)


# Formats whose int8 × int8 product runs in torch._int_mm on the card.
_INT_MM_FORMATS = ("woq_int8_dyn", "static_int8")


def _to_device_record(rec: QuantizedWeight, device) -> QuantizedWeight:
    rec = rec.map(lambda t: t.to(device=device))
    if rec.fmt in _INT_MM_FORMATS and rec.q.is_cuda:
        # column-major codes under the same [..., K, N] shape: on the H100,
        # torch._int_mm runs several times faster over a column-major weight
        # than over a row-major one (chip_smoke.py's int_mm_layout phase)
        rec = rec._replace(q=rec.q.transpose(-1, -2).contiguous().transpose(-1, -2))
    return rec


def to_device(tree: Any, device, dtype=None) -> Any:
    """Move every leaf of a parameter tree to ``device``, optionally casting the
    float leaves; a quantized record's codes, scales and zero-points move as
    they are (int8 × int8 formats' codes in the column-major layout
    ``torch._int_mm`` runs fastest on)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if is_quantized(tree):
        return _to_device_record(tree, device)
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)


def to_host(tree: Any, device) -> Any:
    """A parameter tree in host memory, laid out as :func:`to_device` lays it out
    on ``device`` (the accelerator the tree will be streamed to): int8 × int8
    formats' codes column-major when ``device`` is CUDA, every other leaf with
    its strides kept. A leaf already in host memory in that layout is kept as
    it is (no copy); pinning is the weight manager's, which packs each
    streamed layer into one pinned buffer."""
    if isinstance(tree, dict):
        return {k: to_host(v, device) for k, v in tree.items()}
    if is_quantized(tree):
        if torch.device(device).type == "cuda" and tree.fmt in _INT_MM_FORMATS:
            tree = tree._replace(q=tree.q.transpose(-1, -2).contiguous().transpose(-1, -2))
        return tree.map(lambda t: t.cpu())
    return tree.cpu()


def params_from_hf_state_dict(cfg: ModelConfig, sd: Dict[str, Any]) -> Params:
    """Map a Hugging Face state dict (numpy arrays or tensors) into the stacked
    tree, for OPT, the llama layout (llama, mistral, qwen2 with its qkv
    biases; not mixture of experts), GPT-J and GPT-NeoX. HF linears store
    ``weight`` as [out, in]; the tree stores [in, out]. Values go through fp32
    and are cast once to ``cfg.dtype``, as the reference's mapping does. Other
    families are not ported yet."""
    dt = torch_dtype(cfg.dtype)
    L = cfg.num_layers

    def get(key) -> np.ndarray:
        a = sd[key]
        return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)

    def cast(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt)

    def raw(key):
        return cast(get(key))

    def wT(key):
        return cast(get(key).T)

    def stack(fmt, transpose=False):
        f = wT if transpose else raw
        return torch.stack([f(fmt.format(i)) for i in range(L)])

    if cfg.family == "llama" and not cfg.num_experts:
        return _params_llama(cfg, raw, wT, stack)
    if cfg.family == "gptj":
        return _params_gptj(raw, wT, stack)
    if cfg.family == "gpt_neox":
        return _params_gpt_neox(cfg, get, cast, raw, wT, stack)
    if cfg.family != "opt":
        raise NotImplementedError(f"{cfg.family}: only the OPT, llama-layout, GPT-J and GPT-NeoX state-dict "
                                  "mappings are ported")

    pre = "model.decoder."
    params: Params = {"embed_tokens": raw(pre + "embed_tokens.weight"),
                      "embed_positions": raw(pre + "embed_positions.weight")}
    if cfg.word_embed_proj_dim:
        params["proj_in"] = wT(pre + "project_in.weight")
        params["proj_out"] = wT(pre + "project_out.weight")
    if cfg.final_norm:
        params["final_norm"] = {"scale": raw(pre + "final_layer_norm.weight"),
                                "bias": raw(pre + "final_layer_norm.bias")}
    lp = pre + "layers.{}."
    params["layers"] = {
        "ln1": {"scale": stack(lp + "self_attn_layer_norm.weight"),
                "bias": stack(lp + "self_attn_layer_norm.bias")},
        "attn": {
            "wq": stack(lp + "self_attn.q_proj.weight", True),
            "wk": stack(lp + "self_attn.k_proj.weight", True),
            "wv": stack(lp + "self_attn.v_proj.weight", True),
            "wo": stack(lp + "self_attn.out_proj.weight", True),
            "bq": stack(lp + "self_attn.q_proj.bias"),
            "bk": stack(lp + "self_attn.k_proj.bias"),
            "bv": stack(lp + "self_attn.v_proj.bias"),
            "bo": stack(lp + "self_attn.out_proj.bias"),
        },
        "ln2": {"scale": stack(lp + "final_layer_norm.weight"),
                "bias": stack(lp + "final_layer_norm.bias")},
        "mlp": {
            "w1": stack(lp + "fc1.weight", True),
            "b1": stack(lp + "fc1.bias"),
            "w2": stack(lp + "fc2.weight", True),
            "b2": stack(lp + "fc2.bias"),
        },
    }
    return params


def _params_llama(cfg: ModelConfig, raw, wT, stack) -> Params:
    """The llama layout (HF modeling_llama; mistral and qwen2 share it, qwen2
    with q/k/v biases and no o_proj bias; a LayerNorm config also maps its
    norms' biases)."""
    ln_bias = cfg.norm == Norm.LAYERNORM
    pre = "model."
    params: Params = {"embed_tokens": raw(pre + "embed_tokens.weight"),
                      "final_norm": {"scale": raw(pre + "norm.weight")}}
    if ln_bias:
        params["final_norm"]["bias"] = raw(pre + "norm.bias")
    if not cfg.tie_embeddings:
        params["lm_head"] = wT("lm_head.weight")
    lp = pre + "layers.{}."
    attn = {
        "wq": stack(lp + "self_attn.q_proj.weight", True),
        "wk": stack(lp + "self_attn.k_proj.weight", True),
        "wv": stack(lp + "self_attn.v_proj.weight", True),
        "wo": stack(lp + "self_attn.o_proj.weight", True),
    }
    if cfg.attn_bias:
        for n in ("q", "k", "v"):
            attn[f"b{n}"] = stack(lp + f"self_attn.{n}_proj.bias")
    if cfg.o_bias if cfg.o_bias is not None else cfg.attn_bias:
        attn["bo"] = stack(lp + "self_attn.o_proj.bias")
    ln1 = {"scale": stack(lp + "input_layernorm.weight")}
    ln2 = {"scale": stack(lp + "post_attention_layernorm.weight")}
    if ln_bias:
        ln1["bias"] = stack(lp + "input_layernorm.bias")
        ln2["bias"] = stack(lp + "post_attention_layernorm.bias")
    mlp = {
        "wg": stack(lp + "mlp.gate_proj.weight", True),
        "w1": stack(lp + "mlp.up_proj.weight", True),
        "w2": stack(lp + "mlp.down_proj.weight", True),
    }
    params["layers"] = {"ln1": ln1, "attn": attn, "ln2": ln2, "mlp": mlp}
    return params


def _params_gptj(raw, wT, stack) -> Params:
    """GPT-J (HF modeling_gptj): one shared ln_1, separate q/k/v projections
    without biases, a biased fc_in/fc_out MLP, an untied lm_head with a bias."""
    lp = "transformer.h.{}."
    return {
        "embed_tokens": raw("transformer.wte.weight"),
        "final_norm": {"scale": raw("transformer.ln_f.weight"), "bias": raw("transformer.ln_f.bias")},
        "lm_head": wT("lm_head.weight"),
        "lm_head_bias": raw("lm_head.bias"),
        "layers": {
            "ln1": {"scale": stack(lp + "ln_1.weight"), "bias": stack(lp + "ln_1.bias")},
            "attn": {
                "wq": stack(lp + "attn.q_proj.weight", True),
                "wk": stack(lp + "attn.k_proj.weight", True),
                "wv": stack(lp + "attn.v_proj.weight", True),
                "wo": stack(lp + "attn.out_proj.weight", True),
            },
            "mlp": {
                "w1": stack(lp + "mlp.fc_in.weight", True),
                "b1": stack(lp + "mlp.fc_in.bias"),
                "w2": stack(lp + "mlp.fc_out.weight", True),
                "b2": stack(lp + "mlp.fc_out.bias"),
            },
        },
    }


def _params_gpt_neox(cfg: ModelConfig, get, cast, raw, wT, stack) -> Params:
    """GPT-NeoX / Pythia (HF modeling_gpt_neox): a fused query_key_value whose
    out-dim runs head by head as [q | k | v], de-interleaved into wq/wk/wv;
    a separate post-attention LayerNorm; untied ``embed_out``."""
    N, D, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    lp = "gpt_neox.layers.{}."
    qkv = {n: ([], []) for n in "qkv"}
    for i in range(L):
        w = get(lp.format(i) + "attention.query_key_value.weight").reshape(N, 3 * D, -1)
        b = get(lp.format(i) + "attention.query_key_value.bias").reshape(N, 3 * D)
        for j, n in enumerate("qkv"):
            qkv[n][0].append(cast(w[:, j * D:(j + 1) * D, :].reshape(N * D, -1).T))
            qkv[n][1].append(cast(b[:, j * D:(j + 1) * D].reshape(N * D)))
    attn = {}
    for n, (ws, bs) in qkv.items():
        attn[f"w{n}"], attn[f"b{n}"] = torch.stack(ws), torch.stack(bs)
    attn["wo"] = stack(lp + "attention.dense.weight", True)
    attn["bo"] = stack(lp + "attention.dense.bias")
    return {
        "embed_tokens": raw("gpt_neox.embed_in.weight"),
        "final_norm": {"scale": raw("gpt_neox.final_layer_norm.weight"),
                       "bias": raw("gpt_neox.final_layer_norm.bias")},
        "lm_head": wT("embed_out.weight"),
        "layers": {
            "ln1": {"scale": stack(lp + "input_layernorm.weight"), "bias": stack(lp + "input_layernorm.bias")},
            "attn": attn,
            "ln2": {"scale": stack(lp + "post_attention_layernorm.weight"),
                    "bias": stack(lp + "post_attention_layernorm.bias")},
            "mlp": {
                "w1": stack(lp + "mlp.dense_h_to_4h.weight", True),
                "b1": stack(lp + "mlp.dense_h_to_4h.bias"),
                "w2": stack(lp + "mlp.dense_4h_to_h.weight", True),
                "b2": stack(lp + "mlp.dense_4h_to_h.bias"),
            },
        },
    }
