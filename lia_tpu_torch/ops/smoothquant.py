"""SmoothQuant's activation-outlier migration, its alpha autotune and the
static-INT8 (W8A8) calibration flow (port of ``lia_tpu/ops/smoothquant.py``).

Per-input-channel scales ``s = act_max^alpha / w_max^(1-alpha)`` move
activation outliers into the weights before quantization: exact at fp (the
preceding norm's affine takes ``1/s``, the consuming weights' input rows
``s``), and it tightens the quantization of the norm-fed projections (q/k/v
after ln1, w1/wg after ln2).

Calibration runs the fp model over sample prompts layer by layer
(:func:`tapped_layer`: the port's ``T.embed``, ``T.norm``,
``T.qkv_project``, ``T.attn_core_prefill`` — the flash prefill kernel on the
card — ``T.linear`` and ``T.activation_fn``) and records per-channel
activation maxima at each linear's input; the reference runs the same layer
body under a ``lax.scan``. Everything runs on the tree's device: the card by
default, the CPU in tests. :func:`apply_smoothquant` folds, then the standard
weight-only flow (:func:`lia_tpu_torch.ops.quant.quantize_params`) or the
static one (:func:`~lia_tpu_torch.ops.quant.quantize_params_static`)
quantizes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from lia_tpu_torch.config import Activation, ModelConfig, QuantConfig, torch_dtype
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import kv_cache as kvc

DEFAULT_ALPHAS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8)


def _refuse_moe(cfg: ModelConfig, what: str) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            f"{what} taps the dense MLP path; MoE experts use RTN WOQ (quantize_params) for now"
        )


def _device(params) -> torch.device:
    return params["embed_tokens"].device


class Calibration:
    """A batch of calibration prompts on the tree's device: left-padded
    tokens and mask, pad-aware positions, the prefill attention context
    (ALiBi slopes where the model has them), the validity ``[B, S, 1]`` and
    one cache plane that each layer's prefill writes (the reference's
    per-layer cache slice; nothing reads it back)."""

    def __init__(self, cfg: ModelConfig, params, prompts: Sequence[Sequence[int]], pad_id: int):
        from lia_tpu_torch.engine.engine import pack_prompts

        dev = _device(params)
        tokens, mask = pack_prompts(prompts, pad_id)
        self.tokens = torch.from_numpy(tokens).to(dev)
        self.mask = torch.from_numpy(mask).to(dev)
        self.positions = T.prefill_positions(self.mask)
        self.ctx = att.prefill_attn_ctx(self.mask, cfg.sliding_window, T.alibi_slopes(cfg, dev))
        self.valid = self.mask[:, :, None]
        B, S = tokens.shape
        cache = kvc.init_cache(cfg.replace(num_layers=1), B, S, torch_dtype(cfg.dtype), device=dev)
        self.plane = (kvc.index_layer_kv(cache.k, 0), kvc.index_layer_kv(cache.v, 0), cache.length)

    def embed(self, cfg: ModelConfig, params) -> torch.Tensor:
        return T.embed(cfg, params, self.tokens, self.positions)


def tapped_layer(cfg: ModelConfig, lp, x: torch.Tensor, cal: Calibration):
    """One decoder layer over the calibration batch, as the reference's
    observed layer body. Returns (the layer's output, its four linear inputs:
    ln1's output (q/k/v), the attention context (wo), the MLP input (w1/wg)
    and the post-activation intermediate (w2))."""
    residual = x
    a1 = T.norm(cfg, lp["ln1"], x) if cfg.pre_norm else x
    q, k, v = T.qkv_project(cfg, lp, a1, cal.positions)
    kl, vl, start = cal.plane
    attn_out, _, _ = T.attn_core_prefill(cfg, q, k, v, kl, vl, start, cal.ctx)
    B, S = attn_out.shape[:2]
    ao = attn_out.reshape(B, S, -1)
    h = T.linear(ao, lp["attn"]["wo"], lp["attn"].get("bo"))

    def mlp_tapped(a2):
        m = lp["mlp"]
        if cfg.activation == Activation.SILU:
            gate = F.silu(T.linear(a2, m["wg"]).float())
            up = T.linear(a2, m["w1"]).float()
            inter = (gate * up).to(a2.dtype)
        else:
            inter = T.activation_fn(cfg, T.linear(a2, m["w1"], m.get("b1")))
        return T.linear(inter, m["w2"], m.get("b2")), inter

    if cfg.parallel_residual:
        # single-stream families: the MLP reads ln1's output (shared) or ln2(x)
        a2 = a1 if cfg.parallel_shared_norm else T.norm(cfg, lp["ln2"], residual)
        mm, inter = mlp_tapped(a2)
        out = residual + h + mm
    else:
        xx = residual + h
        if not cfg.pre_norm:
            xx = T.norm(cfg, lp["ln1"], xx)
        a2 = T.norm(cfg, lp["ln2"], xx) if cfg.pre_norm else xx
        mm, inter = mlp_tapped(a2)
        out = xx + mm
        if not cfg.pre_norm:
            out = T.norm(cfg, lp["ln2"], out)
    return out, (a1, ao, a2, inter)


@torch.inference_mode()
def collect_act_scales(
    cfg: ModelConfig, params, prompts: Sequence[Sequence[int]], pad_id: int = 1
) -> Dict[str, torch.Tensor]:
    """Per-channel |activation| maxima at every linear's input over the
    prompts' real (non-pad) positions, fp32 on the tree's device: ``qkv``
    [L, H] (ln1's output), ``mlp_in`` [L, H] (the MLP-input norm's output),
    ``wo_in`` [L, N·D] (the attention context), ``w2_in`` [L, F] (the
    post-activation MLP intermediate)."""
    _refuse_moe(cfg, "SmoothQuant calibration")
    cal = Calibration(cfg, params, prompts, pad_id)

    def chan_max(a):
        # pad positions carry arbitrary values: they must not set activation scales
        return torch.where(cal.valid, a.float().abs(), 0.0).amax(dim=(0, 1))

    x = cal.embed(cfg, params)
    taps = []
    for i in range(cfg.num_layers):
        x, acts = tapped_layer(cfg, T.layer_params(params["layers"], i), x, cal)
        taps.append([chan_max(a) for a in acts])
    m1, mo, m2, md = (torch.stack(t) for t in zip(*taps))
    return {"qkv": m1, "mlp_in": m2, "wo_in": mo, "w2_in": md}


@torch.inference_mode()
def autotune_alpha(
    cfg: ModelConfig,
    params,
    prompts: Sequence[Sequence[int]],
    qc: QuantConfig,
    alphas: Sequence[float] = DEFAULT_ALPHAS,
    pad_id: Optional[int] = None,
):
    """Sweep migration alphas and pick the one whose quantized model's
    next-token distributions diverge least from the fp model's: mean KL over
    every real calibration position (``T.score_logprobs``). Returns
    (best alpha, {alpha: KL}); the first of equal minima wins."""
    from lia_tpu_torch.engine.engine import pack_prompts
    from lia_tpu_torch.ops.quant import quantize_params

    pad_id = cfg.pad_token_id if pad_id is None else pad_id
    dev = _device(params)
    tokens, mask = pack_prompts(prompts, pad_id)
    B, S = tokens.shape
    tok = torch.from_numpy(tokens).to(dev)
    msk = torch.from_numpy(mask).to(dev)

    def logprobs(p):
        cache = kvc.init_cache(cfg, B, S, torch_dtype(cfg.dtype), device=dev)
        return T.score_logprobs(cfg, p, tok, msk, cache)

    lp_ref = logprobs(params)
    valid = msk[:, :, None].float()

    def mean_kl(lp_q):
        kl = torch.sum(torch.exp(lp_ref) * (lp_ref - lp_q), dim=-1, keepdim=True)
        return float(torch.sum(kl * valid) / torch.clamp(torch.sum(valid), min=1.0))

    act = collect_act_scales(cfg, params, prompts, pad_id=pad_id)
    report: Dict[float, float] = {}
    best_alpha, best = None, float("inf")
    for a in alphas:
        qp = quantize_params(cfg, apply_smoothquant(cfg, params, act, alpha=float(a)), qc)
        kl = mean_kl(logprobs(qp))
        del qp
        report[float(a)] = kl
        if kl < best:
            best, best_alpha = kl, float(a)
    return best_alpha, report


def smoothquant_quantize(
    cfg: ModelConfig,
    params,
    prompts: Sequence[Sequence[int]],
    qc: QuantConfig,
    alpha: float | str = "auto",
    pad_id: Optional[int] = None,
    alphas: Optional[Sequence[float]] = None,
):
    """Calibrate → (autotune) → fold → quantize. ``alpha="auto"`` runs
    :func:`autotune_alpha` over ``alphas`` (or its default sweep); a float is
    used as it is. Returns (the quantized tree, the alpha used)."""
    from lia_tpu_torch.ops.quant import quantize_params

    if alpha == "auto":
        kw = {} if alphas is None else {"alphas": tuple(alphas)}
        alpha, _ = autotune_alpha(cfg, params, prompts, qc, pad_id=pad_id, **kw)
    act = collect_act_scales(cfg, params, prompts, pad_id=pad_id or cfg.pad_token_id)
    folded = apply_smoothquant(cfg, params, act, alpha=float(alpha))
    return quantize_params(cfg, folded, qc), float(alpha)


def static_int8_quantize(
    cfg: ModelConfig,
    params,
    prompts: Sequence[Sequence[int]],
    alpha: float | str | None = 0.5,
    pad_id: Optional[int] = None,
):
    """The static-INT8 (W8A8) flow: [SmoothQuant fold →] calibrate →
    quantize every decoder linear to int8 × int8 with a static per-tensor
    activation scale (:func:`lia_tpu_torch.ops.quant.quantize_params_static`).
    ``alpha=None`` skips the fold; ``"auto"`` autotunes it on the int8
    weight-only proxy. Returns (the quantized tree, the alpha used or None)."""
    from lia_tpu_torch.ops.quant import quantize_params_static

    pad = cfg.pad_token_id if pad_id is None else pad_id
    if alpha is not None:
        if alpha == "auto":
            alpha, _ = autotune_alpha(cfg, params, prompts, QuantConfig(weight_dtype="int8", group_size=-1),
                                      pad_id=pad)
        act = collect_act_scales(cfg, params, prompts, pad_id=pad)
        params = apply_smoothquant(cfg, params, act, alpha=float(alpha))
    # calibrate again on the folded model: these maxima set the static scales
    act = collect_act_scales(cfg, params, prompts, pad_id=pad)
    return quantize_params_static(cfg, params, act), (float(alpha) if alpha is not None else None)


@torch.inference_mode()
def apply_smoothquant(cfg: ModelConfig, params, act_scales: Dict[str, torch.Tensor], alpha: float = 0.5):
    """Fold migration scales into the (ln1 → wq/wk/wv) and (ln2 → w1/wg)
    pairs, on the tree's device, a layer at a time: each norm's scale and
    bias divided by ``s`` per channel, each consuming weight's input rows
    multiplied by it (fp32, rounded once to the weight's type). ``s`` is
    clipped to [0.1, 10]. A shared norm (GPT-J, Falcon) folds once for q/k/v
    and the MLP together. Post-norm models feed residuals directly and come
    back unchanged."""
    if not cfg.pre_norm:
        return params
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {g: dict(v) for g, v in params["layers"].items()}

    def group_of(wk):
        return layers["attn"] if wk in ("wq", "wk", "wv") else layers["mlp"]

    mlp_in_keys = tuple(k for k in ("w1", "wg") if k in layers["mlp"])
    if cfg.parallel_shared_norm:
        folds = (("ln1", ("wq", "wk", "wv") + mlp_in_keys, act_scales["qkv"]),)
    else:
        folds = (("ln1", ("wq", "wk", "wv"), act_scales["qkv"]), ("ln2", mlp_in_keys, act_scales["mlp_in"]))
    for ln_key, w_keys, amax in folds:
        src = [group_of(k)[k] for k in w_keys]
        dst = [torch.empty_like(w) for w in src]
        ln = dict(layers[ln_key])
        flds = [f for f in ("scale", "bias") if f in ln]
        new_ln = {f: torch.empty_like(ln[f]) for f in flds}
        amax = torch.as_tensor(amax, dtype=torch.float32, device=src[0].device)
        for i in range(src[0].shape[0]):
            ws = [w[i].float() for w in src]
            wmax = torch.stack([w.abs().amax(dim=1) for w in ws]).amax(dim=0)  # [H]
            a = torch.clamp(amax[i], min=1e-5)
            wm = torch.clamp(wmax, min=1e-5)
            s = torch.clamp(a**alpha / wm ** (1 - alpha), 0.1, 10.0)
            for f in flds:
                new_ln[f][i] = (ln[f][i].float() / s).to(ln[f].dtype)
            for w, d in zip(ws, dst):
                d[i] = (w * s[:, None]).to(d.dtype)
        layers[ln_key] = {**ln, **new_ln}
        for k, d in zip(w_keys, dst):
            group_of(k)[k] = d
    out["layers"] = layers
    return out
