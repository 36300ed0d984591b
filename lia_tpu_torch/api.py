"""One-call engine construction (port of ``lia_tpu/api.py``)::

    from lia_tpu_torch.api import load_engine
    engine = load_engine("opt-6.7b", dummy=True, weight_dtype="int8", auto_placement=True, batch=16)
    out = engine.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=32))

The quantization algorithms run on the tree's device before the engine is
built: ``gptq=True`` (:mod:`lia_tpu_torch.ops.gptq`), ``smoothquant=alpha``
or ``"auto"`` with a weight-only ``weight_dtype``, and
``weight_dtype="static-int8"`` (W8A8; :mod:`lia_tpu_torch.ops.smoothquant`),
each over :func:`_default_calib`'s prompts. What the port lacks raises
``NotImplementedError`` naming its ``ROADMAP.md`` queue A item: the
encoder-decoder and vision families (A12), tensor parallelism (A13).
"""

from __future__ import annotations

import os
from typing import Optional

from lia_tpu_torch.config import QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config


def load_engine(
    model: str,
    dtype: str = "bfloat16",
    checkpoint: Optional[str] = None,
    gptq_checkpoint: Optional[str] = None,
    dummy: bool = False,
    weight_dtype: str = "none",
    group_size: int = -1,
    kv_cache_dtype: str = "none",
    act_quant: str = "none",
    gptq: bool = False,
    gptq_actorder: bool = False,
    smoothquant: Optional[float | str] = None,
    prefill_policy: int = 3,
    decode_policy: int = 3,
    hbm_percentage: int = 100,
    num_minibatch: int = 1,
    stream_weights: bool = False,
    auto_placement: bool = False,
    batch: int = 1,
    in_len: int = 256,
    out_len: int = 32,
    seed: int = 0,
    device=None,
) -> InferenceEngine:
    """A ready-to-generate engine for a registry model.

    Weight sources (the first given wins): ``checkpoint`` (a directory of Hugging
    Face safetensors shards, quantized as ``weight_dtype`` asks), ``gptq_checkpoint``
    (a directory of AutoGPTQ safetensors shards) or ``dummy=True`` (random weights
    from ``seed``, drawn in quantized form where quantization is asked for; on the
    card drawn there by :func:`~lia_tpu_torch.utils.checkpoint.device_dummy_params`,
    on the CPU by :func:`~lia_tpu_torch.utils.checkpoint.init_dummy_params`, the
    reference's tree). ``auto_placement`` lets the cost model pick both policies
    and ``hbm_percentage`` for ``batch`` prompts of ``in_len`` tokens and
    ``out_len`` new ones. ``device`` defaults to the card (``"cuda"``)."""
    cfg = get_config(model).replace(dtype=dtype)
    refuse_unported(cfg)
    if device is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("load_engine needs a CUDA device (pass device='cpu' to run on the CPU)")
        device = "cuda"
    quant = QuantConfig(weight_dtype=weight_dtype, group_size=group_size, kv_cache_dtype=kv_cache_dtype,
                        act_quant=act_quant)
    runtime = RuntimeConfig(prefill_policy=prefill_policy, decode_policy=decode_policy,
                            hbm_percentage=hbm_percentage, num_minibatch=num_minibatch,
                            stream_weights=stream_weights, quant=quant)
    if auto_placement:
        from lia_tpu_torch.runtime.cost_model import resolve_auto_policies

        runtime = runtime.replace(prefill_policy=-1, decode_policy=-1, hbm_percentage=-1)
        runtime = resolve_auto_policies(cfg, runtime, batch, in_len, out_len)
    if smoothquant is not None and not quant.enabled:
        raise ValueError("smoothquant= migrates outliers BEFORE weight quantization — pass a "
                         "WOQ weight_dtype ('int8'/'int4') alongside it")
    flow = quant_flow(cfg, quant, _default_calib(cfg), gptq=gptq, gptq_actorder=gptq_actorder,
                      smoothquant=smoothquant)
    return InferenceEngine(cfg, load_params_for(cfg, quant, checkpoint, gptq_checkpoint, dummy, seed, device, flow),
                           runtime, device=device)


def quant_flow(cfg, quant: QuantConfig, calib, gptq: bool = False, gptq_actorder: bool = False,
               smoothquant=None, alphas=None, log=None):
    """The quantization algorithm asked for, as a function of the fp tree
    (run on the tree's device), or None for round to nearest (or none):

    - ``weight_dtype="static-int8"`` first: W8A8 after a SmoothQuant fold at
      ``smoothquant`` (an alpha or ``"auto"``; 0.5 if None);
    - then ``gptq``: 8 bits for int8, else 4; group 128 unless
      ``group_size`` is set; with ``act_quant="dynamic"`` 4-bit codes are
      retagged onto the W4A8 kernel;
    - then ``smoothquant`` with ``quant``'s weight-only format: an alpha, or
      ``"auto"`` over ``alphas`` (the default sweep if None).

    ``calib``: the calibration prompts. ``log`` (``print`` in the CLI) is
    given the reference's ``[lia-tpu]`` line once the flow has run."""
    say = log or (lambda line: None)
    if quant.weight_dtype == "static-int8":
        from lia_tpu_torch.ops.smoothquant import static_int8_quantize

        def static8(p):
            p, used = static_int8_quantize(cfg, p, calib, alpha=0.5 if smoothquant is None else smoothquant)
            say(f"[lia-tpu] static-int8 (W8A8) calibrated; smoothquant alpha={used}")
            return p

        return static8
    if gptq:
        from lia_tpu_torch.ops.gptq import gptq_quantize_params
        from lia_tpu_torch.ops.quant import retag_dynamic_act

        bits = 8 if quant.weight_dtype == "int8" else 4
        g = quant.group_size if quant.group_size > 0 else 128

        def solve(p):
            p = gptq_quantize_params(cfg, p, calib, bits=bits, group_size=g, actorder=gptq_actorder)
            if quant.act_quant == "dynamic" and bits == 4:
                p = retag_dynamic_act(p)  # GPTQ's codes on the W4A8 kernel
            say(f"[lia-tpu] gptq quantized (bits={bits}, group={g}, actorder={gptq_actorder}, "
                f"act_quant={quant.act_quant})")
            return p

        return solve
    if smoothquant is not None and quant.enabled:
        from lia_tpu_torch.ops.smoothquant import smoothquant_quantize

        def smooth(p):
            p, used = smoothquant_quantize(cfg, p, calib, quant, alpha=smoothquant, alphas=alphas)
            say(f"[lia-tpu] smoothquant folded with alpha={used}")
            return p

        return smooth
    return None


def refuse_unported(cfg, tp: int = 1) -> None:
    """Raise ``NotImplementedError`` naming the ``ROADMAP.md`` item of what
    the port lacks: the encoder-decoder and vision families (A12), tensor
    parallelism (A13)."""
    missing = []
    if tp > 1:
        missing.append(f"tp={tp} (A13)")
    if cfg.encoder_decoder or cfg.family in ("git", "llava") or cfg.vision_hidden:
        missing.append(f"the {cfg.family} family (A12)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: {', '.join(missing)}; see ROADMAP.md queue A")


def load_params_for(cfg, quant: QuantConfig, checkpoint: Optional[str] = None,
                    gptq_checkpoint: Optional[str] = None, dummy: bool = False, seed: int = 0, device="cuda",
                    flow=None):
    """The parameter tree from the first weight source given (see
    :func:`load_engine`). ``flow`` (:func:`quant_flow`) quantizes the fp
    tree of a checkpoint or of dummy weights on ``device``; without it the
    tree is quantized by round to nearest where ``quant`` asks (dummy trees
    drawn in quantized form)."""
    import torch

    if checkpoint:
        from lia_tpu_torch.ops.quant import quantize_params
        from lia_tpu_torch.utils.checkpoint import load_hf_checkpoint, to_device

        params = load_hf_checkpoint(cfg, checkpoint)
        if flow is not None:
            return flow(to_device(params, device))
        return quantize_params(cfg, params, quant) if quant.enabled else params
    if gptq_checkpoint:
        from lia_tpu_torch.utils import safetensors
        from lia_tpu_torch.utils.gptq import params_from_gptq_state_dict

        sd = {}
        for f in sorted(os.listdir(gptq_checkpoint)):
            if f.endswith(".safetensors"):
                sd.update(safetensors.load_file(os.path.join(gptq_checkpoint, f)))
        return params_from_gptq_state_dict(cfg, sd, group_size=max(quant.group_size, 128))
    if dummy:
        from lia_tpu_torch.utils.checkpoint import device_dummy_params, init_dummy_params

        q = quant if quant.enabled and flow is None else None
        if torch.device(device).type == "cuda":
            params = device_dummy_params(cfg, seed=seed, device=device, quant=q)
        else:
            params = init_dummy_params(cfg, seed=seed, quant=q)
        return params if flow is None else flow(params)
    raise ValueError("provide checkpoint=, gptq_checkpoint=, or dummy=True")


def _default_calib(cfg, n: int = 4):
    """Synthetic calibration prompts for the quantization flows without a
    dataset: ``n`` prompts of 64 tokens from ``default_rng(0)``, as the reference's."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [list(rng.integers(10, min(cfg.vocab_size - 10, 30000), size=64)) for _ in range(n)]
