"""One-call engine construction (port of ``lia_tpu/api.py``)::

    from lia_tpu_torch.api import load_engine
    engine = load_engine("opt-6.7b", dummy=True, weight_dtype="int8", auto_placement=True, batch=16)
    out = engine.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=32))

What the port lacks raises ``NotImplementedError`` naming its ``ROADMAP.md``
queue A item: the GPTQ algorithm, SmoothQuant and the static-int8
calibration flow (A11), the encoder-decoder and vision families (A12).
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
    refuse_unported(cfg, gptq=gptq, gptq_actorder=gptq_actorder, smoothquant=smoothquant is not None,
                    static_int8=weight_dtype == "static-int8")
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
    return InferenceEngine(cfg, load_params_for(cfg, quant, checkpoint, gptq_checkpoint, dummy, seed, device),
                           runtime, device=device)


def refuse_unported(cfg, tp: int = 1, **asked: bool) -> None:
    """Raise ``NotImplementedError`` naming the ``ROADMAP.md`` item of each
    asked-for option the port lacks: the encoder-decoder and vision families
    (A12), tensor parallelism (A13), the quantization algorithms of ``asked``
    (``gptq``, ``gptq_actorder``, ``smoothquant``, ``static_int8``: A11)."""
    missing = [f"{name} (A11)" for name, on in asked.items() if on]
    if tp > 1:
        missing.append(f"tp={tp} (A13)")
    if cfg.encoder_decoder or cfg.family in ("git", "llava") or cfg.vision_hidden:
        missing.append(f"the {cfg.family} family (A12)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: {', '.join(missing)}; see ROADMAP.md queue A")


def load_params_for(cfg, quant: QuantConfig, checkpoint: Optional[str] = None,
                    gptq_checkpoint: Optional[str] = None, dummy: bool = False, seed: int = 0, device="cuda"):
    """The parameter tree from the first weight source given (see :func:`load_engine`)."""
    import torch

    if checkpoint:
        from lia_tpu_torch.ops.quant import quantize_params
        from lia_tpu_torch.utils.checkpoint import load_hf_checkpoint

        params = load_hf_checkpoint(cfg, checkpoint)
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

        q = quant if quant.enabled else None
        if torch.device(device).type == "cuda":
            return device_dummy_params(cfg, seed=seed, device=device, quant=q)
        return init_dummy_params(cfg, seed=seed, quant=q)
    raise ValueError("provide checkpoint=, gptq_checkpoint=, or dummy=True")
