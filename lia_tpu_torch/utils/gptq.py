"""GPTQ checkpoint ingestion (port of ``lia_tpu/utils/gptq.py``, OPT only).

AutoGPTQ stores each linear as

  qweight: int32 [K/8, N]   (eight 4-bit codes per int32, packed along K)
  qzeros:  int32 [K/g, N/8] (eight 4-bit zero-points per int32, packed along N,
                             stored as zero - 1)
  scales:  f16/f32 [K/g, N]
  g_idx:   int32 [K]        (optional K → group map, act-order)

A checkpoint without act-order (trivial ``g_idx``) is ingested losslessly as
the asymmetric ``woq_int4z`` record (raw codes, scales and zero-points, codes
repacked in the global half-split), which runs the ``woq4z_matmul`` kernel;
:func:`lia_tpu_torch.ops.quant.retag_dynamic_act` turns it into
``woq_int4z_dyn`` for the W4A8 kernel. Act-order checkpoints are dequantized
and re-quantized to symmetric int4; ``keep_fp=True`` ingests at full precision.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lia_tpu_torch.config import ModelConfig, QuantConfig
from lia_tpu_torch.ops.quant import QuantizedWeight, quantize_weight
from lia_tpu_torch.utils.checkpoint import params_from_hf_state_dict


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _nibbles(qweight, qzeros):
    """(codes uint32 [K, N] in [0, 15], zero-points [K/g, N] with the +1)."""
    qweight, qzeros = _np(qweight), _np(qzeros)
    per = 8
    K, N = qweight.shape[0] * per, qweight.shape[1]
    shifts = (np.arange(per, dtype=np.uint32) * 4)[None, :, None]
    codes = ((qweight.astype(np.uint32)[:, None, :] >> shifts) & 0xF).reshape(K, N)
    z = ((qzeros.astype(np.uint32)[:, :, None] >> shifts.transpose(0, 2, 1)) & 0xF)
    return codes, z.reshape(qzeros.shape[0], N) + 1  # AutoGPTQ's zero - 1 convention


def unpack_gptq(qweight, qzeros, scales, g_idx: Optional[np.ndarray] = None, bits: int = 4) -> np.ndarray:
    """Dequantize one AutoGPTQ-format weight to fp32 [K, N]."""
    if bits != 4:
        raise ValueError("only 4-bit GPTQ is supported")
    w, z = _nibbles(qweight, qzeros)
    scales = _np(scales).astype(np.float32)
    K = w.shape[0]
    grp = np.asarray(_np(g_idx), np.int64) if g_idx is not None else np.arange(K) // (K // scales.shape[0])
    return (w.astype(np.float32) - z[grp].astype(np.float32)) * scales[grp]


def unpack_gptq_codes(qweight, qzeros, scales, bits: int = 4):
    """Unpack without dequantizing: (codes [K, N] uint8 in [0, 15], scales
    [K/g, N] f32, zero-points [K/g, N] f32 including the +1)."""
    if bits != 4:
        raise ValueError("only 4-bit GPTQ is supported")
    codes, z = _nibbles(qweight, qzeros)
    return codes.astype(np.uint8), _np(scales).astype(np.float32), z.astype(np.float32)


def _pack_half_split(codes: np.ndarray) -> np.ndarray:
    """[..., K, N] uint8 nibble codes → [..., K/2, N] global half-split bytes."""
    K = codes.shape[-2]
    return (codes[..., : K // 2, :] & 0xF) | (codes[..., K // 2 :, :] << 4)


def params_from_gptq_state_dict(
    cfg: ModelConfig, sd: Dict[str, np.ndarray], group_size: int = 128, keep_fp: bool = False
):
    """Map an AutoGPTQ OPT state dict into the stacked tree.

    Linears arrive as (qweight, qzeros, scales[, g_idx]) keyed like
    ``model.decoder.layers.N.self_attn.q_proj.qweight``; embeddings, norms and
    biases go through :func:`params_from_hf_state_dict`. GPTQ's [K, N]
    orientation already matches ``x @ w``. A projection whose every layer has a
    trivial ``g_idx`` and whole groups per packed half becomes one stacked
    ``woq_int4z`` record; any other is re-quantized to symmetric int4 in groups
    of ``group_size``."""
    if cfg.family != "opt":
        raise NotImplementedError(f"{cfg.family}: only OPT GPTQ checkpoints are ported")
    fp_sd = dict(sd)
    native: Dict[str, tuple] = {}
    for p in sorted({k[: -len(".qweight")] for k in sd if k.endswith(".qweight")}):
        g_idx = sd.get(p + ".g_idx")
        K = sd[p + ".qweight"].shape[0] * 8
        g = K // sd[p + ".scales"].shape[0]
        trivial = g_idx is None or np.array_equal(_np(g_idx), np.arange(K) // g)
        if trivial and not keep_fp and (g == K or (K // 2) % g == 0):
            codes, s, z = unpack_gptq_codes(sd[p + ".qweight"], sd[p + ".qzeros"], sd[p + ".scales"])
            native[p] = (_pack_half_split(codes), s, z)
        w = unpack_gptq(sd[p + ".qweight"], sd[p + ".qzeros"], sd[p + ".scales"], g_idx)
        fp_sd[p + ".weight"] = w.T  # the HF mapper takes [out, in]
        for suffix in (".qweight", ".qzeros", ".scales", ".g_idx"):
            fp_sd.pop(p + suffix, None)
    params = params_from_hf_state_dict(cfg, fp_sd)
    if keep_fp:
        return params

    names = {("attn", "wq"): "self_attn.q_proj", ("attn", "wk"): "self_attn.k_proj",
             ("attn", "wv"): "self_attn.v_proj", ("attn", "wo"): "self_attn.out_proj",
             ("mlp", "w1"): "fc1", ("mlp", "w2"): "fc2"}
    qc = QuantConfig(weight_dtype="int4", group_size=group_size)
    layers = params["layers"]
    for (grp, wname), hf_name in names.items():
        prefixes = [f"model.decoder.layers.{i}.{hf_name}" for i in range(cfg.num_layers)]
        if all(px in native for px in prefixes):
            q, s, z = (torch.from_numpy(np.stack([native[px][j] for px in prefixes])) for j in range(3))
            layers[grp][wname] = QuantizedWeight(q, s, "woq_int4z", z)
        else:  # act-order or partial coverage: lossy symmetric re-quantization
            layers[grp][wname] = quantize_weight(layers[grp][wname], qc)
    return params
