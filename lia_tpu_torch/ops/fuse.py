"""Projection fusion: concat q/k/v (and SwiGLU gate/up) weights
(port of ``lia_tpu/ops/fuse.py``).

One ``[H, qd+2*kd]`` matmul replaces three launches per layer. Per decoder layer:

- ``attn.wq/wk/wv [+ bq/bk/bv]``  →  ``attn.wqkv [+ bqkv]``  (concat on N)
- ``mlp.wg/w1``                   →  ``mlp.wg1``             (SwiGLU gate|up)

Quantized weights fuse too: groups run along K, so an N-axis concat of codes,
scales and zero-points is exact. ``static_int8`` keeps one activation scale
in ``z``; q/k/v read the same input, so their calibrated scales must agree,
and a group whose scales (or formats) differ stays unfused.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from lia_tpu_torch.config import Activation, ModelConfig
from lia_tpu_torch.ops.quant import QuantizedWeight, is_quantized


def _cat_weights(ws: List[Any]) -> Optional[Any]:
    """N-axis concat of raw or quantized weights; None when they cannot fuse."""
    if not any(is_quantized(w) for w in ws):
        return torch.cat(ws, dim=-1)
    if not all(is_quantized(w) for w in ws):
        return None  # mixed raw/quantized projections
    fmt = ws[0].fmt
    if any(w.fmt != fmt or w.s.shape[-2] != ws[0].s.shape[-2] for w in ws):
        return None  # mixed formats or group counts
    z = None
    if fmt.startswith("woq_int4z"):
        z = torch.cat([w.z for w in ws], dim=-1)
    elif fmt == "static_int8":
        z = ws[0].z
        if not all(torch.allclose(z.float(), w.z.float(), rtol=1e-6) for w in ws[1:]):
            return None  # calibrated activation scales disagree
    return QuantizedWeight(
        torch.cat([w.q for w in ws], dim=-1), torch.cat([w.s for w in ws], dim=-1), fmt, z
    )


def _cat_biases(a: Dict[str, Any], keys: List[str], widths: List[int]):
    """Concat biases; synthesize zeros for absent ones when any is present."""
    present = [a[k] for k in keys if k in a]
    if not present:
        return None
    ref = present[0]
    parts = [
        a[k] if k in a else ref.new_zeros((*ref.shape[:-1], n))
        for k, n in zip(keys, widths)
    ]
    return torch.cat(parts, dim=-1)


def fuse_projections(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Return a shallow-copied params tree with per-layer projections fused.

    Leaves the input tree untouched (the concatenations are new tensors)."""
    if "layers" not in params:
        return params
    layers = dict(params["layers"])
    qd = cfg.num_heads * cfg.head_dim
    kd = cfg.num_kv_heads * cfg.head_dim
    a = dict(layers["attn"])
    wqkv = _cat_weights([a["wq"], a["wk"], a["wv"]]) if all(k in a for k in ("wq", "wk", "wv")) else None
    if wqkv is not None:
        bqkv = _cat_biases(a, ["bq", "bk", "bv"], [qd, kd, kd])
        for k in ("wq", "wk", "wv", "bq", "bk", "bv"):
            a.pop(k, None)
        a["wqkv"] = wqkv
        if bqkv is not None:
            a["bqkv"] = bqkv
        layers["attn"] = a
    m = dict(layers["mlp"])
    # MoE experts are not routed through linear() — leave unfused
    if cfg.num_experts == 0 and cfg.activation == Activation.SILU and "wg" in m and "w1" in m:
        wg1 = _cat_weights([m["wg"], m["w1"]])
        if wg1 is not None:
            del m["wg"], m["w1"]
            m["wg1"] = wg1
            layers["mlp"] = m
    out = dict(params)
    out["layers"] = layers
    return out
