"""Projection fusion: concat q/k/v (and SwiGLU gate/up) weights
(port of ``lia_tpu/ops/fuse.py`` for unquantized trees).

One ``[H, qd+2*kd]`` matmul replaces three launches per layer. Per decoder layer:

- ``attn.wq/wk/wv [+ bq/bk/bv]``  →  ``attn.wqkv [+ bqkv]``  (concat on N)
- ``mlp.wg/w1``                   →  ``mlp.wg1``             (SwiGLU gate|up)

Quantized weights are not ported yet, so every leaf here is a plain tensor.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from lia_tpu_torch.config import Activation, ModelConfig


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
    if all(k in a for k in ("wq", "wk", "wv")):
        wqkv = torch.cat([a["wq"], a["wk"], a["wv"]], dim=-1)
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
        m["wg1"] = torch.cat([m.pop("wg"), m.pop("w1")], dim=-1)
        layers["mlp"] = m
    out = dict(params)
    out["layers"] = layers
    return out
