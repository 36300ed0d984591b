"""Fit the cost model's H100 defaults (``lia_tpu_torch/runtime/cost_model.py``).

    python tools/fit_cost_model.py --measure   # on the card: the inputs below
    python tools/fit_cost_model.py             # anywhere: the fit and its table

``--measure`` prints, on one NVIDIA GPU: the weight-read rate of bf16 matmuls
at the b16 decode step's 16 rows over OPT-6.7B's projections (CUDA events over
100 calls), and the CUDA kernels one fused decode step launches per layer and
outside the layers (profiler counts of ``generate(fused=True)`` at 2 and 4
layers of OPT-6.7B's width, 1 and 5 new tokens).

Without ``--measure`` it fits the fields the anchors decide, from MEASURED
(the ``--measure`` numbers) and ANCHORS (the resident decode steps of
``PERF.md`` §5, b16 over a 272-token context): ``hbm_bw`` is the measured
weight-read rate; ``ops_per_layer`` and ``ops_per_step`` the measured kernel
counts; ``op_overhead_s`` the per-launch cost that fits the two OPT bf16
anchors (least squares on log ratios); each format's derate the one that fits
its anchors. It prints the fitted values and each anchor's measured and
predicted step under :class:`SystemProfile`'s defaults, with their ratio.
"""

from __future__ import annotations

import json
import math
import sys

sys.path.insert(0, __file__.rsplit("/tools/", 1)[0])

# The --measure run's numbers (one NVIDIA H100 80GB HBM3 at 700.00 W): bf16
# weight reads at 16 rows, bytes/s; kernels per layer and per step of the
# fused decode loop.
MEASURED = {"weight_read_bytes_per_s": 2727553105619.0703, "kernels_per_layer": 15.0, "kernels_per_step": 33.25}

# (model, QuantConfig fields, measured decode tok/s at b16): PERF.md §5's
# resident cells (chip_smoke.py on one NVIDIA H100 80GB HBM3 at 700.00 W)
ANCHORS = [
    ("opt-6.7b", {}, 1509.0),
    ("opt-6.7b", {"kv_cache_dtype": "int8"}, 1252.0),
    ("opt-6.7b", {"weight_dtype": "int8", "act_quant": "dynamic", "kv_cache_dtype": "int8"}, 506.0),
    ("opt-6.7b", {"weight_dtype": "int4", "group_size": 128, "act_quant": "dynamic", "kv_cache_dtype": "int8"}, 575.0),
    ("opt-6.7b", {"weight_dtype": "int8"}, 859.0),
    ("opt-6.7b", {"weight_dtype": "int4", "group_size": 128}, 856.0),
    ("opt-6.7b", {"weight_dtype": "nf4", "group_size": 128}, 914.0),
    ("llama-3-8b", {}, 752.0),
]
BATCH, CTX = 16, 272


def measure() -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    rates = {}
    for name, (K, N) in {"wqkv": (4096, 12288), "fc1": (4096, 16384), "fc2": (16384, 4096)}.items():
        w = torch.randn(K, N, dtype=torch.bfloat16, device="cuda")
        x = torch.randn(BATCH, K, dtype=torch.bfloat16, device="cuda")
        for _ in range(10):
            x @ w
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(100):
            x @ w
        b.record()
        b.synchronize()
        rates[name] = K * N * 2 * 100 / (a.elapsed_time(b) / 1e3)
    counts = {}
    prompts = np.random.default_rng(0).integers(2, 50000, (BATCH, 256)).tolist()
    for L in (2, 4):
        cfg = get_config("opt-6.7b").replace(num_layers=L)
        eng = InferenceEngine(cfg, device_dummy_params(cfg, seed=0))
        for new in (1, 5):
            gen = GenerationConfig(max_new_tokens=new)
            eng.generate(prompts, gen, fused=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eng.generate(prompts, gen, fused=True)
                torch.cuda.synchronize()
            counts[(L, new)] = sum(e.count for e in prof.key_averages()
                                   if e.device_type == torch.autograd.DeviceType.CUDA)
        del eng
    step = {L: (counts[(L, 5)] - counts[(L, 1)]) / 4 for L in (2, 4)}
    per_layer = (step[4] - step[2]) / 2
    return {"weight_read_bytes_per_s": sum(rates.values()) / len(rates), "weight_read_by_shape": rates,
            "kernels_per_layer": per_layer, "kernels_per_step": step[2] - 2 * per_layer,
            "kernel_counts": {f"L{L} new{n}": c for (L, n), c in counts.items()}}


def predict(profile, name: str, q: dict) -> float:
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.runtime.cost_model import CostModel

    return CostModel(get_config(name), profile, QuantConfig(**q)).predict_decode_step(BATCH, CTX)


def fit() -> dict:
    """The fitted fields, each by a one-dimensional least-squares fit of log
    ratios (golden-section search) over the anchors it decides."""
    from dataclasses import replace

    from lia_tpu_torch.runtime.cost_model import SystemProfile

    base = replace(SystemProfile(), hbm_bw=MEASURED["weight_read_bytes_per_s"],
                   ops_per_layer=MEASURED["kernels_per_layer"], ops_per_step=MEASURED["kernels_per_step"])

    def search(loss, lo, hi):
        g = (math.sqrt(5) - 1) / 2
        a, b = math.log(lo), math.log(hi)
        for _ in range(100):
            c, d = b - g * (b - a), a + g * (b - a)
            if loss(math.exp(c)) < loss(math.exp(d)):
                b = d
            else:
                a = c
        return math.exp((a + b) / 2)

    def sq(profile, anchors):
        return sum(math.log(16 / tok_s / predict(profile, n, q)) ** 2 for n, q, tok_s in anchors)

    bf16 = [a for a in ANCHORS if a[0] == "opt-6.7b" and "weight_dtype" not in a[1]]
    base = replace(base, op_overhead_s=search(lambda v: sq(replace(base, op_overhead_s=v), bf16), 1e-7, 1e-3))
    for field, pick in (("dyn_bw_derate", lambda q: q.get("act_quant") == "dynamic"),
                        ("woq_bw_derate", lambda q: q.get("weight_dtype") == "int8" and "act_quant" not in q),
                        ("woq_int4_bw_derate", lambda q: q.get("weight_dtype") == "int4" and "act_quant" not in q)):
        sub = [a for a in ANCHORS if pick(a[1])]
        base = replace(base, **{field: search(lambda v: sq(replace(base, **{field: v}), sub), 1e-3, 2.0)})
    keys = ("hbm_bw", "op_overhead_s", "ops_per_layer", "ops_per_step", "dyn_bw_derate", "woq_bw_derate",
            "woq_int4_bw_derate")
    return {k: getattr(base, k) for k in keys}


def table() -> None:
    """Each anchor under SystemProfile()'s defaults."""
    from lia_tpu_torch.runtime.cost_model import SystemProfile

    for name, q, tok_s in ANCHORS:
        meas = 16 / tok_s
        pred = predict(SystemProfile(), name, q)
        print(json.dumps({"anchor": name, "quant": q, "measured_ms": meas * 1e3, "predicted_ms": pred * 1e3,
                          "ratio": meas / pred}))


if __name__ == "__main__":
    if "--measure" in sys.argv:
        print(json.dumps({"measure": measure()}))
    else:
        print(json.dumps({"fit": fit()}))
        table()
