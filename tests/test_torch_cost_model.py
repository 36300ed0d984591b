"""The port's cost model, calibration and device capabilities against the
JAX package on the CPU.

For the same explicit SystemProfile fields, the port's ``CostModel.report``
and ``choose`` equal lia_tpu's exactly over six models, four weight formats,
both KV types, three (B, in, out) shapes, and a direct-link and a relayed-link
profile; ``resolve_auto_policies`` fills only the fields that ask for auto
(both packages' ``system_profile_defaults`` patched to one profile); the
α/β fit recovers a synthetic link and takes the noise-floor rule as lia_tpu's
does; the H100 defaults predict the card's resident decode anchors
(``PERF.md`` §5) within the band stated below, and the anchors outside it are
named with their ratio.
"""

import dataclasses

import pytest

pytest.importorskip("jax")

from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.runtime import cost_model as jcm

from lia_tpu_torch.config import QuantConfig, RuntimeConfig
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.runtime import cost_model as tcm
from lia_tpu_torch.runtime import policy
from lia_tpu_torch.utils import device_caps

MODELS = ["opt-125m", "opt-6.7b", "opt-30b", "opt-66b", "llama-3-8b", "falcon-7b"]
WEIGHTS = [dict(), dict(weight_dtype="int8", act_quant="dynamic"), dict(weight_dtype="int8"),
           dict(weight_dtype="int4", group_size=128)]
SHAPES = [(1, 128, 32), (16, 256, 32), (64, 1024, 128)]
# every SystemProfile field, explicit: a direct PCIe link (α tens of µs) and a
# relayed one (α of a second's fraction, a GB/s)
DIRECT = dict(tpu_flops=700e12, hbm_bw=2.7e12, hbm_bytes=16e9, h2d_bw=50e9, h2d_latency_s=30e-6, host_flops=400e9,
              host_mem_bw=40e9, op_overhead_s=12e-6, ops_per_layer=15.0, ops_per_step=33.0, dyn_bw_derate=0.5,
              woq_bw_derate=0.6, woq_int4_bw_derate=0.3)
RELAY = {**DIRECT, "h2d_bw": 1e9, "h2d_latency_s": 0.4, "host_flops": 2e12, "host_mem_bw": 200e9}

# The H100 defaults against the card's resident decode steps (b16, 256 + 16
# context; PERF.md §5, NVIDIA H100 80GB HBM3, 700.00 W): measured / predicted
# must lie in BAND, but for the anchors OUTSIDE names with their ratio (held
# to +-0.01, so a change of the defaults shows): the model has one launch cost
# and one bf16 path for every family and format, where the port's Llama-3-8B
# step launches more kernels (RoPE, SwiGLU, a 128K-vocab head), NF4 is read
# as bf16 by the reference's arithmetic, and int8-dynamic and W4A8 share one
# derate though their host launches differ.
BAND = (0.85, 1.15)
ANCHORS = {
    "opt-6.7b bf16": ("opt-6.7b", dict(), 1509.0),
    "opt-6.7b int8 KV": ("opt-6.7b", dict(kv_cache_dtype="int8"), 1252.0),
    "opt-6.7b int8dyn+int8kv": ("opt-6.7b", dict(weight_dtype="int8", act_quant="dynamic", kv_cache_dtype="int8"),
                                506.0),
    "opt-6.7b w4a8+int8kv": ("opt-6.7b", dict(weight_dtype="int4", group_size=128, act_quant="dynamic",
                                               kv_cache_dtype="int8"), 575.0),
    "opt-6.7b woq int8": ("opt-6.7b", dict(weight_dtype="int8"), 859.0),
    "opt-6.7b woq int4": ("opt-6.7b", dict(weight_dtype="int4", group_size=128), 856.0),
    "opt-6.7b woq nf4": ("opt-6.7b", dict(weight_dtype="nf4", group_size=128), 914.0),
    "llama-3-8b bf16": ("llama-3-8b", dict(), 752.0),
}
OUTSIDE = {"opt-6.7b int8dyn+int8kv": 0.830, "opt-6.7b w4a8+int8kv": 1.245, "opt-6.7b woq nf4": 1.475,
           "llama-3-8b bf16": 1.792}


@pytest.mark.parametrize("profile", ["direct", "relay"])
@pytest.mark.parametrize("model", MODELS)
def test_report_and_choose_equal_lia_tpu(model, profile):
    fields = DIRECT if profile == "direct" else RELAY
    jcfg, tcfg = j_get_config(model), get_config(model)
    for w in WEIGHTS:
        for kv in ("none", "int8"):
            j = jcm.CostModel(jcfg, jcm.SystemProfile(**fields), JQuant(kv_cache_dtype=kv, **w))
            t = tcm.CostModel(tcfg, tcm.SystemProfile(**fields), QuantConfig(kv_cache_dtype=kv, **w))
            for B, s_in, s_out in SHAPES:
                assert t.report(B, s_in, s_out) == j.report(B, s_in, s_out), (model, w, kv, B)
                assert t.choose(B, s_in, s_out) == j.choose(B, s_in, s_out)
                assert t.predict_decode_step(B, s_in) == j.predict_decode_step(B, s_in)
                assert t.max_resident_layers(B, s_in + s_out) == j.max_resident_layers(B, s_in + s_out)


def test_profile_fields_match_lia_tpu():
    assert [f.name for f in dataclasses.fields(tcm.SystemProfile)] == \
        [f.name for f in dataclasses.fields(jcm.SystemProfile)]


@pytest.mark.parametrize("ask", [(-1, 2, -1), (-1, -1, -1), (3, -1, 50), (0, 1, -1), (3, 3, 100)])
def test_resolve_auto_fills_only_requested(monkeypatch, ask):
    """Both packages' system_profile_defaults patched to one profile: the port
    resolves the same fields to the same values, leaves the others, and sets
    stream_weights only where it picked a percentage below 100."""
    import lia_tpu.utils.device_caps as jcaps

    monkeypatch.setattr(jcaps, "system_profile_defaults", lambda: jcm.SystemProfile(**RELAY))
    monkeypatch.setattr(device_caps, "system_profile_defaults", lambda: tcm.SystemProfile(**RELAY))
    pf, dec, pct = ask
    for model in ("opt-30b", "opt-1.3b"):
        j = jcm.resolve_auto_policies(j_get_config(model), JRuntime(prefill_policy=pf, decode_policy=dec,
                                                                     hbm_percentage=pct), 64, 256, 32)
        t = tcm.resolve_auto_policies(get_config(model), RuntimeConfig(prefill_policy=pf, decode_policy=dec,
                                                                        hbm_percentage=pct), 64, 256, 32)
        for f in ("prefill_policy", "decode_policy", "hbm_percentage", "stream_weights"):
            assert getattr(t, f) == getattr(j, f), (model, f)
        for name, v in zip(("prefill_policy", "decode_policy", "hbm_percentage"), ask):
            if v != -1:
                assert getattr(t, name) == v
        assert t.stream_weights == (pct == -1 and t.hbm_percentage < 100)
    assert tcm.resolve_auto_policies(get_config("opt-30b"), RuntimeConfig(prefill_policy=-1, decode_policy=-1,
                                                                          hbm_percentage=-1), 64, 256, 32
                                     ).hbm_percentage < 100


def test_unresolved_auto_raises_in_plan_for():
    with pytest.raises(ValueError, match="unknown policy -1"):
        policy.plan_for(-1)


@pytest.mark.parametrize("alpha,beta", [(30e-6, 50e9), (0.4, 1e9), (0.0, 8e9)])
def test_alpha_beta_fit_recovers_a_synthetic_link(alpha, beta):
    link = lambda n: alpha + n / beta
    a, b = tcm.Microbench.h2d_alpha_beta(measure=link)
    assert (a, b) == jcm.Microbench.h2d_alpha_beta(measure=link)
    assert b == pytest.approx(beta, rel=1e-9) and a == pytest.approx(alpha, abs=1e-12)


def test_alpha_beta_noise_floor():
    """A large copy timed no slower than a small one: bandwidth only, α 0."""
    flat = lambda n: 0.01
    assert tcm.Microbench.h2d_alpha_beta(measure=flat) == jcm.Microbench.h2d_alpha_beta(measure=flat)
    assert tcm.Microbench.h2d_alpha_beta(measure=flat) == (0.0, (256 << 20) / 0.01)


def test_calibrate_raises_without_a_card_and_measures_with_a_link():
    """The port's calibrate raises where a measurement fails (the reference
    keeps its defaults); with an injected link it measures α, β and the
    host's rate and keeps the card's."""
    with pytest.raises(RuntimeError, match="CUDA device or a measure"):
        tcm.Microbench.calibrate()
    base = tcm.SystemProfile()
    p = tcm.Microbench.calibrate(measure=lambda n: 20e-6 + n / 25e9)
    assert p.h2d_bw == pytest.approx(25e9) and p.h2d_latency_s == pytest.approx(20e-6)
    assert p.host_flops > 0 and p.host_flops != base.host_flops and p.tpu_flops == base.tpu_flops


@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_h100_defaults_predict_the_card_anchors(anchor):
    model, q, tok_s = ANCHORS[anchor]
    pred = tcm.CostModel(get_config(model), tcm.SystemProfile(), QuantConfig(**q)).predict_decode_step(16, 272)
    ratio = 16 / tok_s / pred
    if anchor in OUTSIDE:
        assert not BAND[0] <= ratio <= BAND[1] and ratio == pytest.approx(OUTSIDE[anchor], abs=0.01), ratio
    else:
        assert BAND[0] <= ratio <= BAND[1], f"{anchor}: measured / predicted {ratio:.3f}"


def test_device_caps_without_a_card():
    assert device_caps.detect() is None
    assert device_caps.system_profile_defaults() == tcm.SystemProfile()
    h100 = device_caps.REGISTRY["h100-sxm"]
    assert (h100.bf16_flops, h100.int8_ops, h100.hbm_bw, h100.link_bw) == (989e12, 1979e12, 3.35e12, 450e9)
    assert tcm.SystemProfile().hbm_bw == pytest.approx(3.35e12 * tcm.H100_FIT["hbm_bw"])
