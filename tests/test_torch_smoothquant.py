"""The port's SmoothQuant and static-INT8 (W8A8) flows against the JAX
package on the CPU, in fp32, on the same numpy trees (opt-tiny, llama-tiny
and gptj-tiny, whose one norm feeds q/k/v and the MLP: the joint fold), with
three ln1 channels scaled by 30 for activation outliers.

Tolerances: the four taps' activation maxima within 1e-5 of the largest
(XLA and torch round fp32 sums differently, ~3e-7 measured); the folded
trees, given the same maxima, within 1e-6 (the power ``a**alpha`` may
round one ulp apart); the static-INT8 records' codes equal, their weight
scales within 1e-6 (the folded weights' ulps) and their activation scales
within 1e-5, and the fp32 tokens equal
(W8A8's int8 products are exact in both packages). The alpha autotune must
pick lia_tpu's alpha with KLs within 1e-4. Both packages must then take the
same weight-only matmul: the reference's Pallas kernel (forced, in
interpret mode) and the port's kernel both sum x times the codes in fp32,
where the reference's fallback would round the weight to bf16. So the
autotune runs at widths and a format that kernel tiles (H 256, F 512,
opt-tiny's layout; int4 in groups of 16), with the head unquantized. Its
KLs there are ~1e-2 and agree to ~1e-5. Per-channel int8 is not used: its
KLs (~1e-4) are near the fp32 noise of the two forwards (logprobs ~5e-6
apart on equal trees), which alone moves them ~7e-4 apart.
The port's quantizers, on a tensor or a numpy array, are bit-equal to
lia_tpu's numpy quantizers.
"""

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import dispatch as jdispatch
from lia_tpu.ops import quant as jq
from lia_tpu.ops import smoothquant as jsq
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import quant as tq
from lia_tpu_torch.ops import smoothquant as sq
from lia_tpu_torch.utils.checkpoint import params_from_jax

MODELS = ["opt-tiny", "llama-tiny", "gptj-tiny"]
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 4, 90], [100, 200, 300, 17]]
NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the many small CPU ops here run faster without a
    pool contending with XLA's threads in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.default_rng(0)
    return [list(rng.integers(10, 400, size=n)) for n in (24, 17, 9)]


def _trees(name, scale=0.05, **widths):
    kw = dict(dtype="float32", **widths)
    jcfg, cfg = j_get_config(name).replace(**kw), get_config(name).replace(**kw)
    jp = j_init(jcfg, seed=31, scale=scale)
    for ch in (3, 17, 40):  # activation outliers
        jp["layers"]["ln1"]["scale"][:, ch] *= 30.0
    return jcfg, cfg, jp, params_from_jax(jp)


_MODELS = {}


def _model(name):
    """Both packages' trees of ``name`` and lia_tpu's activation maxima, made
    once a module."""
    if name not in _MODELS:
        jcfg, cfg, jp, tp = _trees(name)
        _MODELS[name] = dict(name=name, jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, prompts=_prompts(),
                             jact=jsq.collect_act_scales(jcfg, jp, _prompts()))
    return _MODELS[name]


def _static(name):
    """lia_tpu's static-INT8 flow over ``name``'s tree, its alpha and its fp32
    greedy tokens, made once a module."""
    m = _model(name)
    if "jstatic" not in m:
        jq_, alpha = jsq.static_int8_quantize(m["jcfg"], m["jp"], m["prompts"])
        tokens = np.asarray(JEngine(m["jcfg"], jq_).generate(PROMPTS, JGen(max_new_tokens=NEW)).sequences)
        m["jstatic"] = jq_, alpha, tokens
    return m["jstatic"]


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    return _model(request.param)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_folding_is_exact_at_fp(model):
    cfg, tp = model["cfg"], model["tp"]
    gen = GenerationConfig(max_new_tokens=NEW)
    base = InferenceEngine(cfg, tp, device="cpu").generate(PROMPTS, gen).sequences
    folded = sq.apply_smoothquant(cfg, tp, sq.collect_act_scales(cfg, tp, model["prompts"]), alpha=0.5)
    np.testing.assert_array_equal(InferenceEngine(cfg, folded, device="cpu").generate(PROMPTS, gen).sequences, base)


def test_act_scales_equal_lia_tpu(model):
    cfg, jact = model["cfg"], model["jact"]
    act = sq.collect_act_scales(cfg, model["tp"], model["prompts"])
    widths = {"qkv": cfg.hidden_size, "mlp_in": cfg.hidden_size, "wo_in": cfg.num_heads * cfg.head_dim,
              "w2_in": cfg.ffn_size}
    assert set(act) == set(jact)
    for tap, t in act.items():
        assert t.dtype == torch.float32 and tuple(t.shape) == (cfg.num_layers, widths[tap]), tap
        assert _rel(t.numpy(), jact[tap]) < 1e-5, tap


def test_apply_smoothquant_equals_lia_tpu(model):
    """The same maxima on both sides; the shared-norm family folds once."""
    jact = model["jact"]
    ref = dict(_leaves(jsq.apply_smoothquant(model["jcfg"], model["jp"], jact, alpha=0.6)["layers"]))
    got = dict(_leaves(sq.apply_smoothquant(model["cfg"], model["tp"], {k: torch.tensor(v) for k, v in jact.items()},
                                            alpha=0.6)["layers"]))
    assert set(got) == set(ref)
    changed = [k for k in got if not np.array_equal(np.asarray(ref[k]), np.asarray(model["jp"]["layers"][k.split(".")[0]][k.split(".")[1]]))]
    assert any(k.startswith("ln1.") for k in changed)
    assert any(k.startswith("ln2.") for k in changed) == (model["name"] != "gptj-tiny")
    for k in got:
        assert _rel(got[k].numpy(), ref[k]) < 1e-6, k


def test_post_norm_tree_comes_back_unchanged(model):
    cfg = model["cfg"].replace(pre_norm=False)
    act = {k: torch.tensor(v) for k, v in model["jact"].items()}
    assert sq.apply_smoothquant(cfg, model["tp"], act) is model["tp"]


def test_autotune_alpha_picks_lia_tpu_alpha(monkeypatch):
    for attr, v in (("_FORCE", True), ("_INTERPRET", True), ("_TP_ACTIVE", False)):
        monkeypatch.setattr(jdispatch, attr, v)
    jcfg, cfg, jp, tp = _trees("opt-tiny", hidden_size=256, ffn_size=512, num_heads=4, head_dim=64, num_kv_heads=4)
    prompts = _prompts()
    kw = dict(weight_dtype="int4", group_size=16, quant_lm_head=False)
    jbest, jrep = jsq.autotune_alpha(jcfg, jp, prompts, JQuant(**kw))
    best, rep = sq.autotune_alpha(cfg, tp, prompts, QuantConfig(**kw))
    assert best == jbest and list(rep) == list(jrep) == list(sq.DEFAULT_ALPHAS)
    for a in rep:
        assert abs(rep[a] - jrep[a]) <= 1e-4 * jrep[a], (a, rep[a], jrep[a])


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny"])
def test_static_int8_equals_lia_tpu(name):
    """OPT's and the SiLU MLP's taps (gptj-tiny's shared fold is held above)."""
    model = _model(name)
    cfg = model["cfg"]
    jq, jalpha, ref = _static(name)
    tq_, alpha = sq.static_int8_quantize(cfg, model["tp"], model["prompts"])
    assert alpha == jalpha == 0.5
    n = 0
    for grp, ws in jq["layers"].items():
        for k, rec in ws.items():
            got = tq_["layers"][grp][k]
            if not hasattr(rec, "fmt"):
                assert not tq.is_quantized(got), (grp, k)
                continue
            n += 1
            assert got.fmt == rec.fmt == "static_int8", (grp, k)
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(rec.q), err_msg=f"{grp}.{k}")
            assert _rel(got.s.numpy(), rec.s) < 1e-6, (grp, k)
            assert got.z.shape == (cfg.num_layers,) and _rel(got.z.numpy(), rec.z) < 1e-5, (grp, k)
    assert n == (7 if cfg.activation.value == "silu" else 6)
    out = InferenceEngine(cfg, tq_, device="cpu").generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences
    np.testing.assert_array_equal(out, ref)


def test_static_int8_tiered_tokens_equal_lia_tpu():
    """A static-INT8 tree under the tiered scheduler (hbm 50, half the layers
    streamed) gives lia_tpu's resident tokens."""
    m = _model("opt-tiny")
    cfg = m["cfg"]
    _, _, ref = _static("opt-tiny")
    tq_, _ = sq.static_int8_quantize(cfg, m["tp"], m["prompts"])
    engine = InferenceEngine(cfg, tq_, RuntimeConfig(hbm_percentage=50), device="cpu")
    assert engine.scheduler is not None and engine.scheduler.wm.n_resident == 1
    np.testing.assert_array_equal(engine.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences, ref)


def test_moe_refuses():
    cfg = get_config("mixtral-8x7b").replace(num_layers=1)
    with pytest.raises(NotImplementedError, match="MoE"):
        sq.collect_act_scales(cfg, {}, [[1, 2, 3]])


@pytest.mark.parametrize("wd,group", [("int8", -1), ("int8", 16), ("int4", -1), ("int4", 16), ("nf4", 32)])
def test_device_path_quantizers_are_bit_equal_to_numpy(wd, group):
    """The port quantizes a tensor on its device (here the CPU), and a numpy
    array as a CPU tensor, with lia_tpu's numpy arithmetic: the same codes
    and scales, bit for bit; bf16 inputs too."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 64, 48)) * 0.05).astype(np.float32)
    w[1, 5, 7] = 0.0
    w[2] *= 20.0  # a wider layer
    wb = torch.from_numpy(w).bfloat16()
    for src, inputs in ((w, (w, torch.from_numpy(w))), (wb.float().numpy(), (wb.float().numpy(), wb))):
        ref = jq.quantize_weight(src, JQuant(weight_dtype=wd, group_size=group))
        for x in inputs:
            got = tq.quantize_weight(x, QuantConfig(weight_dtype=wd, group_size=group))
            assert got.fmt == ref.fmt and got.q.device.type == "cpu"
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
            np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))
    amax = np.abs(rng.standard_normal(3)).astype(np.float32) * 4
    ref = jq.quantize_weight_static(w, amax)
    for x, a in ((w, amax), (torch.from_numpy(w), torch.from_numpy(amax))):
        got = tq.quantize_weight_static(x, a)
        for f in ("q", "s", "z"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
