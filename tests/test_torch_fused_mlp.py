"""The fused-MLP route (lia_tpu_torch.ops.cuda_mlp, B14) against the JAX
package on the CPU.

- fused_mlp_plain against lia_tpu's Pallas fused_mlp in interpret mode, on the
  same seeded numpy inputs: every activation, both norms, with and without
  biases; fp32 within 2e-5 (tests/test_pallas_mlp.py's tolerance), bf16
  within 2e-2 (the two round at the same six places; the sums run in another
  order, which moves an output of O(1) by up to one bf16 step, 2^-7 near 1);
- the route's rules against lia_tpu's _fused_mlp_viable, one case each;
- model level, with the gate on in both packages (lia_tpu's Pallas forced in
  interpret mode, as tests/test_w4a8_kernel.py does): opt-tiny (relu),
  llama-tiny (SwiGLU, RMSNorm) and gptbigcode-tiny (gelu_new), widened to
  H 128, F 512, give lia_tpu's fp32 tokens through generate (stepwise and
  fused), grouped beam search and the batcher's ragged step, and the same
  tokens with the gate off; the route is taken (a spy counts its calls).
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models import transformer as JT
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import dispatch as jdispatch
from lia_tpu.ops.pallas_mlp import fused_mlp as j_fused_mlp
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import cuda_mlp
from lia_tpu_torch.ops import dispatch
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.ops.quant import quantize_weight
from lia_tpu_torch.utils.checkpoint import params_from_jax

H, FF = 128, 512
ACTS = ["relu", "gelu", "gelu_new", "silu"]


def _inputs(act, rms, bias, rows=5, seed=0):
    rng = np.random.default_rng(seed + 10 * ACTS.index(act) + 2 * rms + bias)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=f(rows, H), ln_scale=1.0 + f(H, sc=0.1), ln_bias=f(H, sc=0.1) if bias else None,
                w1=f(H, FF, sc=0.1), b1=f(FF, sc=0.1) if bias else None, wg=f(H, FF, sc=0.1) if act == "silu" else None,
                w2=f(FF, H, sc=0.05), b2=f(H, sc=0.1) if bias else None)


def _run_both(inp, act, rms, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ja = {k: None if v is None else jnp.asarray(v, jdt) for k, v in inp.items()}
    ref = j_fused_mlp(ja["x"], ja["ln_scale"], ja["ln_bias"], ja["w1"], ja["b1"], ja["wg"], ja["w2"], ja["b2"],
                      activation=act, rms=rms, eps=1e-5, block_f=FF // 2, interpret=True)
    ta = {k: None if v is None else torch.from_numpy(v).to(dtype) for k, v in inp.items()}
    out = cuda_mlp.fused_mlp(ta["x"], ta["ln_scale"], ta["ln_bias"], ta["w1"], ta["b1"], ta["wg"], ta["w2"], ta["b2"],
                             activation=act, rms=rms, eps=1e-5)
    assert out.dtype == dtype and out.shape == inp["x"].shape
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_fused_mlp_plain_matches_pallas_fp32(act, rms, bias):
    out, ref = _run_both(_inputs(act, rms, bias), act, rms, torch.float32)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("act", ACTS)
def test_fused_mlp_plain_matches_pallas_bf16(act):
    rms = act == "silu"
    out, ref = _run_both(_inputs(act, rms, not rms, rows=16), act, rms, torch.bfloat16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)


def test_fused_mlp_wrapper_checks_its_arguments():
    inp = {k: None if v is None else torch.from_numpy(v) for k, v in _inputs("relu", False, True).items()}
    with pytest.raises(ValueError, match="activation"):
        cuda_mlp.fused_mlp(*inp.values(), activation="swish")
    with pytest.raises(ValueError, match="wg"):
        cuda_mlp.fused_mlp(*inp.values(), activation="silu")


# ---------------------------------------------------------------------------
# the route's rules
# ---------------------------------------------------------------------------


@pytest.fixture
def gates(monkeypatch):
    """The fused-MLP gate on in both packages (lia_tpu: Pallas forced in
    interpret mode, no TP flag left over from another test)."""
    for name, v in (("_FORCE", True), ("_INTERPRET", True), ("_FUSED_MLP", True), ("_TP_ACTIVE", False)):
        monkeypatch.setattr(jdispatch, name, v)
    monkeypatch.setattr(dispatch, "_FUSED_MLP", True)


def _wide(get, name, **kw):
    return get(name).replace(**{"dtype": "float32", "hidden_size": H, "ffn_size": FF, "head_dim": H // 4, **kw})


VIABILITY = {  # case: (config, rows, tree edit, viable)
    "decode-rows": ("opt-tiny", 16, None, True),
    "rows-257": ("opt-tiny", 257, None, False),
    "F-not-512": ("opt-tiny-F384", 4, None, False),
    "fused-wg1": ("llama-tiny", 4, "fuse", False),
    "quantized-w1": ("opt-tiny", 4, "quant", False),
    "post-norm": ("opt-350m", 4, None, False),
}


@pytest.mark.parametrize("case", list(VIABILITY))
def test_fused_mlp_viability_matches_lia_tpu(gates, monkeypatch, case):
    """Each rule decides as lia_tpu's does; the port takes the route exactly
    when it is viable (post-norm never reaches the check)."""
    name, rows, edit, viable = VIABILITY[case]
    kw = {"ffn_size": 384} if name.endswith("F384") else {}
    if name == "opt-350m":
        kw = dict(num_heads=4, num_kv_heads=4, word_embed_proj_dim=H, vocab_size=503)
    base = name.replace("-F384", "")
    jcfg, tcfg = _wide(j_get_config, base, **kw), _wide(get_config, base, **kw)
    jcfg, tcfg = jcfg.replace(num_layers=1), tcfg.replace(num_layers=1)
    jp = j_init(jcfg, seed=1, scale=0.05)
    tp = params_from_jax(jp)
    if edit == "fuse":
        tp = fuse_projections(tcfg, tp)
    if edit == "quant":
        tp["layers"]["mlp"]["w1"] = quantize_weight(tp["layers"]["mlp"]["w1"], QuantConfig(weight_dtype="int8"))
    lp = T.layer_params(tp["layers"], 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, rows, H)).astype(np.float32))
    if tcfg.pre_norm:
        assert T._fused_mlp_viable(tcfg, lp, x) == viable
        if edit is None:
            jlp = {g: {k: jnp.asarray(v)[0] for k, v in grp.items()} for g, grp in jp["layers"].items()}
            assert JT._fused_mlp_viable(jcfg, jlp, jnp.asarray(x.numpy())) == viable
    calls = []
    real = cuda_mlp.fused_mlp
    monkeypatch.setattr(cuda_mlp, "fused_mlp", lambda *a, **k: calls.append(1) or real(*a, **k))
    y = T.attn_post_mlp(tcfg, lp, x, torch.zeros(1, rows, tcfg.num_heads, tcfg.head_dim))
    assert len(calls) == int(viable) and y.shape == x.shape


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 23, 41, 7], [100, 7, 3], list(range(30, 45))]
NEW = 8
MODELS = ["opt-tiny", "llama-tiny", "gptbigcode-tiny"]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name in MODELS:
        jcfg = _wide(j_get_config, name)
        jp = j_init(jcfg, seed=31, scale=0.15)
        out[name] = (jcfg, jp, _wide(get_config, name), params_from_jax(jp))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_model_tokens_match_lia_tpu_with_the_gate_on(trees, gates, monkeypatch, name):
    jcfg, jp, tcfg, tp = trees[name]
    calls = []
    real = cuda_mlp.fused_mlp
    monkeypatch.setattr(cuda_mlp, "fused_mlp", lambda *a, **k: calls.append(1) or real(*a, **k))
    jrt, trt = JRuntime(fuse_projections=False), RuntimeConfig(fuse_projections=False)
    jeng, teng = JEngine(jcfg, jp, jrt), InferenceEngine(tcfg, tp, trt, device="cpu")
    jgen, tgen = JGen(max_new_tokens=NEW), GenerationConfig(max_new_tokens=NEW)
    out = {"step": teng.generate(PROMPTS, tgen).sequences, "fused": teng.generate(PROMPTS, tgen, fused=True).sequences}
    assert len(calls) == 2 * tcfg.num_layers * NEW  # prefill + NEW - 1 steps, twice
    np.testing.assert_array_equal(out["step"], jeng.generate(PROMPTS, jgen).sequences)
    np.testing.assert_array_equal(out["fused"], jeng.generate(PROMPTS, jgen, fused=True).sequences)
    beam = dict(max_new_tokens=NEW, num_beams=3)
    out["beam"] = teng.generate_beam(PROMPTS, GenerationConfig(**beam)).sequences
    np.testing.assert_array_equal(out["beam"], jeng.generate_beam(PROMPTS, JGen(**beam), grouped=True).sequences)
    served = []
    for b in (JBatcher(jcfg, jp, gen=jgen, max_batch=2, max_len=64, runtime=jrt),
              ContinuousBatcher(tcfg, tp, gen=tgen, max_batch=2, max_len=64, runtime=trt, device="cpu")):
        ids = [b.submit(p) for p in PROMPTS]
        by_id = {r.req_id: [int(t) for t in r.output] for r in b.run()}
        served.append([by_id[i] for i in ids])
    assert served[1] == served[0]
    # the same tokens with the gate off
    monkeypatch.setattr(dispatch, "_FUSED_MLP", False)
    n = len(calls)
    teng = InferenceEngine(tcfg, tp, trt, device="cpu")
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen).sequences, out["step"])
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen, fused=True).sequences, out["fused"])
    np.testing.assert_array_equal(teng.generate_beam(PROMPTS, GenerationConfig(**beam)).sequences, out["beam"])
    assert len(calls) == n
