"""The stacked-weight W4A8 route (lia_tpu_torch.ops.quant.QuantizedWeightRef
and cuda_matmul.w4a8_matmul_stacked, B13) against the JAX package on the CPU.

- w4a8_matmul_stacked_plain against lia_tpu's Pallas w4a8_matmul_stacked in
  interpret mode at every layer index, with and without zero-points, at the
  shapes of tests/test_w4a8_kernel.py (exact int32 group sums on both sides);
- stackable_ref's rules against lia_tpu's, one record each;
- quantized_matmul over a reference: the stacked kernel where it takes the
  shape, the layer's views where it does not, equal results either way;
- decode_layers_scan's hidden states with the gate on against lia_tpu's with
  its gate on (opt-125m at 2 layers, tests/test_w4a8_kernel.py's case), and
  bit-equal to the port's with the gate off;
- fp32 tokens with the gate on equal lia_tpu's (its gate on too) through fused
  generate, the batcher's decode_step_ragged and the tiered scheduler's
  resident decode, and equal the port's with the gate off.

lia_tpu's gate needs its Pallas dispatch forced on in interpret mode
(dispatch._FORCE, _INTERPRET, _STACKED_W4A8; _TP_ACTIVE cleared), as
tests/test_w4a8_kernel.py:230-237 does.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu import config as jconfig
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models import transformer as JT
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import attention as jatt
from lia_tpu.ops import dispatch as jdispatch
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops import quant as jq
from lia_tpu.ops.pallas_matmul import w4a8_matmul_stacked as j_stacked
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import cuda_matmul as cm
from lia_tpu_torch.ops import dispatch
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import quant
from lia_tpu_torch.utils.checkpoint import params_from_jax


@pytest.fixture
def gates(monkeypatch):
    for name, v in (("_FORCE", True), ("_INTERPRET", True), ("_STACKED_W4A8", True), ("_TP_ACTIVE", False)):
        monkeypatch.setattr(jdispatch, name, v)
    monkeypatch.setattr(dispatch, "_STACKED_W4A8", True)


@pytest.fixture
def spy(monkeypatch):
    """Calls of the stacked wrapper, counted (the wrapper itself counts only
    kernel launches, none on the CPU)."""
    calls = []
    real = cm.w4a8_matmul_stacked
    monkeypatch.setattr(cm, "w4a8_matmul_stacked", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _quant_act(x):
    s = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8).astype(np.float32)
    return np.round(x / s).astype(np.int8), s


@pytest.mark.parametrize("L,M,K,N,ng,zp", [(3, 16, 256, 128, 8, False), (2, 8, 256, 128, 4, True)])
def test_stacked_plain_matches_lia_tpu_at_every_layer(rng, L, M, K, N, ng, zp):
    xq, sx = _quant_act(rng.standard_normal((M, K)).astype(np.float32))
    codes = rng.integers(0, 16, size=(L, K, N)).astype(np.uint8)
    q = (codes[:, : K // 2] & 0xF) | (codes[:, K // 2:] << 4)
    s = rng.uniform(0.01, 0.1, size=(L, ng, N)).astype(np.float32)
    z = rng.uniform(4.0, 12.0, size=(L, ng, N)).astype(np.float32) if zp else None
    t = torch.from_numpy
    layers = torch.arange(L, dtype=torch.int32)
    for li in range(L):
        ref = j_stacked(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(q), jnp.asarray(s),
                        None if z is None else jnp.asarray(z), jnp.int32(li), group_size=K // ng, block_m=8,
                        block_n=64, block_k=128, interpret=True)
        for layer in (li, layers[li]):  # an int, or the 0-d tensor the decode loop hands over
            out = cm.w4a8_matmul_stacked(t(xq), t(sx), t(q), t(s), None if z is None else t(z), layer)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        per_layer = cm.w4a8_matmul(t(xq), t(sx), t(q[li]), t(s[li]), None if z is None else t(z[li]))
        np.testing.assert_array_equal(out.numpy(), per_layer.numpy())


def _record(rng, fmt, L=2, K=128, N=128, ng=2):
    q = rng.integers(0, 256, size=(L, K // 2, N) if L else (K // 2, N)).astype(np.uint8)
    s = rng.uniform(0.01, 0.1, size=(L, ng, N) if L else (ng, N)).astype(np.float32)
    z = rng.uniform(4.0, 12.0, size=s.shape).astype(np.float32) if fmt.startswith("woq_int4z") else None
    return q, s, z


STACKABLE = {  # case: (format, stacked, gate on, stackable)
    "int4-dyn": ("woq_int4_dyn", True, True, True),
    "int4z-dyn": ("woq_int4z_dyn", True, True, True),
    "gate-off": ("woq_int4_dyn", True, False, False),
    "weight-only-int4": ("woq_int4", True, True, False),
    "int8-dyn": ("woq_int8_dyn", True, True, False),
    "one-layer": ("woq_int4_dyn", False, True, False),
}


@pytest.mark.parametrize("case", list(STACKABLE))
def test_stackable_ref_rules_match_lia_tpu(rng, monkeypatch, case):
    fmt, stacked, gate, expect = STACKABLE[case]
    for name, v in (("_FORCE", True), ("_STACKED_W4A8", gate), ("_TP_ACTIVE", False)):
        monkeypatch.setattr(jdispatch, name, v)
    monkeypatch.setattr(dispatch, "_STACKED_W4A8", gate)
    q, s, z = _record(rng, fmt, L=2 if stacked else 0)
    if fmt == "woq_int8_dyn":
        q = q.view(np.int8)
    jrec = jq.QuantizedWeight(jnp.asarray(q), jnp.asarray(s), fmt, None if z is None else jnp.asarray(z))
    trec = quant.QuantizedWeight(torch.from_numpy(q), torch.from_numpy(s), fmt,
                                 None if z is None else torch.from_numpy(z))
    assert jq.stackable_ref(jrec) == expect
    # the port's gate is the decode loop's (it passes a stack index only with
    # the gate on); stackable_ref holds the record's rules
    assert (dispatch.stacked_w4a8_enabled() and quant.stackable_ref(trec)) == expect
    assert quant.stackable_ref(trec) == (case == "gate-off" or expect)


def test_quantized_matmul_over_a_ref(rng, gates, spy):
    """The stacked kernel's plain version where it takes the shape (K/2 a
    multiple of 16), the layer's views where it does not (K = 48); a ref's
    result equals the per-layer record's either way, and lia_tpu's where the
    kernel runs (a shape no kernel of the port takes is dequantized to bf16,
    the port's documented last branch, where lia_tpu keeps int8 activations)."""
    for K, ng, taken in ((128, 2, True), (48, 1, False)):
        q, s, _ = _record(rng, "woq_int4_dyn", L=3, K=K, ng=ng)
        rec = quant.QuantizedWeight(torch.from_numpy(q), torch.from_numpy(s), "woq_int4_dyn")
        x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32))
        layers = torch.arange(3, dtype=torch.int32)
        for li in range(3):
            n = len(spy)
            ref = quant.stacked_ref(rec, li, layers)
            assert quant.is_quantized(ref)
            y = quant.quantized_matmul(x, ref)
            assert len(spy) == n + taken
            np.testing.assert_array_equal(y.numpy(), quant.quantized_matmul(x, ref.sliced()).numpy())
            if not taken:
                continue
            jref = jq.QuantizedWeightRef(jnp.asarray(q), jnp.asarray(s), "woq_int4_dyn", None, jnp.int32(li))
            np.testing.assert_allclose(y.numpy(), np.asarray(jq.quantized_matmul(jnp.asarray(x.numpy()), jref)),
                                       rtol=2e-5, atol=2e-5)
    with pytest.raises(IndexError):
        quant.stacked_ref(rec, 3, layers)


def test_decode_layers_scan_matches_lia_tpu(rng, gates, spy, monkeypatch):
    """tests/test_w4a8_kernel.py:193's case: opt-125m at 2 layers, int4 g128
    with int8 activations, one decode step's hidden states with the gate on."""
    jcfg = j_get_config("opt-125m").replace(num_layers=2)
    qc = jconfig.QuantConfig(weight_dtype="int4", group_size=128, act_quant="dynamic")
    jp = jax.tree.map(jnp.asarray, j_init(jcfg, quant=qc))
    tp = params_from_jax(jp)
    tcfg = get_config("opt-125m").replace(num_layers=2)
    B, S_max, n_past = 2, 64, 5
    x = rng.standard_normal((B, 1, jcfg.hidden_size)).astype(np.float32)
    slot = np.arange(S_max)[None, :].repeat(B, 0) < n_past
    jc = jkvc.init_cache(jcfg, B, S_max, jnp.float32)
    jctx = jatt.DecodeAttn(slot_mask=jnp.asarray(slot), length=jnp.asarray(n_past, jnp.int32),
                           mask=jatt.decode_mask(jnp.asarray(slot), jnp.asarray(n_past, jnp.int32)))
    jh, _, _ = JT.decode_layers_scan(jcfg, jp["layers"], jnp.asarray(x), jc.k, jc.v, jnp.asarray(n_past, jnp.int32),
                                     jctx, jnp.full((B, 1), n_past, jnp.int32), 2)
    tc = kvc.init_cache(tcfg, B, S_max, torch.float32)
    tctx = att.decode_attn_ctx(torch.from_numpy(slot), torch.tensor(n_past, dtype=torch.int32))

    def run():
        h, _, _ = T.decode_layers_scan(tcfg, tp["layers"], torch.from_numpy(x), tc.k, tc.v,
                                       torch.tensor(n_past, dtype=torch.int32), tctx,
                                       torch.full((B, 1), n_past, dtype=torch.int32), 2)
        return h.numpy()

    on = run()
    assert len(spy) == 2 * 6  # q, k, v, o, fc1, fc2 per layer
    np.testing.assert_allclose(on, np.asarray(jh), rtol=2e-4, atol=2e-4)
    monkeypatch.setattr(dispatch, "_STACKED_W4A8", False)
    np.testing.assert_array_equal(run(), on)
    assert len(spy) == 12


PROMPTS = [[5, 9, 23, 41, 7], [100, 7, 3], list(range(30, 45))]
NEW = 8


@pytest.fixture(scope="module")
def w4a8_model():
    """opt-tiny widened to H 256, F 1024 (the reference's W4A8 kernel tiles),
    int4 g64 weights with int8 activations, fp32 elsewhere."""
    kw = dict(dtype="float32", hidden_size=256, ffn_size=1024, head_dim=64)
    jcfg = j_get_config("opt-tiny").replace(**kw)
    jp = j_init(jcfg, seed=41, scale=0.1)
    jt = jq.quantize_params(jcfg, jp, jconfig.QuantConfig(weight_dtype="int4", group_size=64, act_quant="dynamic"))
    return jcfg, jt, get_config("opt-tiny").replace(**kw), params_from_jax(jt)


def test_tokens_match_lia_tpu_with_the_gate_on(w4a8_model, gates, spy, monkeypatch):
    jcfg, jt, tcfg, tp = w4a8_model
    jgen, tgen = jconfig.GenerationConfig(max_new_tokens=NEW), GenerationConfig(max_new_tokens=NEW)
    out = {}
    teng = InferenceEngine(tcfg, tp, device="cpu")
    out["fused"] = teng.generate(PROMPTS, tgen, fused=True).sequences
    assert len(spy) == 4 * tcfg.num_layers * (NEW - 1)  # wqkv, wo, fc1, fc2 per layer per decode step
    np.testing.assert_array_equal(out["fused"], JEngine(jcfg, jt).generate(PROMPTS, jgen, fused=True).sequences)
    served = []
    for b in (JBatcher(jcfg, jt, gen=jgen, max_batch=2, max_len=64),
              ContinuousBatcher(tcfg, tp, gen=tgen, max_batch=2, max_len=64, device="cpu")):
        ids = [b.submit(p) for p in PROMPTS]
        by_id = {r.req_id: [int(t) for t in r.output] for r in b.run()}
        served.append([by_id[i] for i in ids])
    assert served[1] == served[0]
    out["served"] = served[1]
    n = len(spy)
    tiered = dict(hbm_percentage=50, stream_weights=True)
    sch = InferenceEngine(tcfg, tp, RuntimeConfig(**tiered), device="cpu")
    out["tiered"] = sch.generate(PROMPTS, tgen).sequences
    assert len(spy) == n + 4 * (NEW - 1)  # the one resident layer's decode
    jsch = JEngine(jcfg, jt, jconfig.RuntimeConfig(**tiered))
    np.testing.assert_array_equal(out["tiered"], jsch.generate(PROMPTS, jgen).sequences)
    # the same tokens with the gate off
    monkeypatch.setattr(dispatch, "_STACKED_W4A8", False)
    n = len(spy)
    np.testing.assert_array_equal(InferenceEngine(tcfg, tp, device="cpu").generate(PROMPTS, tgen, fused=True).sequences,
                                  out["fused"])
    cb = ContinuousBatcher(tcfg, tp, gen=tgen, max_batch=2, max_len=64, device="cpu")
    ids = [cb.submit(p) for p in PROMPTS]
    by_id = {r.req_id: [int(t) for t in r.output] for r in cb.run()}
    assert [by_id[i] for i in ids] == out["served"]
    np.testing.assert_array_equal(InferenceEngine(tcfg, tp, RuntimeConfig(**tiered), device="cpu")
                                  .generate(PROMPTS, tgen).sequences, out["tiered"])
    assert len(spy) == n
