"""The port's placement policies (lia_tpu_torch.runtime.policy and the
scheduler's plans) against the JAX package on the CPU, in fp32.

Mirrors tests/test_policies.py: every policy, mixed prefill/decode policies,
residency and minibatch prefill give exactly lia_tpu's tokens under the same
RuntimeConfig, and the prompt and first decode step's logits agree within
1e-4. On the CPU "host" and "card" are one device, so these check the control
flow, the cache split and the host tier's golden compute; the card runs the
same paths in chip_smoke.py.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.runtime import policy as jpol
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine, pack_prompts
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.runtime import policy as pol
from lia_tpu_torch.utils.checkpoint import params_from_jax

PROMPTS = [[5, 9, 23, 41], [100, 7, 3], [8, 8, 8, 8, 8], [50, 60]]
NEW = 6


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("opt-tiny").replace(num_layers=4, dtype="float32")
    jp = j_init(jcfg, seed=13, scale=0.05)
    return jcfg, jp, get_config("opt-tiny").replace(num_layers=4, dtype="float32"), params_from_jax(jp)


def _engines(model, kv="none", **kw):
    jcfg, jp, tcfg, tp = model
    jeng = JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv), **kw))
    teng = InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **kw), device="cpu")
    return jeng, teng


def _check(model, kv="none", **kw):
    """Tokens equal lia_tpu's, and the prompt's and the first decode step's
    logits agree within 1e-4."""
    jeng, teng = _engines(model, kv, **kw)
    ref = jeng.generate(PROMPTS, JGen(max_new_tokens=NEW)).sequences
    out = teng.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences
    np.testing.assert_array_equal(out, ref)
    tokens, mask = pack_prompts(PROMPTS, 1)
    max_len = 128
    jl, js = jeng.scheduler.prefill_pass(tokens, mask, max_len)
    tl, ts = teng.scheduler.prefill_pass(tokens, mask, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    tok, pos = np.array(jnp.argmax(jl, -1), np.int32), mask.sum(1).astype(np.int32)
    jl2, _ = jeng.scheduler.decode_pass(jnp.asarray(tok), jnp.asarray(pos), js)
    tl2, ts2 = teng.scheduler.decode_pass(torch.from_numpy(tok), torch.from_numpy(pos), ts)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4, atol=1e-4)
    return teng, ts2


@pytest.mark.parametrize("policy", [0, 1, 2, 3, 4])
def test_plan_table_matches_lia_tpu(policy):
    assert pol.plan_for(policy).__dict__ == jpol.plan_for(policy).__dict__
    for name in ("all_host", "hybrid"):
        assert getattr(pol.plan_for(policy), name) == getattr(jpol.plan_for(policy), name)
    with pytest.raises(ValueError):
        pol.plan_for(7)


@pytest.mark.parametrize("prefill,decode", [(0, 0), (1, 1), (2, 2), (4, 4), (0, 2), (3, 2)])
def test_phase_plans_and_host_kv_match_lia_tpu(prefill, decode):
    jrt, trt = JRuntime(prefill_policy=prefill, decode_policy=decode), RuntimeConfig(prefill_policy=prefill,
                                                                                     decode_policy=decode)
    assert [p.__dict__ for p in pol.phase_plans(trt)] == [p.__dict__ for p in jpol.phase_plans(jrt)]
    assert pol.uses_host_kv(trt) == jpol.uses_host_kv(jrt)


@pytest.mark.parametrize("policy", [0, 1, 2, 4])
def test_policy_matches_lia_tpu(model, policy):
    teng, state = _check(model, prefill_policy=policy, decode_policy=policy, hbm_percentage=0, stream_weights=True)
    assert teng.scheduler.kv_host and state["str"].k.device.type == "cpu"


def test_mixed_policies_with_residency(model):
    """LIA's headline shape: prefill 0 (card compute, host KV), decode 2 (card
    linears, host attention), half the layers resident."""
    teng, state = _check(model, prefill_policy=0, decode_policy=2, hbm_percentage=50, stream_weights=True)
    assert state["res"].k.shape[0] == 2 and state["str"].k.shape[0] == 2


def test_policy0_prefill_policy1_decode(model):
    _check(model, prefill_policy=0, decode_policy=1, hbm_percentage=25, stream_weights=True)


def test_policy3_prefill_over_host_kv(model):
    """Prefill 3 with decode 2: the decode plan puts the cache on the host, so
    the streamed prefill attends on the card and stores K/V there."""
    _check(model, prefill_policy=3, decode_policy=2, hbm_percentage=50, stream_weights=True, num_minibatch=2)


@pytest.mark.parametrize("policy", [0, 2])
def test_minibatched_prefill_matches_lia_tpu(model, policy):
    _check(model, prefill_policy=policy, decode_policy=policy, hbm_percentage=0, stream_weights=True,
           num_minibatch=2)


def test_minibatched_policy0_with_residency(model):
    _check(model, prefill_policy=0, decode_policy=1, hbm_percentage=50, stream_weights=True, num_minibatch=2)


@pytest.mark.parametrize("policy", [0, 2])
def test_policy_with_int8_kv(model, policy):
    _check(model, kv="int8", prefill_policy=policy, decode_policy=policy, hbm_percentage=50, stream_weights=True)


def test_policy_no_overlap(model):
    _check(model, prefill_policy=0, decode_policy=0, hbm_percentage=25, stream_weights=True, overlap=False)


@pytest.mark.parametrize("policy", [1, 2, 4])
def test_host_tier_reaches_no_kernel_wrapper(model, monkeypatch, policy):
    """Policies 1, 2 and 4 attend on the host through the golden attention:
    the attention kernels' wrappers (which would take their plain versions on
    the CPU) are never called for the streamed layers."""
    jcfg, jp, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, RuntimeConfig(prefill_policy=policy, decode_policy=policy, hbm_percentage=0,
                                                  stream_weights=True), device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the host tier")

    for name in ("flash_attention_prefill", "decode_attention", "decode_attention_fresh"):
        monkeypatch.setattr(ca, name, refuse)
    res = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=3))
    assert res.sequences.shape == (len(PROMPTS), 3)


def test_unported_passes_raise(model):
    """Beam search, scoring, ragged and paged serving, the verify pass and
    meshes under the scheduler raise, naming what they wait for."""
    _, _, tcfg, tp = model
    rt = RuntimeConfig(hbm_percentage=50, stream_weights=True)
    eng = InferenceEngine(tcfg, tp, rt, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.generate(PROMPTS, GenerationConfig(max_new_tokens=3, num_beams=2))
    with pytest.raises(ValueError):
        eng.generate(PROMPTS, GenerationConfig(max_new_tokens=3), on_token=print)
    sched = eng.scheduler
    for name in ("init_serving_state", "insert_slot_state", "decode_pass_ragged", "decode_pass_paged",
                 "reorder_state", "beam_state_from_prefill", "decode_pass_beam", "reorder_state_beam",
                 "ragged_state", "verify_pass", "accept_state", "score_logprobs"):
        with pytest.raises(NotImplementedError, match="waits for"):
            getattr(sched, name)(None)
    with pytest.raises(NotImplementedError):
        InferenceEngine(tcfg, tp, rt.replace(mesh_shape=(1, 2)), device="cpu")
    from lia_tpu_torch.runtime.scheduler import StreamingScheduler

    with pytest.raises(NotImplementedError):
        StreamingScheduler(tcfg, rt, tp, "cpu", mesh=object())
