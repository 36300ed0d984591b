"""The port's continuous batching over the tiered scheduler
(lia_tpu_torch.engine.serving with a tiering RuntimeConfig) against
lia_tpu.engine.serving over its scheduler, on the CPU, in fp32.

As tests/test_torch_serving.py: lia_tpu's dummy opt-tiny tree at scale 0.12,
carried across with params_from_jax, the same requests through both batchers;
every request's tokens and the decode step and dispatch counters must be
equal. Slab serving under each (prefill, decode) policy pair, paged serving
over one pool for every layer, and speculative serving through the tiered
verify pass; then the combinations both packages refuse.
"""

import pytest

pytest.importorskip("jax")

import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.utils.checkpoint import params_from_jax

PROMPTS = [[5, 9, 23, 41], [100, 7, 3], [8, 8, 8, 8, 8, 12, 13], [50, 60]]
SPEC_PROMPTS = [[5, 9, 23, 41, 5, 9, 23, 41, 5, 9], [100, 7, 3], [8, 8, 8, 8, 8, 12, 13],
                [50, 60, 7, 9, 11, 50, 60, 7, 9]]
COUNTERS = ("decode_steps", "decode_dispatches", "prefix_hits", "prefix_tokens_reused")


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=21, scale=0.12)
    return jcfg, jp, get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp)


def runtimes(hbm, policies=(3, 3), kv="none", nm=1, **_):
    """The same tiering configuration for lia_tpu and for the port."""
    kw = dict(hbm_percentage=hbm, stream_weights=True, prefill_policy=policies[0], decode_policy=policies[1],
              num_minibatch=nm)
    return JRuntime(quant=JQuant(kv_cache_dtype=kv), **kw), RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **kw)


def serve(model, prompts, runtime, new_tokens=5, draft=False, **kw):
    """The same requests through lia_tpu's batcher and the port's over their
    schedulers; returns (lia_tpu outputs, port outputs, lia_tpu stats, port
    stats, port batcher), outputs in submission order."""
    jcfg, jp, tcfg, tp = model
    jrt, trt = runtime
    out = []
    for batcher in (
        JBatcher(jcfg, jp, gen=JGen(max_new_tokens=new_tokens), runtime=jrt,
                 draft=(jcfg, jp) if draft else None, **kw),
        ContinuousBatcher(tcfg, tp, gen=GenerationConfig(max_new_tokens=new_tokens), runtime=trt,
                          draft=(tcfg, tp) if draft else None, device="cpu", **kw),
    ):
        ids = [batcher.submit(p) for p in prompts]
        by_id = {r.req_id: r.output for r in batcher.run()}
        out.append(([by_id[i] for i in ids], batcher.stats(), batcher))
    (jo, js, _), (to, ts, tb) = out
    return jo, to, js, ts, tb


def assert_same(jo, to, js, ts):
    for i, (a, b) in enumerate(zip(jo, to)):
        assert b == [int(x) for x in a], f"request {i}"
    for k in COUNTERS:
        assert ts.get(k) == js.get(k), k


SLAB = {
    "h50-p3": dict(hbm=50, fused_steps=3),  # one step a dispatch over the scheduler
    "h0-p3": dict(hbm=0),
    "h50-p3-int8kv": dict(hbm=50, kv="int8"),
    "h50-p0": dict(hbm=50, policies=(0, 0)),
    "h50-p0-p2-mb2": dict(hbm=50, policies=(0, 2), nm=2),
    "h0-p1": dict(hbm=0, policies=(1, 1)),
}


@pytest.mark.parametrize("name", list(SLAB))
def test_slab_serving_over_scheduler_matches_lia_tpu(model, name):
    """Ragged serving over the {resident, streamed} cache pair under each
    placement: the resident prefix over its device cache, the streamed layers
    on the card (policy 3), with host KV streamed in (0), with host attention
    at decode (2), or whole on the host (1); the same tokens and counters."""
    jo, to, js, ts, tb = serve(model, PROMPTS, runtimes(**SLAB[name]), max_batch=2, max_len=128,
                               fused_steps=SLAB[name].get("fused_steps", 1))
    assert_same(jo, to, js, ts)
    assert ts["decode_dispatches"] == ts["decode_steps"]
    assert tb.sched is not None and tb.sched.kv_host == (SLAB[name].get("policies", (3, 3)) != (3, 3))
    assert not tb.active.any() and not tb.queue


@pytest.mark.parametrize("hbm", [50, 0])
def test_paged_serving_over_scheduler_matches_lia_tpu(model, hbm):
    """One pool for every layer, resident and streamed; prefix caching off
    under the scheduler, the pool clean at the end."""
    jo, to, js, ts, tb = serve(model, PROMPTS, runtimes(hbm), max_batch=2, max_len=128, paged=True,
                               block_size=8)
    assert_same(jo, to, js, ts)
    assert not tb.prefix_cache and ts["prefix_hits"] == 0
    assert not tb.active.any() and not tb.queue
    assert (tb.page_rc == 0).all() and len(tb.free_blocks) + len(tb.cached_pages) == tb.num_blocks - 1


@pytest.mark.parametrize("draft", [False, True], ids=["lookup", "draft"])
def test_speculative_serving_over_scheduler_matches_lia_tpu(model, draft):
    """Prompt lookup (k = 4) and a self-draft (k = 3), greedy, through the
    tiered verify pass: the same tokens and verify steps, fewer steps than
    tokens."""
    jo, to, js, ts, _ = serve(model, SPEC_PROMPTS, runtimes(50), new_tokens=8, draft=draft, max_batch=2,
                              max_len=128, speculate_k=3 if draft else 4)
    assert_same(jo, to, js, ts)
    assert ts["decode_steps"] < ts["total_tokens"]


def test_sampled_speculative_serving_over_scheduler_at_top_k_1(model):
    """Sampled acceptance through the tiered verify (prompt lookup and a
    self-draft): at top_k 1 the warp is a point mass, so the tokens are the
    greedy ones (lia_tpu draws from other random numbers)."""
    _, _, tcfg, tp = model
    outs = []
    for draft, gen_kw in ((False, {}), (False, dict(do_sample=True, temperature=0.7, top_k=1)),
                          (True, dict(do_sample=True, temperature=0.7, top_k=1))):
        cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=128, gen=GenerationConfig(max_new_tokens=8, **gen_kw),
                               runtime=runtimes(50)[1], speculate_k=3, draft=(tcfg, tp) if draft else None,
                               device="cpu")
        ids = [cb.submit(p) for p in SPEC_PROMPTS]
        by_id = {r.req_id: r.output for r in cb.run()}
        outs.append([by_id[i] for i in ids])
    assert outs[1] == outs[0] and outs[2] == outs[0]


def test_scheduler_guards(model):
    """The combinations the reference refuses, refused with its meaning."""
    _, _, tcfg, tp = model
    host = RuntimeConfig(decode_policy=1, stream_weights=True)
    streamed = RuntimeConfig(hbm_percentage=50, stream_weights=True)
    cases = [
        (NotImplementedError, "paged host kernel", dict(paged=True, runtime=host)),
        (NotImplementedError, "tiered verify", dict(paged=True, runtime=streamed, speculate_k=2)),
        (NotImplementedError, "chunk attention kernel", dict(runtime=host, speculate_k=2)),
        (ValueError, "prefill_chunk", dict(runtime=streamed, prefill_chunk=16)),
        (NotImplementedError, "int8", dict(paged=True, runtime=RuntimeConfig(
            hbm_percentage=50, quant=QuantConfig(kv_cache_dtype="int8")))),
    ]
    for exc, msg, kw in cases:
        with pytest.raises(exc, match=msg):
            ContinuousBatcher(tcfg, tp, max_batch=2, max_len=64, device="cpu", **kw)


def test_serving_state_lives_where_the_plan_puts_it(model):
    """The ragged state's lengths are [B], the streamed segment's cache on the
    host under a host-KV plan and on the device otherwise."""
    _, _, tcfg, tp = model
    for policies, host in (((3, 3), False), ((0, 0), True)):
        cb = ContinuousBatcher(tcfg, tp, max_batch=3, max_len=64, device="cpu",
                               runtime=runtimes(50, policies)[1])
        res, st = cb.state["res"], cb.state["str"]
        assert res.length.shape == (3,) and st.length.shape == (3,)
        assert cb.sched.kv_host == host and st.k.device == torch.device("cpu")
