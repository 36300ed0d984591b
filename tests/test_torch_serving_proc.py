"""The port's per-request logits processors in continuous batching
(lia_tpu_torch.ops.sampling's per-row functions and ContinuousBatcher with
enable_processors) against lia_tpu, on the CPU, in fp32.

As tests/test_torch_serving.py: lia_tpu's dummy opt-tiny tree at scale 0.12,
carried across with params_from_jax, the same requests through both batchers;
every request's tokens and the decode step and dispatch counters must be
equal. Repetition penalty, min-new-tokens and no-repeat-ngram, per engine and
per request, on the slab, paged, fused and tiered paths; one request over
HTTP.
"""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import sampling as jsampling
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, RuntimeConfig
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.serve import ServingFrontend, make_handler
from lia_tpu_torch.utils.checkpoint import params_from_jax

PROMPTS = [[5, 9, 23, 41], [100, 7, 3], [8, 8, 8, 8, 8, 12, 13], [50, 60]]
SYS = [((7 * i) % 300) + 2 for i in range(40)]  # a 40-token prompt: two of them share 5 pages
COUNTERS = ("decode_steps", "decode_dispatches", "prefix_hits", "prefix_tokens_reused")


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=21, scale=0.12)
    return jcfg, jp, get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp)


def serve(model, prompts, new_tokens=6, gen_kw=None, submit_kw=None, runtime=False, **kw):
    """The same requests through lia_tpu's batcher and the port's (with
    ``runtime``, both over their schedulers at hbm 50); returns (lia_tpu
    outputs, port outputs, lia_tpu stats, port stats, port batcher)."""
    jcfg, jp, tcfg, tp = model
    gen_kw = dict(max_new_tokens=new_tokens, **(gen_kw or {}))
    submit_kw = submit_kw or [{}] * len(prompts)
    rt = dict(hbm_percentage=50, stream_weights=True)
    out = []
    for batcher in (
        JBatcher(jcfg, jp, gen=JGen(**gen_kw), runtime=JRuntime(**rt) if runtime else None, **kw),
        ContinuousBatcher(tcfg, tp, gen=GenerationConfig(**gen_kw), runtime=RuntimeConfig(**rt) if runtime else None,
                          device="cpu", **kw),
    ):
        ids = [batcher.submit(p, **s) for p, s in zip(prompts, submit_kw)]
        by_id = {r.req_id: r.output for r in batcher.run()}
        out.append(([by_id[i] for i in ids], batcher.stats(), batcher))
    (jo, js, _), (to, ts, tb) = out
    return jo, to, js, ts, tb


def assert_same(jo, to, js, ts):
    for i, (a, b) in enumerate(zip(jo, to)):
        assert b == [int(x) for x in a], f"request {i}"
    for k in COUNTERS:
        assert ts.get(k) == js.get(k), k


def test_row_processors_match_lia_tpu():
    """process_logits_rows, mark_seen and ban_tokens_rows on seeded inputs:
    per-row penalties (1.0 = off), EOS suppressed on some rows and with no
    EOS id, marks on active rows only, and ban lists padded with -1."""
    rng = np.random.default_rng(3)
    B, V = 5, 97
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    seen = rng.random((B, V)) < 0.2
    rep = np.array([1.0, 1.3, 0.8, 2.0, 1.0], np.float32)
    sup = np.array([True, False, True, False, True])
    for eos in (4, None):
        out = sampling.process_logits_rows(torch.from_numpy(logits), torch.from_numpy(seen), torch.from_numpy(rep),
                                           torch.from_numpy(sup), eos)
        ref = jsampling.process_logits_rows(jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(rep),
                                            jnp.asarray(sup), eos)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    toks = rng.integers(0, V, B).astype(np.int32)
    active = np.array([True, True, False, True, False])
    marked = sampling.mark_seen(torch.from_numpy(seen.copy()), torch.from_numpy(toks), torch.from_numpy(active))
    ref = jsampling.mark_seen(jnp.asarray(seen), jnp.asarray(toks), jnp.asarray(active))
    np.testing.assert_array_equal(marked.numpy(), np.asarray(ref))
    banned = np.full((B, 8), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(0, 8))
        banned[b, :n] = rng.choice(V, n, replace=False)
    banned[2, :3] = [0, 0, V - 1]  # a repeated id and the vocabulary's edges
    out = sampling.ban_tokens_rows(torch.from_numpy(logits), torch.from_numpy(banned))
    ref = jsampling.ban_tokens_rows(jnp.asarray(logits), jnp.asarray(banned))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


REP = {
    "slab": dict(),
    "paged": dict(paged=True, block_size=8),
    "fused-slab": dict(fused_steps=4),
    "fused-paged": dict(paged=True, block_size=8, fused_steps=3),
}


@pytest.mark.parametrize("name", list(REP))
def test_repetition_penalty_matches_lia_tpu(model, name):
    """An engine-level penalty and min_new_tokens with a per-request penalty
    beside it, on the slab, the paged pool (a prefix-cache hit among them)
    and in fused blocks, where the presence mask is updated on the device."""
    prompts = PROMPTS + [SYS, SYS]
    submit_kw = [{}, dict(repetition_penalty=2.0), {}, dict(repetition_penalty=1.0), {}, {}]
    jo, to, js, ts, tb = serve(model, prompts, new_tokens=7, submit_kw=submit_kw, max_batch=2, max_len=128,
                               gen_kw=dict(repetition_penalty=1.4, min_new_tokens=3, eos_token_id=2), **REP[name])
    assert_same(jo, to, js, ts)
    if name.startswith("fused"):
        assert ts["decode_dispatches"] < ts["decode_steps"]
    if tb.paged:
        assert ts["prefix_hits"] == 1


def test_min_new_tokens_per_request_override(model):
    """One of the greedy trajectory's tokens is the EOS: the default request
    stops at it, the request with min_new_tokens 5 is held past it."""
    _, _, tcfg, tp = model
    solo = ContinuousBatcher(tcfg, tp, max_batch=1, max_len=96, gen=GenerationConfig(max_new_tokens=6),
                             device="cpu")
    solo.submit([5, 9, 23, 41])
    traj = solo.run()[0].output
    eos = traj[2]
    jo, to, js, ts, _ = serve(model, [[5, 9, 23, 41]] * 2, gen_kw=dict(eos_token_id=eos),
                              submit_kw=[{}, dict(min_new_tokens=5)], max_batch=2, max_len=96,
                              enable_processors=True)
    assert_same(jo, to, js, ts)
    assert to[0] == traj[:3]
    assert len(to[1]) >= 5 and eos not in to[1][:4]


def test_per_request_ngram_keeps_per_step(model):
    """A per-request no_repeat_ngram_size beside a plain request: the plain one
    gives plain serving's tokens, the banned one repeats no token, and every
    step is its own dispatch while the n-gram slot runs."""
    prompt = [5, 9, 5, 9, 23]
    jo, to, js, ts, _ = serve(model, [prompt, prompt, [100, 7, 3]], submit_kw=[{}, dict(no_repeat_ngram_size=1),
                                                                             dict(no_repeat_ngram_size=2)],
                              max_batch=3, max_len=96, enable_processors=True, fused_steps=4)
    assert_same(jo, to, js, ts)
    _, plain, _, _, _ = serve(model, [prompt], max_batch=1, max_len=96)
    assert to[0] == plain[0]
    assert len(set(to[1])) == len(to[1]) and not set(to[1]) & set(prompt)
    assert ts["steps_per_dispatch"] == 1.0


def test_finished_ngram_slot_lets_blocks_fuse(model):
    """A deliberate divergence from lia_tpu: once the n-gram request has
    finished, its slot's n-gram size no longer holds fused decode off, so the
    long request behind it decodes in blocks. Its tokens are lia_tpu's; only
    the dispatch count differs (lia_tpu keeps the per-step path)."""
    jo, to, js, ts, tb = serve(model, [[5, 9, 5, 9, 23], [100, 7, 3]], new_tokens=12, max_batch=2, max_len=96,
                               submit_kw=[dict(no_repeat_ngram_size=2, max_new_tokens=2), {}],
                               enable_processors=True, fused_steps=4)
    assert [[int(x) for x in o] for o in jo] == to and len(to[0]) == 2 and len(to[1]) == 12
    assert ts["decode_steps"] == js["decode_steps"]
    assert js["steps_per_dispatch"] == 1.0 and ts["decode_dispatches"] < js["decode_dispatches"]
    assert tb.s_ngram[0] == 2 and not tb.active.any()  # the value stays; the finished slot is masked


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_processors_over_scheduler_match_lia_tpu(model, paged):
    """Penalty, min_new_tokens and a per-request n-gram over the tiered
    scheduler at policy 3, hbm 50, slab and paged."""
    jo, to, js, ts, tb = serve(model, PROMPTS, runtime=True, paged=paged, block_size=8, max_batch=2, max_len=128,
                               gen_kw=dict(repetition_penalty=1.3, min_new_tokens=2, eos_token_id=2),
                               submit_kw=[{}, dict(no_repeat_ngram_size=2), dict(repetition_penalty=1.0), {}])
    assert_same(jo, to, js, ts)
    assert tb.sched is not None


def test_http_generate_with_repetition_penalty(model):
    """POST /generate with repetition_penalty through ServingFrontend over a
    batcher with the processors on: the output is lia_tpu's."""
    jcfg, jp, tcfg, tp = model
    prompt = [8, 8, 8, 8, 8, 12, 13]
    direct = JBatcher(jcfg, jp, max_batch=2, max_len=96, gen=JGen(max_new_tokens=6), enable_processors=True)
    direct.submit(prompt, repetition_penalty=1.5)
    want = [int(x) for x in direct.run()[0].output]
    cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=96, gen=GenerationConfig(max_new_tokens=6),
                           enable_processors=True, device="cpu")
    frontend = ServingFrontend(cb)
    frontend.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(frontend))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        conn.request("POST", "/generate", json.dumps({"prompt_ids": prompt, "repetition_penalty": 1.5}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        status, out = r.status, json.loads(r.read())
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        frontend.stop()
    assert status == 200 and out["output_ids"] == want
