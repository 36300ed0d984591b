"""The port's continuous batching (lia_tpu_torch.engine.serving) against
lia_tpu.engine.serving on the CPU, in fp32.

The parameters are lia_tpu's dummy tree at scale 0.12 (decisive greedy margins,
as tests/test_serving.py uses), carried across with params_from_jax; each
configuration runs the same requests through both batchers, and every request's
tokens, the decode step and dispatch counts and the prefix-cache counters must
be equal.
"""

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.utils.checkpoint import params_from_jax

SYS = [((11 * i) % 300) + 2 for i in range(40)]  # a shared 40-token system prompt
PROMPTS = [[5, 9, 23, 41], SYS + [401, 402, 403], [8, 8, 8, 8, 8, 12, 13], SYS + [404, 405, 406, 407],
           list(range(3, 43)), [50, 60]]
COUNTERS = ("decode_steps", "decode_dispatches", "prefix_hits", "prefix_tokens_reused")


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=21, scale=0.12)
    return jcfg, jp, get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp)


def serve(model, prompts, new_tokens=6, gen_kw=None, submit_kw=None, **kw):
    """The same requests through lia_tpu's batcher and the port's; returns
    (lia_tpu outputs, port outputs, lia_tpu stats, port stats, port batcher),
    outputs in submission order."""
    jcfg, jp, tcfg, tp = model
    gen_kw = dict(max_new_tokens=new_tokens, **(gen_kw or {}))
    submit_kw = submit_kw or [{}] * len(prompts)
    out = []
    for batcher in (JBatcher(jcfg, jp, gen=JGen(**gen_kw), **kw),
                    ContinuousBatcher(tcfg, tp, gen=GenerationConfig(**gen_kw), device="cpu", **kw)):
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


def pool_clean(cb):
    """Every page free or prefix-cached, every refcount 0 (null page excluded)."""
    assert not cb.active.any() and not cb.queue
    assert (cb.page_rc == 0).all()
    assert len(cb.free_blocks) + len(cb.cached_pages) == cb.num_blocks - 1


CONFIGS = {
    "slab": dict(),
    "slab-int8kv": dict(kv_quantized=True),
    "paged": dict(paged=True, block_size=8),
    "paged-noapc": dict(paged=True, block_size=8, prefix_cache=False),
    "chunked": dict(prefill_chunk=16),
    "chunked-paged-apc": dict(paged=True, block_size=8, prefill_chunk=16),
    "fused-slab": dict(fused_steps=4),
    "fused-paged": dict(paged=True, block_size=8, fused_steps=3),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serving_matches_lia_tpu(model, name):
    """Slab (bf16 / int8 KV), paged with and without prefix caching, chunked
    admission (slab, paged + prefix caching) and fused blocks: the same
    tokens per request and the same counters as lia_tpu's batcher."""
    jo, to, js, ts, tb = serve(model, PROMPTS, max_batch=2, max_len=128, **CONFIGS[name])
    assert_same(jo, to, js, ts)
    if tb.paged:
        pool_clean(tb)
        assert ts["prefix_hits"] == (0 if name == "paged-noapc" else 1)
    if name.startswith("fused"):
        assert ts["decode_dispatches"] < ts["decode_steps"]


def test_serving_matches_static_engine(model):
    """Each request's tokens equal what the port's engine generates for it alone."""
    _, _, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, device="cpu")
    gen = GenerationConfig(max_new_tokens=6)
    ref = [list(eng.generate([p], gen).sequences[0]) for p in PROMPTS[:4]]
    cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=128, gen=gen, device="cpu")
    ids = [cb.submit(p) for p in PROMPTS[:4]]
    by_id = {r.req_id: r.output for r in cb.run()}
    assert [by_id[i] for i in ids] == ref


def test_serving_slot_reuse_and_stats(model):
    _, _, tcfg, tp = model
    cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=64, gen=GenerationConfig(max_new_tokens=4), device="cpu")
    for _ in range(5):
        cb.submit([3, 4, 5])
    assert len(cb.run()) == 5
    s = cb.stats()
    assert s["requests"] == 5 and s["total_tokens"] == 20 and s["tokens_per_s"] > 0
    for k in ("p50_ttft_s", "p90_ttft_s", "p99_ttft_s", "p50_tpot_s", "p99_tpot_s"):
        assert s[k] > 0
    assert not cb.active.any() and not cb.queue  # 2 slots served 5 requests


@pytest.mark.parametrize("chunked", [False, True])
def test_serving_rejects_oversized(model, chunked):
    _, _, tcfg, tp = model
    cb = ContinuousBatcher(tcfg, tp, max_batch=1, max_len=32, gen=GenerationConfig(max_new_tokens=30),
                           prefill_chunk=16 if chunked else None, device="cpu")
    cb.submit(list(range(3, 30)))  # 32 slots + 30 new > 32
    with pytest.raises(ValueError, match="max_len"):
        cb.run()


@pytest.mark.parametrize("paged", [False, True])
def test_serving_eos_matches_lia_tpu(model, paged):
    """An EOS (the first greedy token of another prompt) ends a request early."""
    _, _, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, device="cpu")
    eos = int(eng.generate([[7, 8, 9]], GenerationConfig(max_new_tokens=2)).sequences[0, 0])
    jo, to, js, ts, _ = serve(model, [[7, 8, 9], [5, 9, 23, 41]], new_tokens=50,
                              gen_kw=dict(eos_token_id=eos, pad_token_id=1), max_batch=2, max_len=256,
                              paged=paged, block_size=8)
    assert_same(jo, to, js, ts)
    assert to[0][-1] == eos and len(to[0]) < 50


def test_paged_serving_memory_backpressure(model):
    """A pool too small for every request at once: admission waits for frees."""
    prompts = [[5, 9, 23], [100, 7], [8, 8, 8], [50, 60, 61, 62]]
    jo, to, js, ts, tb = serve(model, prompts, new_tokens=4, max_batch=4, max_len=64, paged=True, block_size=8,
                               num_blocks=5)
    assert_same(jo, to, js, ts)
    assert len(to) == 4
    pool_clean(tb)


def test_prefix_cache_repeat_prompt(model):
    """A resubmitted 40-token prompt hits the cache: base 24, 3 shared blocks."""
    _, _, tcfg, tp = model
    prompt = [((7 * i) % 300) + 2 for i in range(40)]
    cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=128, gen=GenerationConfig(max_new_tokens=5), paged=True,
                           block_size=8, device="cpu")
    first = cb.submit(prompt)
    cb.run()
    assert cb.prefix_hits == 0
    second = cb.submit(prompt)
    done = {r.req_id: r.output for r in cb.run()}
    assert cb.prefix_hits == 1 and cb.prefix_tokens_reused == 24  # n=40: Cb=16, base=24
    assert done[second] == done[first]
    pool_clean(cb)


def test_prefix_cache_unaligned_boundary_matches_lia_tpu(model):
    """base 28 is not block-aligned: the boundary page is rewritten privately
    from the seeded values; both requests give the uncached tokens."""
    prompt = [((13 * i) % 300) + 2 for i in range(44)]
    jo, to, js, ts, tb = serve(model, [prompt, prompt], new_tokens=4, max_batch=1, max_len=128, paged=True,
                               block_size=8)
    assert_same(jo, to, js, ts)
    assert ts["prefix_hits"] == 1 and ts["prefix_tokens_reused"] == 28 and to[0] == to[1]
    pool_clean(tb)


def test_prefix_cache_eviction_under_pressure_matches_lia_tpu(model):
    """Cached (refcount 0) pages are reclaimed FIFO when the pool runs dry; the
    hit disappears, the tokens do not change."""
    p1 = [((7 * i) % 300) + 2 for i in range(40)]
    p2 = [((17 * i) % 300) + 9 for i in range(40)]
    jo, to, js, ts, tb = serve(model, [p1, p2, p1], new_tokens=4, max_batch=1, max_len=128, paged=True,
                               block_size=8, num_blocks=11)
    assert_same(jo, to, js, ts)
    assert to[0] == to[2]
    pool_clean(tb)


def test_chunked_paged_pool_too_small_raises(model):
    _, _, tcfg, tp = model
    for chunk in (None, 16):
        cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=128, gen=GenerationConfig(max_new_tokens=4),
                               paged=True, block_size=8, num_blocks=3, prefill_chunk=chunk, device="cpu")
        cb.submit(list(range(2, 40)))  # needs ceil(42/8) = 6 pages, the pool has 2
        with pytest.raises(ValueError, match="pool"):
            cb.run()


def test_chunked_admission_interleaves_with_decode(model):
    """While a 40-token prompt is admitted in 16-token chunks, the running
    request keeps decoding: steps happen between the chunks."""
    _, _, tcfg, tp = model
    cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=128, gen=GenerationConfig(max_new_tokens=6),
                           prefill_chunk=16, device="cpu")
    cb.submit([5, 9, 23, 41])
    cb.step()  # admits the short prompt (one chunk) and decodes
    cb.submit(list(range(3, 43)))
    steps = []
    while cb._pending is not None or cb.queue:
        before = cb._steps
        cb.step()
        steps.append(cb._steps - before)
    assert len(steps) >= 2 and all(n == 1 for n in steps)


def test_per_request_stop_tokens_match_lia_tpu(model):
    """A request's own stop token ends it (the stop kept), its batchmate runs on."""
    _, _, tcfg, tp = model
    solo = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=96, gen=GenerationConfig(max_new_tokens=8), device="cpu")
    solo.submit([5, 9, 23, 41])
    ref = solo.run()[0].output
    stop = ref[3]
    jo, to, js, ts, _ = serve(model, [[5, 9, 23, 41]] * 2, new_tokens=8,
                              submit_kw=[dict(stop_token_ids=[stop]), {}], max_batch=2, max_len=96)
    assert_same(jo, to, js, ts)
    assert to[0] == ref[: ref.index(stop) + 1] and to[1] == ref


@pytest.mark.parametrize("fused", [1, 3])
def test_per_request_sampling(model, fused):
    """A greedy and a hot sampled request decode in one batch: the greedy one
    equals a solo greedy run and lia_tpu's; the sampled one stays in the
    vocabulary, differs from greedy, and repeats under the same seed."""
    _, _, tcfg, tp = model
    gen = GenerationConfig(max_new_tokens=8)
    outs = []
    for _ in range(2):
        cb = ContinuousBatcher(tcfg, tp, max_batch=2, max_len=96, gen=gen, fused_steps=fused, device="cpu")
        g = cb.submit([5, 9, 23, 41])
        s = cb.submit([5, 9, 23, 41], do_sample=True, temperature=1.5, top_k=50)
        by_id = {r.req_id: r.output for r in cb.run()}
        outs.append((by_id[g], by_id[s]))
    jo, _, _, _, _ = serve(model, [[5, 9, 23, 41]], new_tokens=8, max_batch=2, max_len=96)
    assert outs[0][0] == [int(x) for x in jo[0]]
    assert outs[0] == outs[1]  # the batcher's generator is seeded
    assert outs[0][1] != outs[0][0] and len(outs[0][1]) == 8
    assert all(0 <= x < tcfg.vocab_size for x in outs[0][1])


def test_sample_per_row_keeps_greedy_rows_and_top_k(model):
    """Greedy rows take the argmax; a top_k = 1 row is greedy whatever its
    temperature; sampled rows stay inside their top-k."""
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 64)).astype(np.float32))
    temp = torch.tensor([1.0, 5.0, 1.3, 0.7])
    topk = torch.tensor([0, 1, 5, 0], dtype=torch.int32)
    topp = torch.tensor([1.0, 1.0, 1.0, 0.5])
    greedy = torch.tensor([True, False, False, False])
    for seed in range(5):
        out = sampling.sample_per_row(logits, torch.Generator().manual_seed(seed), temp, topk, topp, greedy)
        assert out.dtype == torch.int32
        assert out[0] == logits[0].argmax() and out[1] == logits[1].argmax()
        assert out[2] in torch.topk(logits[2], 5).indices


@pytest.mark.parametrize("paged", [False, True])
def test_fused_steps_eos_truncates_mid_block(model, paged):
    """A slot that meets EOS inside a fused block ends at the stop token, frees
    its slot, and the next request gets it; as lia_tpu does."""
    _, _, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, device="cpu")
    eos = int(eng.generate([[7, 8, 9]], GenerationConfig(max_new_tokens=2)).sequences[0, 0])
    jo, to, js, ts, _ = serve(model, [[7, 8, 9], [7, 8, 9]], new_tokens=50,
                              gen_kw=dict(eos_token_id=eos, pad_token_id=1), max_batch=1, max_len=256,
                              fused_steps=8, paged=paged, block_size=8)
    assert_same(jo, to, js, ts)
    assert to[0] == to[1] and to[0][-1] == eos and len(to[0]) < 50


def test_fused_steps_with_waiting_queue(model):
    """Queued requests do not stop fusing: each request decodes its 3 tokens
    after admission in one block."""
    jo, to, js, ts, _ = serve(model, [[3, 4, 5]] * 3, new_tokens=4, max_batch=1, max_len=64, fused_steps=4)
    assert_same(jo, to, js, ts)
    assert ts["steps_per_dispatch"] >= 2.0


def test_unported_options_raise(model):
    _, _, tcfg, tp = model
    cases = {
        "A9": [dict(speculate_k=2), dict(draft=(tcfg, tp))],
        "A10": [dict(runtime=RuntimeConfig(hbm_percentage=50))],
        "A13": [dict(mesh=object())],
        "A3": [dict(enable_processors=True), dict(gen=GenerationConfig(repetition_penalty=1.2))],
    }
    for item, kws in cases.items():
        for kw in kws:
            with pytest.raises(NotImplementedError, match=item):
                ContinuousBatcher(tcfg, tp, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="int8"):
        ContinuousBatcher(tcfg, tp, paged=True, kv_quantized=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ALiBi"):
        ContinuousBatcher(get_config("bloom-tiny"), tp, device="cpu")
    cb = ContinuousBatcher(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="A3"):
        cb.submit([1, 2], repetition_penalty=1.3)
    with pytest.raises(ValueError):
        ContinuousBatcher(tcfg, tp, fused_steps=0, device="cpu")


def test_batcher_defaults_to_cuda(model):
    """Without device="cpu" the batcher runs on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tp = model
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(tcfg, tp)
