"""The RoPE families (llama, mistral, qwen2, gpt-j, gpt-neox) and the two
layouts OPT's main test model leaves out (opt-350m: post-norm, projections,
no final norm; gptbigcode: one KV head, gelu_new, tied head) through the
port's user paths against the JAX package, in fp32 on the CPU: greedy
generate (stepwise and fused, bf16 and int8 KV) and grouped beam search for
all of them; the tiered scheduler, continuous batching (slab, and paged with
prefix caching and chunked admission) and scoring for all but opt-350m,
whose layout those paths share with OPT's main test model. Tokens are
exact; scores within 1e-4.

The reference's dummy trees are drawn at scale 0.2 (greedy margins wide and
tokens varied), with their zero biases replaced by seeded ones so that bias
layouts matter, and carried across with params_from_jax. mistral-tiny runs
with a window of 8 and decodes past it.
"""

import functools

import pytest

pytest.importorskip("jax")

import numpy as np

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.utils.checkpoint import params_from_jax

ROPE = ["llama-tiny", "mistral-tiny", "qwen2-tiny", "gptj-tiny", "neox-tiny"]
FAMILIES = ROPE + ["opt-350m", "gptbigcode-tiny"]
SERVED = ROPE + ["gptbigcode-tiny"]  # the families also run tiered, served and scored
PROMPTS = [[5, 9, 23, 41, 7, 7, 19], [100, 7, 3], list(range(30, 52))]
NEW = 10  # decodes past mistral's window of 8 from every prompt
# the opt-350m layout at a test width: post-norm, 512-wide embeddings projected
# in and out, no final norm
OPT350M_TINY = dict(hidden_size=64, ffn_size=128, num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
                    word_embed_proj_dim=32, vocab_size=503, max_position_embeddings=128)


def _cfg(get, name):
    if name == "opt-350m":
        return get(name).replace(dtype="float32", **OPT350M_TINY)
    cfg = get(name).replace(dtype="float32")
    return cfg.replace(sliding_window=8) if name == "mistral-tiny" else cfg


def _with_biases(tree, rng):
    """The tree with every bias leaf (layers' b*, norms' bias) drawn from rng."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                    if (k.startswith("b") or k == "bias") and not isinstance(v, dict) else _with_biases(v, rng))
                for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def model(name):
    """(jax cfg, jax params, port cfg, port params) of a family, made once."""
    jcfg = _cfg(j_get_config, name)
    jp = _with_biases(j_init(jcfg, seed=23, scale=0.2), np.random.default_rng(5))
    return jcfg, jp, _cfg(get_config, name), params_from_jax(jp)


@functools.lru_cache(maxsize=None)
def _engines(name, kv, kw):
    jcfg, jp, tcfg, tp = model(name)
    return (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv), **dict(kw))),
            InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **dict(kw)), device="cpu"))


def engines(name, kv="none", **kw):
    """(lia_tpu engine, port engine) of a family, made once per runtime: the
    tests share them, and with them lia_tpu's compiled functions."""
    return _engines(name, kv, tuple(sorted(kw.items())))


def test_rope_families_admitted_and_others_raise():
    """Every RoPE family the port holds against the reference is admitted
    (falcon, chatglm, baichuan and stablelm since they have converters and
    token tests, tests/test_torch_new_families.py; codegen since it has its
    converter and token tests, tests/test_torch_head_dims.py), and so are
    the ALiBi families (tests/test_torch_alibi.py); mixture of experts still
    raises, naming what is missing and its ROADMAP item."""
    for name in FAMILIES + ["falcon-tiny", "stablelm-tiny", "baichuan-tiny", "chatglm-tiny", "falcon-7b",
                            "chatglm3-6b", "baichuan2-7b", "stablelm-2-1.6b", "codegen-tiny", "codegen-2b",
                            "codegen-6b", "baichuan2-tiny", "baichuan-13b", "bloom-tiny", "mpt-30b"]:
        T.check_supported(get_config(name))
    for name, what in (("mixtral-tiny", "mixture of experts"), ("mixtral-tiny", "A12")):
        with pytest.raises(NotImplementedError, match=what):
            T.check_supported(get_config(name))


@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_generate_matches_lia_tpu(name, kv):
    """Greedy tokens, stepwise and fused, equal lia_tpu's."""
    jeng, teng = engines(name, kv)
    jgen, tgen = JGen(max_new_tokens=NEW), GenerationConfig(max_new_tokens=NEW)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen).sequences, jeng.generate(PROMPTS, jgen).sequences)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen, fused=True).sequences,
                                  jeng.generate(PROMPTS, jgen, fused=True).sequences)


@pytest.mark.parametrize("name", FAMILIES)
def test_generate_beam_matches_lia_tpu(name):
    """Grouped beam search, 3 beams, equals lia_tpu's."""
    jeng, teng = engines(name)
    gen = dict(max_new_tokens=NEW, num_beams=3)
    np.testing.assert_array_equal(teng.generate_beam(PROMPTS, GenerationConfig(**gen)).sequences,
                                  jeng.generate_beam(PROMPTS, JGen(**gen), grouped=True).sequences)


@pytest.mark.parametrize("name", SERVED)
def test_tiered_matches_lia_tpu(name):
    """The tiered scheduler at hbm 50, under policy 3 and policy 0 (streamed KV
    on the host), gives lia_tpu's tokens: those of its resident engine, which
    the other tests have compiled already. lia_tpu's own tests hold its
    scheduler to that engine; under a window the engine is the only reference,
    since lia_tpu's scheduler builds its attention contexts without the window
    (its runtime/scheduler.py :141, :157-161)."""
    gen = dict(max_new_tokens=NEW)
    ref = engines(name)[0].generate(PROMPTS, JGen(**gen)).sequences
    _, _, tcfg, tp = model(name)
    for kw in (dict(hbm_percentage=50, stream_weights=True), dict(hbm_percentage=50, prefill_policy=0,
                                                                  decode_policy=0)):
        teng = InferenceEngine(tcfg, tp, RuntimeConfig(**kw), device="cpu")
        assert teng.scheduler is not None
        np.testing.assert_array_equal(teng.generate(PROMPTS, GenerationConfig(**gen)).sequences, ref)


SYS = [((7 * i) % 300) + 2 for i in range(20)]
SERVE_PROMPTS = [SYS + [401, 402, 403], [8, 8, 8, 8, 8, 12, 13], SYS + [404, 405], list(range(3, 43)), [50, 60]]


@pytest.mark.parametrize("opts", [dict(), dict(paged=True, block_size=8, prefill_chunk=16)],
                         ids=["slab", "paged-apc-chunked"])
@pytest.mark.parametrize("name", SERVED)
def test_serving_matches_lia_tpu(name, opts):
    """ContinuousBatcher (slab; paged with prefix caching and chunked admission)
    gives each request lia_tpu's tokens and the same prefix hits."""
    jcfg, jp, tcfg, tp = model(name)
    outs, stats = [], []
    for batcher in (JBatcher(jcfg, jp, gen=JGen(max_new_tokens=NEW), max_batch=2, max_len=128, **opts),
                    ContinuousBatcher(tcfg, tp, gen=GenerationConfig(max_new_tokens=NEW), max_batch=2, max_len=128,
                                      device="cpu", **opts)):
        ids = [batcher.submit(p) for p in SERVE_PROMPTS]
        by_id = {r.req_id: [int(x) for x in r.output] for r in batcher.run()}
        outs.append([by_id[i] for i in ids])
        stats.append(batcher.stats())
    assert outs[1] == outs[0]
    assert stats[1].get("prefix_hits") == stats[0].get("prefix_hits")


@pytest.mark.parametrize("name", SERVED)
def test_score_matches_lia_tpu(name):
    jeng, teng = engines(name)
    ctx, cont = [[5, 9, 23, 41], [100, 7, 3, 8, 9]], [[7, 19, 2], [44]]
    ll_j, greedy_j = jeng.score(ctx, cont)
    ll_t, greedy_t = teng.score(ctx, cont)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(greedy_t, greedy_j)


def test_server_builds_a_rope_family():
    """The HTTP server's front end (random weights from the registry) builds
    a llama and serves a request with the resident engine's tokens."""
    from lia_tpu_torch.serve import build_frontend, parse_args

    frontend = build_frontend(parse_args(["-m", "llama-tiny", "--device", "cpu", "--dtype", "float32",
                                          "--max-new-tokens", "6", "--max-len", "128"]))
    cb = frontend.batcher
    rid = cb.submit(PROMPTS[0])
    out = {r.req_id: r.output for r in cb.run()}[rid]
    eng = InferenceEngine(cb.cfg, cb.params, device="cpu")
    ref = eng.generate([PROMPTS[0]], GenerationConfig(max_new_tokens=6)).sequences[0]
    assert [int(t) for t in out] == ref.tolist()
