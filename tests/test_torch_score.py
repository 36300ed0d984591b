"""The port's logits processors and loglikelihood scoring against the JAX
package on the CPU, in fp32.

The processors (repetition penalty, min-new-tokens, no-repeat-ngram) on the
same arrays, then inside ``generate`` (stepwise, fused and under the tiered
scheduler) token for token; ``loglikelihood``/``score`` resident and under
the scheduler: sums within 1e-4, the same greedy flags, and the reference's
additivity and unscorable-record rules.
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
from lia_tpu.ops import sampling as jsampling
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.utils.checkpoint import params_from_jax

PROMPTS = [[5, 9, 5, 9, 23, 41], [100, 7, 3], [8, 8, 8, 8]]
PROC = dict(repetition_penalty=1.3, no_repeat_ngram_size=2, min_new_tokens=4, eos_token_id=2)
CONTEXTS = [[5, 9, 23], [100, 7, 3, 4, 4], [], [8, 8]]
CONTINUATIONS = [[41, 100, 7], [9], [12, 13, 14], [8, 8, 8, 8]]


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def model():
    """opt-tiny at 4 layers in fp32 (scale raised so greedy margins are wide),
    as (jax cfg, jax params, port cfg, port params)."""
    jcfg = j_get_config("opt-tiny").replace(num_layers=4, dtype="float32")
    jp = j_init(jcfg, seed=17, scale=0.05)
    return jcfg, jp, get_config("opt-tiny").replace(num_layers=4, dtype="float32"), params_from_jax(jp)


def _engines(model, kv="none", **kw):
    jcfg, jp, tcfg, tp = model
    return (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv), **kw)),
            InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **kw), device="cpu"))


# ---------------------------------------------------------------------------
# the processors on the same arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ban_repeated_ngrams_matches_lia_tpu(n):
    """Every cur_len, pads in the history, HF's n == 1 edge case."""
    rng = np.random.default_rng(n)
    V, L = 12, 10
    hist = rng.integers(0, 4, (3, L)).astype(np.int32)  # a small alphabet: many repeats
    logits = rng.standard_normal((3, V)).astype(np.float32)
    for cur_len in range(0, L + 1):
        ref = jsampling.ban_repeated_ngrams(jnp.asarray(logits), jnp.asarray(hist), jnp.asarray(cur_len), n)
        out = sampling.ban_repeated_ngrams(t(logits), t(hist), cur_len, n)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_process_logits_and_seen_match_lia_tpu():
    rng = np.random.default_rng(0)
    V = 32
    tokens = rng.integers(0, V, (3, 7)).astype(np.int32)
    tokens[1, 0] = 40  # outside the vocabulary: the trash column
    mask = rng.random((3, 7)) < 0.7
    seen_j = jsampling.seen_from_prompt(jnp.asarray(tokens), jnp.asarray(mask), V)
    seen_t = sampling.seen_from_prompt(t(tokens), t(mask), V)
    np.testing.assert_array_equal(seen_t.numpy(), np.asarray(seen_j))
    tok = np.array([3, 31, 0], np.int32)
    seen_j = jsampling.update_seen(seen_j, jnp.asarray(tok))
    assert sampling.update_seen(seen_t, t(tok)) is seen_t  # in place
    np.testing.assert_array_equal(seen_t.numpy(), np.asarray(seen_j))
    logits = (rng.standard_normal((3, V)) * 4).astype(np.float32)
    for kw, n_gen in ((PROC, 1), (PROC, 4), (dict(repetition_penalty=0.8), 0), (dict(no_repeat_ngram_size=3), 0)):
        jg, tg = JGen(**kw), GenerationConfig(**kw)
        ref = jsampling.process_logits(jnp.asarray(logits), jg, seen_j, n_gen, history=jnp.asarray(tokens),
                                       cur_len=jnp.asarray(6))
        out = sampling.process_logits(t(logits), tg, seen_t, n_gen, history=t(tokens), cur_len=6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the processors inside generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_generate_with_processors_matches_lia_tpu(model, kv):
    """Stepwise and fused, token for token: the two decode loops record a token in
    the processors' state before (stepwise) or after (fused) the EOS pad, as
    the reference's."""
    jeng, teng = _engines(model, kv)
    for kw in (PROC, dict(repetition_penalty=0.7, no_repeat_ngram_size=1)):
        jg, tg = JGen(max_new_tokens=8, **kw), GenerationConfig(max_new_tokens=8, **kw)
        for fused in (False, True):
            np.testing.assert_array_equal(teng.generate(PROMPTS, tg, fused=fused).sequences,
                                          jeng.generate(PROMPTS, jg, fused=fused).sequences)


def test_processors_change_the_tokens(model):
    _, teng = _engines(model)
    plain = teng.generate(PROMPTS, GenerationConfig(max_new_tokens=8)).sequences
    banned = teng.generate(PROMPTS, GenerationConfig(max_new_tokens=8, no_repeat_ngram_size=1)).sequences
    assert not np.array_equal(plain, banned)
    for row in banned:  # n = 1: no generated token repeats one before it
        assert len(set(row.tolist())) == len(row)


@pytest.mark.parametrize("policies,hbm,kv", [((3, 3), 50, "none"), ((0, 0), 50, "int8"), ((0, 2), 0, "none")])
def test_scheduler_generate_with_processors_matches_lia_tpu(model, policies, hbm, kv):
    jeng, teng = _engines(model, kv, hbm_percentage=hbm, stream_weights=hbm == 0, prefill_policy=policies[0],
                          decode_policy=policies[1])
    assert teng.scheduler is not None
    jg, tg = JGen(max_new_tokens=7, **PROC), GenerationConfig(max_new_tokens=7, **PROC)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tg).sequences, jeng.generate(PROMPTS, jg).sequences)


# ---------------------------------------------------------------------------
# loglikelihood / score
# ---------------------------------------------------------------------------


def _check_score(jeng, teng):
    ll_j, greedy_j = jeng.score(CONTEXTS, CONTINUATIONS)
    ll_t, greedy_t = teng.score(CONTEXTS, CONTINUATIONS)
    assert ll_t.dtype == np.float64 and greedy_t.dtype == bool
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(greedy_t, greedy_j)
    np.testing.assert_allclose(teng.loglikelihood(CONTEXTS, CONTINUATIONS), ll_j, rtol=1e-4, atol=1e-4)


def test_score_matches_lia_tpu(model):
    jeng, teng = _engines(model)
    _check_score(jeng, teng)
    # a greedy continuation is flagged greedy
    ctx = [[5, 9, 23, 41]]
    cont = [teng.generate(ctx, GenerationConfig(max_new_tokens=4)).sequences[0].tolist()]
    assert teng.score(ctx, cont)[1][0] and jeng.score(ctx, cont)[1][0]


@pytest.mark.parametrize("kw", [dict(hbm_percentage=50, stream_weights=True),
                                dict(hbm_percentage=0, prefill_policy=0, decode_policy=0, kv="int8")],
                         ids=["h50-p3", "h0-p0-int8kv"])
def test_score_under_the_scheduler_matches_lia_tpu(model, kw):
    kw = dict(kw)
    kv = kw.pop("kv", "none")
    jeng, teng = _engines(model, kv, **kw)
    assert teng.scheduler is not None
    _check_score(jeng, teng)


def test_loglikelihood_rules(model):
    """Additivity (ll(c, a+b) = ll(c, a) + ll(c+a, b)); a first token with no
    position before it (an empty context filling the whole bucket) left
    unscored, as the reference does; records with nothing to score refused."""
    jeng, teng = _engines(model)
    ctx, a, b = [5, 9, 23], [41, 100], [7]
    ll_ab = teng.loglikelihood([ctx], [a + b])[0]
    ll_a, ll_b = teng.loglikelihood([ctx], [a])[0], teng.loglikelihood([ctx + a], [b])[0]
    np.testing.assert_allclose(ll_ab, ll_a + ll_b, rtol=1e-4, atol=1e-4)
    full = list(range(10, 26))  # 16 tokens: the bucket holds no pad
    ll, greedy = teng.score([[]], [full])
    np.testing.assert_allclose(ll[0], teng.loglikelihood([full[:1]], [full[1:]])[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ll, jeng.score([[]], [full])[0], rtol=1e-4, atol=1e-4)
    for contexts, conts in (([[1, 2]], [[]]), ([[]], [[5]])):
        with pytest.raises(ValueError):
            teng.loglikelihood(contexts, conts)
