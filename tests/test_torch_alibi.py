"""ALiBi in the port against the JAX package, in fp32 on the CPU.

- ``alibi_slopes`` bit for bit at head counts that are and are not powers of
  two (Baichuan-13B's 40 takes the odd-tail interpolation).
- Every attention kernel's plain version with slopes (B1, B6, B7, B8, B2, B3,
  B9, B10, B5 at C = 1 and 5) against lia_tpu's biased ``attend`` paths over
  left-padded rows: the reference's own [B, N, S] biases
  (``alibi_prefill_bias``, ``alibi_slot_bias``, ``_alibi_beam_bias``,
  ``attend_chunk_paged``'s logical positions).
- bloom-tiny, mpt-tiny and baichuan2-tiny (ALiBi, NormHead) through every
  user path: greedy generate (stepwise and fused, fp32 and int8 KV), grouped
  beam search and scoring, paged serving with prefix caching and chunked
  admission, prompt-lookup speculation (generate and paged serving) and the
  tiered scheduler under policies 3, 0 and 0/2 (host attention) and 1. Tokens
  are exact; scores within 1e-4.
- The BLOOM, MPT and Baichuan-13B (ALiBi) Hugging Face converters bit-equal to
  lia_tpu's on seeded state dicts in the HF key layout, the converted trees'
  logits against lia_tpu's, and ``load_hf_checkpoint`` over shards written by
  the port's safetensors writer.

The reference's trees are drawn at scale 0.2 with seeded biases, built once
per module.
"""

import functools
import zlib

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models import transformer as JT
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import attention as jatt
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops import paged as jpg
from lia_tpu.ops.quant import QuantizedKV as JQKV
from lia_tpu.ops.quant import quantize_kv as j_quantize_kv
from lia_tpu.utils import checkpoint as jckpt
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.quant import quantize_kv
from lia_tpu_torch.utils import checkpoint as ckpt
from lia_tpu_torch.utils import safetensors

NAMES = ["bloom-tiny", "mpt-tiny", "baichuan2-tiny"]
PROMPTS = [[5, 9, 23, 41, 7, 7, 19], [100, 7, 3], list(range(30, 52))]
NEW = 8
TOL = 2e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


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
    jcfg = j_get_config(name).replace(dtype="float32")
    jp = _with_biases(j_init(jcfg, seed=31, scale=0.2), np.random.default_rng(7))
    return jcfg, jp, get_config(name).replace(dtype="float32"), ckpt.params_from_jax(jp)


@functools.lru_cache(maxsize=None)
def engines(name, kv="none"):
    """(lia_tpu engine, port engine) of a family, made once per KV type."""
    jcfg, jp, tcfg, tp = model(name)
    return (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv))),
            InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu"))


@pytest.mark.parametrize("n", [4, 32, 40, 64, 71])
def test_alibi_slopes_bitwise_equal(n):
    ref = np.asarray(jatt.alibi_slopes(n))
    out = att.alibi_slopes(n).numpy()
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


# ---------------------------------------------------------------------------
# the plain versions with slopes against the reference's biased attention
# ---------------------------------------------------------------------------

B, N, NKV, D = 3, 8, 4, 16
PADS = (0, 3, 9)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _valid(S, end, pads=PADS):
    m = np.zeros((len(pads), S), bool)
    for b, p in enumerate(pads):
        m[b, p:end] = True
    return m


def _prefill(rng):
    S = 20
    q, k, v = _randn(rng, B, S, N, D), _randn(rng, B, NKV, S, D), _randn(rng, B, NKV, S, D)
    m = _valid(S, S)
    pos = np.cumsum(m, 1) - 1
    ref = jatt.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jatt.causal_mask(jnp.asarray(m)),
                      bias=jatt.alibi_prefill_bias(N, jnp.asarray(pos), jnp.asarray(m)))
    out = ca.flash_attention_prefill_plain(t(q), t(k), t(v), t(m), slopes=att.alibi_slopes(N))
    return out, ref, m[:, :, None, None]


def _cached(rng):
    S, C, base = 32, 6, 14
    q, k, v = _randn(rng, B, C, N, D), _randn(rng, B, NKV, S, D), _randn(rng, B, NKV, S, D)
    sm = _valid(S, base + C)
    ref = jatt.attend_prefill_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(base, jnp.int32),
                                     jnp.asarray(sm), bias=jatt.alibi_slot_bias(N, jnp.asarray(sm)))
    out = ca.flash_attention_cached_plain(t(q), t(k), t(v), base, t(sm), slopes=att.alibi_slopes(N))
    return out, ref, None


def _plane(rng, stacked):
    S, length = 24, 17  # the plane holds this step's token at slot 16
    q, k, v = _randn(rng, B, 1, N, D), _randn(rng, 2, B, NKV, S, D), _randn(rng, 2, B, NKV, S, D)
    sm = _valid(S, length)
    ctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(length, jnp.int32),
                               bias=jatt.alibi_slot_bias(N, jnp.asarray(sm)))
    ref = jatt.attend_decode(jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]), ctx)
    sl = att.alibi_slopes(N)
    if stacked:
        out = ca.decode_attention_stacked_plain(t(q), t(k), t(v), 1, t(sm), length, slopes=sl)
    else:
        out = ca.decode_attention_plain(t(q), t(k[1]), t(v[1]), t(sm), length, slopes=sl)
    return out, ref, None


def _fresh(rng, int8):
    S, length = 24, 16  # past-only: the fresh token sits at slot 16
    q, kf, vf = _randn(rng, B, 1, N, D), _randn(rng, B, NKV, 1, D), _randn(rng, B, NKV, 1, D)
    k, v = _randn(rng, 2, B, NKV, S, D), _randn(rng, 2, B, NKV, S, D)
    sm = _valid(S, length)
    fresh_pos = sm.sum(1, keepdims=True).astype(np.int32)  # the row's real tokens so far
    ctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(length, jnp.int32),
                               bias=jatt.alibi_slot_bias(N, jnp.asarray(sm), jnp.asarray(length, jnp.int32),
                                                         jnp.asarray(fresh_pos)))
    sl = att.alibi_slopes(N)
    if int8:
        tk, tv = quantize_kv(t(k)), quantize_kv(t(v))
        jk, jv = (JQKV(jnp.asarray(p.q.numpy()), jnp.asarray(p.s.numpy())) for p in (tk, tv))
        jkf, jvf = j_quantize_kv(jnp.asarray(kf)), j_quantize_kv(jnp.asarray(vf))
        ref = jatt.attend_decode_fresh(jnp.asarray(q), jkf, jvf, jk, jv, jnp.asarray(1, jnp.int32), ctx)
        out = ca.decode_attention_fresh_int8_plain(t(q), t(kf), t(vf), tk.q, tk.s, tv.q, tv.s, 1, t(sm), length,
                                                   slopes=sl)
    else:
        ref = jatt.attend_decode_fresh(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(1, jnp.int32), ctx)
        out = ca.decode_attention_fresh_plain(t(q), t(kf), t(vf), t(k), t(v), 1, t(sm), length, slopes=sl)
    return out, ref, None


def _beam(rng, int8):
    B0, nb, S, plen, tail = 2, 2, 16, 12, 3
    k, v = _randn(rng, 2, B0, NKV, S, D), _randn(rng, 2, B0, NKV, S, D)
    m = _valid(S, plen, (0, 5))
    if int8:
        tk, tv = quantize_kv(t(k)), quantize_kv(t(v))
        jk, jv = (JQKV(jnp.asarray(p.q.numpy()), jnp.asarray(p.s.numpy())) for p in (tk, tv))
    else:
        tk, tv, jk, jv = t(k), t(v), jnp.asarray(k), jnp.asarray(v)
    jb = jkvc.beam_cache_from_prefill(jkvc.KVCache(jk, jv, jnp.asarray(plen, jnp.int32), jnp.asarray(m)), nb, 4)
    tb = kvc.beam_cache_from_prefill(kvc.KVCache(tk, tv, torch.tensor(plen, dtype=torch.int32), t(m)), nb, 4)
    for _ in range(tail):
        nk, nv = _randn(rng, 2, B0 * nb, NKV, 1, D), _randn(rng, 2, B0 * nb, NKV, 1, D)
        jnk, jnv = (j_quantize_kv(jnp.asarray(x)) if int8 else jnp.asarray(x) for x in (nk, nv))
        jb = jkvc.beam_commit_token(jb, jnk, jnv)
        tb = kvc.beam_commit_token(tb, t(nk), t(nv))
    q, kf, vf = _randn(rng, B0 * nb, 1, N, D), _randn(rng, B0 * nb, NKV, 1, D), _randn(rng, B0 * nb, NKV, 1, D)
    positions = np.repeat(m.sum(1), nb)[:, None].astype(np.int32) + tail  # real_len + tail_len
    jcfg = j_get_config("opt-tiny").replace(num_heads=N, alibi=True)
    bias = JT._alibi_beam_bias(jcfg, jb, jnp.asarray(positions))
    ref = jatt.attend_decode_beam(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jb, jnp.asarray(1, jnp.int32),
                                  bias=bias)
    out = att.attend_decode_beam(t(q), t(kf), t(vf), tb, 1, att.alibi_slopes(N))
    tcfg = get_config("opt-tiny").replace(num_heads=N, alibi=True)
    golden = att.attend_decode_beam_golden(t(q), t(kf), t(vf), tb, 1, bias=T._alibi_beam_bias(tcfg, tb, t(positions)))
    np.testing.assert_allclose(golden.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    return out, ref, None


def _paged(rng, C):
    L, nblk, bs, P = 2, 12, 4, 5
    kp, vp = _randn(rng, L, nblk, NKV, bs, D), _randn(rng, L, nblk, NKV, bs, D)
    table = np.stack([rng.permutation(np.arange(1, nblk))[:P] for _ in range(B)]).astype(np.int32)
    lengths = np.array([17, 4, 0], np.int32)
    q, kf, vf = _randn(rng, B, C, N, D), _randn(rng, B, NKV, C, D), _randn(rng, B, NKV, C, D)
    ref = jpg.attend_chunk_paged(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(1, jnp.int32), jnp.asarray(table), jnp.asarray(lengths),
                                 alibi_slopes=jatt.alibi_slopes(N))
    from lia_tpu_torch.ops import paged as pg

    out = pg.attend_chunk_paged(t(q), t(kf), t(vf), t(kp), t(vp), 1, t(table), t(lengths), att.alibi_slopes(N))
    if C == 1:
        gold = pg.attend_decode_paged_gather(t(q), t(kf), t(vf), t(kp), t(vp), 1, t(table), t(lengths),
                                             att.alibi_slopes(N))
        np.testing.assert_allclose(gold.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    return out, ref, None


CASES = {
    "B1 flash prefill": _prefill,
    "B6 flash cached": _cached,
    "B7 decode": lambda rng: _plane(rng, False),
    "B8 decode stacked": lambda rng: _plane(rng, True),
    "B2 decode fresh": lambda rng: _fresh(rng, False),
    "B3 decode fresh int8": lambda rng: _fresh(rng, True),
    "B9 beam": lambda rng: _beam(rng, False),
    "B10 beam int8": lambda rng: _beam(rng, True),
    "B5 paged C=1": lambda rng: _paged(rng, 1),
    "B5 paged C=5": lambda rng: _paged(rng, 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_with_slopes_matches_reference(case):
    """The kernel's plain version (through its wrapper on CPU tensors) with
    ALiBi slopes against lia_tpu's biased jnp path on the same inputs; rows
    left-padded so each row's first valid slot differs."""
    out, ref, valid = CASES[case](np.random.default_rng(zlib.crc32(case.encode())))
    out, ref = out.numpy(), np.asarray(ref)
    if valid is not None:
        out, ref = out * valid, ref * valid
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_model_bias_helpers_match_reference():
    """The plain path's bias helpers (transformer._alibi_decode_bias with the
    fresh slot pre-filled, _alibi_beam_bias over [prompt | tail | fresh])
    equal lia_tpu's on the same caches."""
    rng = np.random.default_rng(8)
    sm = _valid(24, 16)
    jc = jkvc.KVCache(None, None, jnp.asarray(16, jnp.int32), jnp.asarray(sm))
    tc = kvc.KVCache(None, None, torch.tensor(16, dtype=torch.int32), t(sm))
    pos = sm.sum(1, keepdims=True).astype(np.int32)
    jcfg, tcfg = j_get_config("bloom-tiny"), get_config("bloom-tiny")
    np.testing.assert_array_equal(T._alibi_decode_bias(tcfg, tc, t(pos)).numpy(),
                                  np.asarray(JT._alibi_decode_bias(jcfg, jc, jnp.asarray(pos))))
    k = _randn(rng, 1, 2, NKV, 16, D)
    m = _valid(16, 12, (0, 5))
    jb = jkvc.beam_cache_from_prefill(jkvc.KVCache(jnp.asarray(k), jnp.asarray(k), jnp.asarray(12, jnp.int32),
                                                   jnp.asarray(m)), 2, 4)
    tb = kvc.beam_cache_from_prefill(kvc.KVCache(t(k), t(k), torch.tensor(12, dtype=torch.int32), t(m)), 2, 4)
    bpos = np.repeat(m.sum(1), 2)[:, None].astype(np.int32)
    jb = jb._replace(tail_k=jnp.zeros((1, 4, NKV, tb.tail_k.shape[3], D)))  # the port's tail width
    np.testing.assert_array_equal(T._alibi_beam_bias(tcfg, tb, t(bpos)).numpy(),
                                  np.asarray(JT._alibi_beam_bias(jcfg, jb, jnp.asarray(bpos))))
    assert T._alibi_decode_bias(get_config("opt-tiny"), tc, t(pos)) is None


def test_slopes_change_the_output():
    """The bias is not a no-op: the same inputs without slopes differ."""
    rng = np.random.default_rng(5)
    q, k, v = _randn(rng, 1, 12, N, D), _randn(rng, 1, NKV, 12, D), _randn(rng, 1, NKV, 12, D)
    m = torch.ones(1, 12, dtype=torch.bool)
    a = ca.flash_attention_prefill_plain(t(q), t(k), t(v), m)
    b = ca.flash_attention_prefill_plain(t(q), t(k), t(v), m, slopes=att.alibi_slopes(N))
    assert (a - b).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# the ALiBi families through the user paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_lia_tpu(name, kv):
    """Greedy tokens, stepwise and fused, equal lia_tpu's."""
    jeng, teng = engines(name, kv)
    jgen, tgen = JGen(max_new_tokens=NEW), GenerationConfig(max_new_tokens=NEW)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen).sequences, jeng.generate(PROMPTS, jgen).sequences)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen, fused=True).sequences,
                                  jeng.generate(PROMPTS, jgen, fused=True).sequences)


@pytest.mark.parametrize("name", NAMES)
def test_beam_and_score_match_lia_tpu(name):
    """Grouped beam search (3 beams) gives lia_tpu's sequences; scoring its
    log-likelihoods within 1e-4 and its greedy flags."""
    jeng, teng = engines(name)
    gen = dict(max_new_tokens=NEW, num_beams=3)
    np.testing.assert_array_equal(teng.generate_beam(PROMPTS, GenerationConfig(**gen)).sequences,
                                  jeng.generate_beam(PROMPTS, JGen(**gen), grouped=True).sequences)
    ctx, cont = [[5, 9, 23, 41], [100, 7, 3, 8, 9]], [[7, 19, 2], [44]]
    ll_j, greedy_j = jeng.score(ctx, cont)
    ll_t, greedy_t = teng.score(ctx, cont)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(greedy_t, greedy_j)


SYS = [((7 * i) % 300) + 2 for i in range(20)]
SERVE_PROMPTS = [SYS + [401, 402, 403], [8, 8, 8, 8, 8, 12, 13], SYS + [404, 405], list(range(3, 43))]
SERVE = {"paged-apc-chunked": dict(paged=True, block_size=8, prefill_chunk=16),
         "paged-spec4": dict(paged=True, block_size=8, speculate_k=4)}


@pytest.mark.parametrize("opts", list(SERVE))
@pytest.mark.parametrize("name", NAMES)
def test_serving_matches_lia_tpu(name, opts):
    """ContinuousBatcher over a paged pool, with prefix caching and chunked
    admission, and with prompt-lookup speculation (k = 4, the paged verify):
    each request's tokens, the prefix hits and the step counts equal
    lia_tpu's."""
    jcfg, jp, tcfg, tp = model(name)
    outs, stats = [], []
    for batcher in (JBatcher(jcfg, jp, gen=JGen(max_new_tokens=NEW), max_batch=2, max_len=128, **SERVE[opts]),
                    ContinuousBatcher(tcfg, tp, gen=GenerationConfig(max_new_tokens=NEW), max_batch=2, max_len=128,
                                      device="cpu", **SERVE[opts])):
        ids = [batcher.submit(p) for p in SERVE_PROMPTS]
        by_id = {r.req_id: [int(x) for x in r.output] for r in batcher.run()}
        outs.append([by_id[i] for i in ids])
        stats.append(batcher.stats())
    assert outs[1] == outs[0]
    for key in ("prefix_hits", "decode_steps"):
        assert stats[1].get(key) == stats[0].get(key), key


@pytest.mark.parametrize("name", NAMES)
def test_prompt_lookup_matches_lia_tpu(name):
    """generate_speculative (prompt lookup, k = 4) gives lia_tpu's sequences
    and verify steps."""
    jeng, teng = engines(name)
    prompts = [[5, 9, 23, 5, 9, 23, 5, 9], [100, 7, 3, 100, 7]]
    seqs, steps = teng.generate_speculative(prompts, GenerationConfig(max_new_tokens=NEW), ngram=2, k=4)
    jseqs, jsteps = jeng.generate_speculative(prompts, JGen(max_new_tokens=NEW), ngram=2, k=4)
    np.testing.assert_array_equal(seqs, jseqs)
    assert steps == jsteps


TIERS = {"h50-p3": dict(hbm_percentage=50, stream_weights=True),
         "h50-p0": dict(hbm_percentage=50, prefill_policy=0, decode_policy=0),
         "h50-p0-p2": dict(hbm_percentage=50, prefill_policy=0, decode_policy=2),
         "h0-p1": dict(hbm_percentage=0, prefill_policy=1, decode_policy=1)}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name", NAMES)
def test_tiered_matches_lia_tpu(name, tier):
    """The tiered scheduler under policy 3 (streamed weights), 0 (KV on the
    host), 0/2 (host attention at decode) and 1 (whole layers on the host)
    gives lia_tpu's resident tokens."""
    ref = engines(name)[0].generate(PROMPTS, JGen(max_new_tokens=NEW)).sequences
    _, _, tcfg, tp = model(name)
    teng = InferenceEngine(tcfg, tp, RuntimeConfig(**TIERS[tier]), device="cpu")
    assert teng.scheduler is not None
    np.testing.assert_array_equal(teng.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences, ref)


def test_moe_still_raises_naming_a12():
    with pytest.raises(NotImplementedError, match="A12"):
        T.check_supported(get_config("mixtral-tiny"))
    for name in NAMES + ["bloom-7b1", "mpt-7b", "mpt-30b", "baichuan-13b", "baichuan2-13b"]:
        T.check_supported(get_config(name))


# ---------------------------------------------------------------------------
# state-dict converters
# ---------------------------------------------------------------------------

CONVERTERS = {"bloom-tiny": "bloom-tiny", "mpt-tiny": "mpt-tiny", "baichuan-13b-tiny": "baichuan2-tiny"}


def _conv_cfg(get, name, dtype="float32"):
    cfg = get(CONVERTERS[name]).replace(dtype=dtype)
    # Baichuan-13B's layout (ALiBi, a plain head) at the test width
    return cfg.replace(name=name, norm_head=False) if name == "baichuan-13b-tiny" else cfg


def _hf_state_dict(name, cfg):
    """A seeded state dict in the family's HF key layout (numpy, fp32)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    H, F, L, V = cfg.hidden_size, cfg.ffn_size, cfg.num_layers, cfg.vocab_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    sd = {}
    if name == "bloom-tiny":
        sd.update({"transformer.word_embeddings.weight": w(V, H),
                   "transformer.word_embeddings_layernorm.weight": 1 + w(H),
                   "transformer.word_embeddings_layernorm.bias": w(H),
                   "transformer.ln_f.weight": 1 + w(H), "transformer.ln_f.bias": w(H)})
        for i in range(L):
            p = f"transformer.h.{i}."
            sd.update({p + "input_layernorm.weight": 1 + w(H), p + "input_layernorm.bias": w(H),
                       p + "self_attention.query_key_value.weight": w(3 * H, H),
                       p + "self_attention.query_key_value.bias": w(3 * H),
                       p + "self_attention.dense.weight": w(H, H), p + "self_attention.dense.bias": w(H),
                       p + "post_attention_layernorm.weight": 1 + w(H), p + "post_attention_layernorm.bias": w(H),
                       p + "mlp.dense_h_to_4h.weight": w(F, H), p + "mlp.dense_h_to_4h.bias": w(F),
                       p + "mlp.dense_4h_to_h.weight": w(H, F), p + "mlp.dense_4h_to_h.bias": w(H)})
    elif name == "mpt-tiny":
        sd.update({"transformer.wte.weight": w(V, H), "transformer.norm_f.weight": 1 + w(H)})
        for i in range(L):
            p = f"transformer.blocks.{i}."
            sd.update({p + "norm_1.weight": 1 + w(H), p + "attn.Wqkv.weight": w(3 * H, H),
                       p + "attn.out_proj.weight": w(H, H), p + "norm_2.weight": 1 + w(H),
                       p + "ffn.up_proj.weight": w(F, H), p + "ffn.down_proj.weight": w(H, F)})
    else:
        sd.update({"model.embed_tokens.weight": w(V, H), "model.norm.weight": 1 + w(H), "lm_head.weight": w(V, H)})
        for i in range(L):
            p = f"model.layers.{i}."
            sd.update({p + "self_attn.W_pack.weight": w(3 * H, H), p + "self_attn.o_proj.weight": w(H, H),
                       p + "mlp.gate_proj.weight": w(F, H), p + "mlp.up_proj.weight": w(F, H),
                       p + "mlp.down_proj.weight": w(H, F), p + "input_layernorm.weight": 1 + w(H),
                       p + "post_attention_layernorm.weight": 1 + w(H)})
    return sd


def _assert_tree_equal(tree, jtree):
    assert set(tree) == set(jtree), (sorted(tree), sorted(jtree))
    for k in tree:
        if isinstance(tree[k], dict):
            _assert_tree_equal(tree[k], jtree[k])
        else:
            ref = ckpt.params_from_jax(jtree[k])
            assert tree[k].dtype == ref.dtype and tree[k].shape == ref.shape, k
            assert torch.equal(tree[k], ref), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONVERTERS))
def test_hf_state_dict_bit_equal_to_lia_tpu(name, dtype):
    """BLOOM's per-head [q | k | v] interleave with its biases and embedding
    LayerNorm, MPT's sequential Wqkv split and synthesized zero LayerNorm
    biases, Baichuan-13B's W_pack: the reference's tree, leaf for leaf, bit
    for bit, from numpy and from torch values."""
    cfg, jcfg = _conv_cfg(get_config, name, dtype), _conv_cfg(j_get_config, name, dtype)
    sd = _hf_state_dict(name, cfg)
    _assert_tree_equal(ckpt.params_from_hf_state_dict(cfg, sd), jckpt.params_from_hf_state_dict(jcfg, sd))
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    _assert_tree_equal(ckpt.params_from_hf_state_dict(cfg, tensors), jckpt.params_from_hf_state_dict(jcfg, sd))


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converted_tree_logits_and_shards_match_lia_tpu(tmp_path, name):
    """The converted tree's prompt logits (fp32) equal lia_tpu's on its own
    converted tree; the state dict written as two shards by the port's
    safetensors writer loads through ``load_hf_checkpoint`` to the same
    tree."""
    cfg, jcfg = _conv_cfg(get_config, name), _conv_cfg(j_get_config, name)
    sd = _hf_state_dict(name, cfg)
    tree, jtree = ckpt.params_from_hf_state_dict(cfg, sd), jckpt.params_from_hf_state_dict(jcfg, sd)
    tokens, mask = np.array([[0, 0, 5, 9, 23, 41], [100, 7, 3, 8, 9, 10]]), np.ones((2, 6), bool)
    mask[0, :2] = False
    jc = jkvc.init_cache(jcfg, 2, 16, jnp.float32)
    jlogits, _ = JT.prefill(jcfg, jtree, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask), jc)
    tc = kvc.init_cache(cfg, 2, 16, torch.float32)
    logits, _ = T.prefill(cfg, tree, t(tokens.astype(np.int32)), t(mask), tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    keys = sorted(sd)
    for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
        safetensors.save_file({k: torch.from_numpy(sd[k]) for k in part}, str(tmp_path / f"model-{i}.safetensors"))
    _assert_tree_equal(ckpt.load_hf_checkpoint(cfg, str(tmp_path)), jtree)
