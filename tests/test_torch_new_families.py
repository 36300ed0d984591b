"""The Falcon, ChatGLM, Baichuan and StableLM families through the port's user
paths against the JAX package, in fp32 on the CPU, and their Hugging Face
state-dict converters against the reference's.

- falcon-tiny (multi-query: one KV head, parallel residual with a shared
  norm), chatglm-tiny (half-head interleaved rotary, qkv biases),
  baichuan-tiny, stablelm-tiny (the llama layout with LayerNorm, partial
  rotary) and Baichuan2 with RoPE and ``norm_head`` at the test width:
  greedy generate (stepwise and fused, model-dtype and int8 KV), grouped beam
  search, the tiered scheduler (policies 3 and 0), continuous batching (slab,
  and paged with prefix caching and chunked admission) and scoring. Tokens
  are exact; scores within 1e-4.
- ``params_from_hf_state_dict`` bit-equal to lia_tpu's, fp32 and bf16, on
  seeded state dicts in the HF key layout: Falcon's and StableLM's from
  in-process ``transformers`` models, ChatGLM's and Baichuan's written by hand
  (neither has a ``transformers`` class).

The reference's dummy trees are drawn at scale 0.2 with seeded biases, as in
tests/test_torch_families.py, and built once per module.
"""

import functools
import zlib

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils import checkpoint as jckpt
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.utils import checkpoint as ckpt

NAMES = ["falcon-tiny", "chatglm-tiny", "baichuan-tiny", "stablelm-tiny", "baichuan2-rope"]
PROMPTS = [[5, 9, 23, 41, 7, 7, 19], [100, 7, 3], list(range(30, 52))]
NEW = 8


def _cfg(get, name):
    if name == "baichuan2-rope":  # Baichuan2-7B's layout (RoPE, norm_head) at the test width
        return get("baichuan2-tiny").replace(name="baichuan2-rope", alibi=False, rope=True, dtype="float32")
    return get(name).replace(dtype="float32")


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
    jp = _with_biases(j_init(jcfg, seed=31, scale=0.2), np.random.default_rng(7))
    return jcfg, jp, _cfg(get_config, name), ckpt.params_from_jax(jp)


@functools.lru_cache(maxsize=None)
def engines(name, kv="none"):
    """(lia_tpu engine, port engine) of a family, made once per KV type."""
    jcfg, jp, tcfg, tp = model(name)
    return (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv))),
            InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu"))


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
def test_generate_beam_matches_lia_tpu(name):
    """Grouped beam search, 3 beams, equals lia_tpu's."""
    jeng, teng = engines(name)
    gen = dict(max_new_tokens=NEW, num_beams=3)
    np.testing.assert_array_equal(teng.generate_beam(PROMPTS, GenerationConfig(**gen)).sequences,
                                  jeng.generate_beam(PROMPTS, JGen(**gen), grouped=True).sequences)


@pytest.mark.parametrize("name", NAMES)
def test_tiered_matches_lia_tpu(name):
    """The tiered scheduler at hbm 50, under policy 3 (streamed weights) and
    policy 0 (KV on the host), gives lia_tpu's resident tokens."""
    gen = dict(max_new_tokens=NEW)
    ref = engines(name)[0].generate(PROMPTS, JGen(**gen)).sequences
    _, _, tcfg, tp = model(name)
    for kw in (dict(hbm_percentage=50, stream_weights=True), dict(hbm_percentage=50, prefill_policy=0,
                                                                  decode_policy=0)):
        teng = InferenceEngine(tcfg, tp, RuntimeConfig(**kw), device="cpu")
        assert teng.scheduler is not None
        np.testing.assert_array_equal(teng.generate(PROMPTS, GenerationConfig(**gen)).sequences, ref)


SYS = [((7 * i) % 300) + 2 for i in range(20)]
SERVE_PROMPTS = [SYS + [401, 402, 403], [8, 8, 8, 8, 8, 12, 13], SYS + [404, 405], list(range(3, 43))]


@pytest.mark.parametrize("opts", [dict(), dict(paged=True, block_size=8, prefill_chunk=16)],
                         ids=["slab", "paged-apc-chunked"])
@pytest.mark.parametrize("name", NAMES)
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


@pytest.mark.parametrize("name", NAMES)
def test_score_matches_lia_tpu(name):
    jeng, teng = engines(name)
    ctx, cont = [[5, 9, 23, 41], [100, 7, 3, 8, 9]], [[7, 19, 2], [44]]
    ll_j, greedy_j = jeng.score(ctx, cont)
    ll_t, greedy_t = teng.score(ctx, cont)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(greedy_t, greedy_j)


# ---------------------------------------------------------------------------
# state-dict converters
# ---------------------------------------------------------------------------


def _hf_state_dict(name, cfg):
    """A seeded state dict in the family's HF key layout (numpy, fp32)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    H, F, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    QD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    if name in ("falcon-tiny", "stablelm-tiny"):
        import transformers

        if name == "falcon-tiny":
            hf_cfg = transformers.FalconConfig(
                vocab_size=cfg.vocab_size, hidden_size=H, ffn_hidden_size=F, num_hidden_layers=L,
                num_attention_heads=cfg.num_heads, multi_query=True, parallel_attn=True,
                new_decoder_architecture=False, bias=False, alibi=False, tie_word_embeddings=True)
            hf = transformers.FalconForCausalLM(hf_cfg)
        else:  # stablelm-2's qkv biases
            hf_cfg = transformers.StableLmConfig(
                vocab_size=cfg.vocab_size, hidden_size=H, intermediate_size=F, num_hidden_layers=L,
                num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
                partial_rotary_factor=cfg.rotary_dim / cfg.head_dim, use_qkv_bias=True, tie_word_embeddings=False)
            hf = transformers.StableLmForCausalLM(hf_cfg)
        gen = torch.Generator().manual_seed(3)
        sd = {}
        for k, v in hf.state_dict().items():  # HF zeroes biases and unit-fills norms: draw everything
            sd[k] = (torch.randn(v.shape, generator=gen) * 0.05).numpy()
        return sd
    if name == "chatglm-tiny":
        sd = {"transformer.embedding.word_embeddings.weight": w(cfg.vocab_size, H),
              "transformer.encoder.final_layernorm.weight": 1 + w(H),
              "transformer.output_layer.weight": w(cfg.vocab_size, H)}
        for i in range(L):
            p = f"transformer.encoder.layers.{i}."
            sd.update({p + "self_attention.query_key_value.weight": w(QD + 2 * KD, H),
                       p + "self_attention.query_key_value.bias": w(QD + 2 * KD),
                       p + "self_attention.dense.weight": w(H, QD), p + "mlp.dense_h_to_4h.weight": w(2 * F, H),
                       p + "mlp.dense_4h_to_h.weight": w(H, F), p + "input_layernorm.weight": 1 + w(H),
                       p + "post_attention_layernorm.weight": 1 + w(H)})
        return sd
    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H), "model.norm.weight": 1 + w(H),
          "lm_head.weight": w(cfg.vocab_size, H)}  # baichuan, baichuan2 (norm_head)
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.W_pack.weight": w(3 * H, H), p + "self_attn.o_proj.weight": w(H, H),
                   p + "mlp.gate_proj.weight": w(F, H), p + "mlp.up_proj.weight": w(F, H),
                   p + "mlp.down_proj.weight": w(H, F), p + "input_layernorm.weight": 1 + w(H),
                   p + "post_attention_layernorm.weight": 1 + w(H)})
    return sd


def _assert_tree_equal(t, j):
    assert set(t) == set(j), (sorted(t), sorted(j))
    for k in t:
        if isinstance(t[k], dict):
            _assert_tree_equal(t[k], j[k])
        else:
            ref = ckpt.params_from_jax(j[k])
            assert t[k].dtype == ref.dtype and t[k].shape == ref.shape, k
            assert torch.equal(t[k], ref), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_hf_state_dict_bit_equal_to_lia_tpu(name, dtype):
    """The converter gives the reference's tree, leaf for leaf, bit for bit:
    Falcon's q | k | v split of its multi-query fused projection, ChatGLM's
    packed qkv (with bias) and gate | up, Baichuan's W_pack and Baichuan2's
    L2-normalised head rows, StableLM's norm and qkv biases."""
    cfg = _cfg(get_config, name).replace(dtype=dtype)
    if name == "stablelm-tiny":
        cfg = cfg.replace(attn_bias=True, o_bias=False)
    jcfg = _cfg(j_get_config, name).replace(dtype=dtype, attn_bias=cfg.attn_bias, o_bias=cfg.o_bias)
    sd = _hf_state_dict(name, cfg)
    _assert_tree_equal(ckpt.params_from_hf_state_dict(cfg, sd), jckpt.params_from_hf_state_dict(jcfg, sd))
    if name == "baichuan2-rope":  # the head's rows come out of unit norm
        head = ckpt.params_from_hf_state_dict(cfg.replace(dtype="float32"), sd)["lm_head"]
        np.testing.assert_allclose(head.norm(dim=0).numpy(), 1.0, rtol=1e-5)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}  # torch values map the same way
    _assert_tree_equal(ckpt.params_from_hf_state_dict(cfg, tensors), jckpt.params_from_hf_state_dict(jcfg, sd))


def test_falcon_mapping_takes_one_kv_head():
    cfg = get_config("falcon-tiny").replace(dtype="float32")
    with pytest.raises(ValueError, match="one kv head"):
        ckpt.params_from_hf_state_dict(cfg.replace(num_kv_heads=2), _hf_state_dict("falcon-tiny", cfg))
