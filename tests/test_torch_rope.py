"""RoPE (lia_tpu_torch.ops.rope) and the Hugging Face state-dict converters of
the RoPE families against the JAX package and against Hugging Face models
built in-process from config objects (nothing is downloaded), on the CPU.

- apply_rope against lia_tpu's on the same seeded inputs: half rotation,
  the interleaved pairing, a partial rotary_dim and Llama-3's theta;
- params_from_hf_state_dict bit-equal to lia_tpu's for llama, mistral, qwen2,
  gpt-j and gpt-neox, in fp32 and bf16;
- the converted tree's prefill and decode logits against the HF model's
  forward pass, fp32 within 1e-4 (mistral with a window of 8 that binds).
"""

import pytest

pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops.rope import apply_rope as j_apply_rope
from lia_tpu.utils import checkpoint as jckpt

from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.rope import apply_rope
from lia_tpu_torch.utils import checkpoint as ckpt


@pytest.mark.parametrize("D,rotary_dim,interleaved,theta", [
    (16, None, False, 10000.0),   # llama half rotation
    (16, None, True, 10000.0),    # interleaved pairing (chatglm, gpt-j's pairs)
    (32, 8, True, 10000.0),       # gpt-j: partial, interleaved
    (32, 8, False, 10000.0),      # gpt-neox: partial rotary_pct, half rotation
    (128, None, False, 500000.0),  # llama-3's theta at its head width
])
def test_apply_rope_matches_lia_tpu(D, rotary_dim, interleaved, theta):
    rng = np.random.default_rng(D + (rotary_dim or 0) + interleaved)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = np.stack([np.arange(7) + 2000, np.arange(-1, 6)]).astype(np.int32)  # far positions, a pad at -1
    ref = np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, rotary_dim, interleaved))
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, rotary_dim, interleaved)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    if rotary_dim is not None:  # the dims past rotary_dim pass through untouched
        np.testing.assert_array_equal(out.numpy()[..., rotary_dim:], x[..., rotary_dim:])
    x16 = torch.from_numpy(x).to(torch.bfloat16)  # bf16: fp32 math, cast back once
    ref16 = np.asarray(j_apply_rope(jnp.asarray(x16.float().numpy(), jnp.bfloat16), jnp.asarray(pos), theta,
                                    rotary_dim, interleaved), np.float32)
    out16 = apply_rope(x16, torch.from_numpy(pos), theta, rotary_dim, interleaved)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), ref16, rtol=0, atol=2e-2)


def _hf_model(name: str):
    """A randomly initialised HF model of the family at the tiny config's
    widths, its biases seeded too (HF initialises them to zero)."""
    cfg = get_config(name).replace(dtype="float32")
    common = dict(vocab_size=cfg.vocab_size, num_hidden_layers=cfg.num_layers,
                  max_position_embeddings=cfg.max_position_embeddings, tie_word_embeddings=False)
    llama_like = dict(hidden_size=cfg.hidden_size, intermediate_size=cfg.ffn_size, num_attention_heads=cfg.num_heads,
                      num_key_value_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                      attn_implementation="eager", **common)
    if name == "llama-tiny":
        hf_cfg, cls = transformers.LlamaConfig(attention_bias=False, mlp_bias=False, **llama_like), "LlamaForCausalLM"
    elif name == "mistral-tiny":
        cfg = cfg.replace(sliding_window=8)
        hf_cfg, cls = transformers.MistralConfig(sliding_window=8, **llama_like), "MistralForCausalLM"
    elif name == "qwen2-tiny":
        hf_cfg, cls = transformers.Qwen2Config(use_sliding_window=False, **llama_like), "Qwen2ForCausalLM"
    elif name == "gptj-tiny":
        hf_cfg = transformers.GPTJConfig(
            vocab_size=cfg.vocab_size, n_embd=cfg.hidden_size, n_inner=cfg.ffn_size, n_layer=cfg.num_layers,
            n_head=cfg.num_heads, n_positions=cfg.max_position_embeddings, rotary_dim=cfg.rotary_dim,
            activation_function="gelu_new", tie_word_embeddings=False, layer_norm_epsilon=cfg.norm_eps)
        cls = "GPTJForCausalLM"
    else:
        hf_cfg = transformers.GPTNeoXConfig(
            hidden_size=cfg.hidden_size, intermediate_size=cfg.ffn_size, num_attention_heads=cfg.num_heads,
            rotary_pct=cfg.rotary_dim / cfg.head_dim, rotary_emb_base=cfg.rope_theta, hidden_act="gelu",
            use_parallel_residual=True, layer_norm_eps=cfg.norm_eps, attn_implementation="eager", **common)
        cls = "GPTNeoXForCausalLM"
    torch.manual_seed(0)
    hf = getattr(transformers, cls)(hf_cfg).eval()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if n.endswith("bias"):
                p.normal_(0.0, 0.05)
    return cfg, hf


FAMILIES = ["llama-tiny", "mistral-tiny", "qwen2-tiny", "gptj-tiny", "neox-tiny"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_hf_state_dict_bit_equal_to_lia_tpu(name, dtype):
    cfg, hf = _hf_model(name)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    j = jckpt.params_from_hf_state_dict(j_get_config(name).replace(dtype=dtype), sd)
    t = ckpt.params_from_hf_state_dict(cfg.replace(dtype=dtype), sd)

    def check(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                check(a[k], b[k])
        else:
            assert a.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))

    check(t, j)


@pytest.mark.parametrize("name", FAMILIES)
def test_hf_logits_match_converted_tree(name):
    """Prefill over a 12-token prompt and 4 decode steps through the port
    match the HF model's forward pass over the 16 tokens, position by position."""
    cfg, hf = _hf_model(name)
    params = ckpt.params_from_hf_state_dict(cfg, hf.state_dict())
    ids = np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 16)).astype(np.int64)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.float().numpy()
    tok = torch.from_numpy(ids).to(torch.int32)
    cache = kvc.init_cache(cfg, 2, 32, torch.float32)
    logits, cache = T.prefill(cfg, params, tok[:, :12], torch.ones(2, 12, dtype=torch.bool), cache)
    out = [logits.numpy()]
    for i in range(12, 15):
        logits, cache = T.decode_step(cfg, params, tok[:, i:i + 1], torch.full((2, 1), i, dtype=torch.int32), cache)
        out.append(logits.numpy())
    np.testing.assert_allclose(np.stack(out, 1), ref[:, 11:15], rtol=1e-4, atol=1e-4)
