"""The port's Hugging Face OPT mapping and GPTQ ingestion against the JAX
package on the CPU: unpacking, the trees (bit-equal), and fp32 greedy
generation of a GPTQ tree as ``woq_int4z`` and, retagged, ``woq_int4z_dyn``.

The state dicts are synthesized with numpy in the HF and AutoGPTQ layouts.
"""

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu import config as jconfig
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import quant as jq
from lia_tpu.utils import checkpoint as jckpt
from lia_tpu.utils import gptq as jgptq

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import cuda_matmul as cm
from lia_tpu_torch.ops.quant import retag_dynamic_act
from lia_tpu_torch.utils import checkpoint as ckpt
from lia_tpu_torch.utils import gptq

PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [3, 4], [100, 200, 300, 400, 17, 18]]
LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj", "fc1", "fc2")


def pack_gptq(codes: np.ndarray, zeros: np.ndarray):
    """(qweight, qzeros) int32 from nibble codes [K, N] and zero-points [K/g, N]
    (stored as zero - 1), in AutoGPTQ's packing."""
    K, N = codes.shape
    qweight = np.zeros((K // 8, N), np.uint32)
    for i in range(8):
        qweight |= codes[i::8].astype(np.uint32) << (4 * i)
    zm1 = (zeros - 1).astype(np.uint32)
    qzeros = np.zeros((zeros.shape[0], N // 8), np.uint32)
    for i in range(8):
        qzeros |= zm1[:, i::8] << (4 * i)
    return qweight.astype(np.int32), qzeros.astype(np.int32)


def hf_opt_state_dict(cfg, rng, scale=0.05):
    """A random HF OPT state dict (numpy, [out, in] linears)."""
    H, F, V, L = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size, cfg.num_layers
    r = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    pre = "model.decoder."
    sd = {pre + "embed_tokens.weight": r(V, H), pre + "embed_positions.weight": r(cfg.max_position_embeddings + 2, H),
          pre + "final_layer_norm.weight": 1 + r(H), pre + "final_layer_norm.bias": r(H)}
    for i in range(L):
        lp = f"{pre}layers.{i}."
        for name, (o, n) in zip(LINEARS, [(H, H)] * 4 + [(F, H), (H, F)]):
            sd[lp + name + ".weight"], sd[lp + name + ".bias"] = r(o, n), r(o)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[lp + ln + ".weight"], sd[lp + ln + ".bias"] = 1 + r(H), r(H)
    return sd


def gptq_state_dict(cfg, rng, g, act_order=False):
    """The HF dict with every decoder linear in AutoGPTQ form (random codes,
    scales and zero-points; trivial g_idx unless ``act_order``)."""
    sd = hf_opt_state_dict(cfg, rng)
    for i in range(cfg.num_layers):
        for name in LINEARS:
            p = f"model.decoder.layers.{i}.{name}"
            N, K = sd.pop(p + ".weight").shape
            codes = rng.integers(0, 16, (K, N)).astype(np.uint32)
            zeros = rng.integers(1, 16, (K // g, N)).astype(np.uint32)
            sd[p + ".qweight"], sd[p + ".qzeros"] = pack_gptq(codes, zeros)
            sd[p + ".scales"] = rng.uniform(0.002, 0.01, (K // g, N)).astype(np.float16)
            sd[p + ".g_idx"] = (rng.permutation(K) // g if act_order else np.arange(K) // g).astype(np.int32)
    return sd


def assert_tree_equal(t, j):
    if isinstance(j, dict):
        assert t.keys() == j.keys()
        for k in j:
            assert_tree_equal(t[k], j[k])
    elif hasattr(j, "fmt"):
        assert t.fmt == j.fmt and (t.z is None) == (j.z is None)
        for a, b in ((t.q, j.q), (t.s, j.s), (t.z, j.z)):
            if b is not None:
                assert str(a.dtype).endswith(np.asarray(b).dtype.name)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(a, np.asarray(j, a.dtype))


@pytest.mark.parametrize("act_order", [False, True])
def test_unpack_matches_lia_tpu(rng, act_order):
    K, N, g = 64, 32, 16
    codes = rng.integers(0, 16, (K, N)).astype(np.uint32)
    zeros = rng.integers(1, 16, (K // g, N)).astype(np.uint32)
    scales = rng.uniform(0.01, 0.1, (K // g, N)).astype(np.float32)
    qw, qz = pack_gptq(codes, zeros)
    g_idx = rng.integers(0, K // g, K).astype(np.int32) if act_order else None
    np.testing.assert_array_equal(gptq.unpack_gptq(qw, qz, scales, g_idx), jgptq.unpack_gptq(qw, qz, scales, g_idx))
    for a, b in zip(gptq.unpack_gptq_codes(qw, qz, scales), jgptq.unpack_gptq_codes(qw, qz, scales)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gptq._pack_half_split(codes.astype(np.uint8)),
                                  jgptq._pack_half_split(codes.astype(np.uint8)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_opt_state_dict_bit_equal_to_lia_tpu(rng, dtype):
    jcfg = j_get_config("opt-tiny").replace(dtype=dtype)
    sd = hf_opt_state_dict(jcfg, rng)
    j = jckpt.params_from_hf_state_dict(jcfg, sd)
    assert_tree_equal(ckpt.params_from_hf_state_dict(get_config("opt-tiny").replace(dtype=dtype), sd), j)
    with pytest.raises(NotImplementedError, match="bloom"):
        ckpt.params_from_hf_state_dict(get_config("bloom-tiny"), sd)


@pytest.mark.parametrize("g,act_order,keep_fp", [(16, False, False), (32, False, False), (64, False, False),
                                                 (16, True, False), (16, False, True)])
def test_params_from_gptq_bit_equal_to_lia_tpu(rng, g, act_order, keep_fp):
    """Trivial g_idx: lossless woq_int4z records (g = 64 = K is one group);
    act-order: symmetric int4 re-quantization; keep_fp: the fp tree."""
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    sd = gptq_state_dict(jcfg, rng, g, act_order)
    j = jgptq.params_from_gptq_state_dict(jcfg, sd, group_size=16, keep_fp=keep_fp)
    t = gptq.params_from_gptq_state_dict(get_config("opt-tiny").replace(dtype="float32"), sd,
                                         group_size=16, keep_fp=keep_fp)
    assert_tree_equal(t, j)
    fmt = getattr(t["layers"]["mlp"]["w1"], "fmt", None)
    assert fmt == (None if keep_fp else "woq_int4" if act_order else "woq_int4z")


@pytest.fixture(scope="module")
def gptq_models():
    rng = np.random.default_rng(5)
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    sd = gptq_state_dict(jcfg, rng, 16)
    jt = jgptq.params_from_gptq_state_dict(jcfg, sd)
    return jcfg, jt, get_config("opt-tiny").replace(dtype="float32"), ckpt.params_from_jax(jt)


@pytest.mark.parametrize("retag", [False, True])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_gptq_generate_tokens_exact_vs_lia_tpu(gptq_models, retag, kv):
    """A GPTQ tree generates the JAX engine's fp32 greedy tokens over 8 new
    tokens, as woq_int4z (the woq4z kernel's plain version) and retagged as
    woq_int4z_dyn (the W4A8 kernel's, with zero-points)."""
    jcfg, jt, tcfg, tt = gptq_models
    if retag:
        jt, tt = jq.retag_dynamic_act(jt), retag_dynamic_act(tt)
    assert tt["layers"]["attn"]["wq"].fmt == ("woq_int4z_dyn" if retag else "woq_int4z")
    jeng = JEngine(jcfg, jt, jconfig.RuntimeConfig(quant=jconfig.QuantConfig(kv_cache_dtype=kv)))
    teng = InferenceEngine(tcfg, tt, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu")
    ref = jeng.generate(PROMPTS, jconfig.GenerationConfig(max_new_tokens=8), fused=True).sequences
    out = teng.generate(PROMPTS, GenerationConfig(max_new_tokens=8), fused=True).sequences
    np.testing.assert_array_equal(out, ref)
    assert cm.launch_counts() == {"w4a8_matmul": 0, "w4a8_matmul_stacked": 0, "woq_matmul": 0, "woq4z_matmul": 0}


def test_gptq_rejects_other_families(rng):
    with pytest.raises(NotImplementedError):
        gptq.params_from_gptq_state_dict(get_config("llama-tiny"), {})
