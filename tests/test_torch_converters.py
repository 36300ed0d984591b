"""The llama layout's GPTQ ingestion and the GPTBigCode Hugging Face
converter against the JAX package on the CPU.

State dicts are synthesized with numpy from a seed in the Hugging Face and
AutoGPTQ layouts and handed to both packages: the trees must be bit-equal
(trivial ``g_idx`` as lossless ``woq_int4z`` records, act-order through the
lossy symmetric int4 path), a llama GPTQ tree gives lia_tpu's fp32 greedy
tokens with projections fused (wqkv, wg1) and unfused, and the GPTBigCode
tree is lia_tpu's through ``params_from_hf_state_dict`` and through
``load_hf_checkpoint`` over two shards.
"""

import os

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils import checkpoint as jckpt
from lia_tpu.utils import gptq as jgptq

from lia_tpu_torch.config import GenerationConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import cuda_matmul as cm
from lia_tpu_torch.utils import checkpoint as ckpt
from lia_tpu_torch.utils import gptq, safetensors

PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [3, 4], [100, 200, 300, 400, 17, 18]]
LLAMA_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                 "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


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


def llama_gptq_state_dict(cfg, rng, g, act_order=False):
    """A llama-layout HF dict (``model.layers.*``) with every projection in
    AutoGPTQ form; trivial g_idx unless ``act_order``."""
    H, F, V = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    QD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    sd = {"model.embed_tokens.weight": r(V, H), "model.norm.weight": 1 + r(H), "lm_head.weight": r(V, H)}
    for i in range(cfg.num_layers):
        lp = f"model.layers.{i}."
        sd[lp + "input_layernorm.weight"], sd[lp + "post_attention_layernorm.weight"] = 1 + r(H), 1 + r(H)
        for name, (K, N) in zip(LLAMA_LINEARS, [(H, QD), (H, KD), (H, KD), (QD, H), (H, F), (H, F), (F, H)]):
            p = lp + name
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


@pytest.mark.parametrize("g,act_order,keep_fp", [(16, False, False), (64, False, False), (16, True, False),
                                                 (16, False, True)])
def test_llama_gptq_bit_equal_to_lia_tpu(g, act_order, keep_fp):
    """Trivial g_idx: every projection (q/k/v, o, gate, up, down) a lossless
    woq_int4z record (g = 64 is one group over K = 64, a half of K = 128);
    act-order: symmetric int4; keep_fp: the fp tree."""
    rng = np.random.default_rng(3)
    jcfg = j_get_config("llama-tiny").replace(dtype="float32")
    sd = llama_gptq_state_dict(jcfg, rng, g, act_order)
    j = jgptq.params_from_gptq_state_dict(jcfg, sd, group_size=16, keep_fp=keep_fp)
    t = gptq.params_from_gptq_state_dict(get_config("llama-tiny").replace(dtype="float32"), sd,
                                         group_size=16, keep_fp=keep_fp)
    assert_tree_equal(t, j)
    fmts = {getattr(w, "fmt", None) for grp in ("attn", "mlp") for w in t["layers"][grp].values()}
    assert fmts == {None if keep_fp else "woq_int4" if act_order else "woq_int4z"}


@pytest.mark.parametrize("act_order", [False, True])
def test_llama_gptq_tokens_fused_and_unfused(act_order):
    """A llama GPTQ tree gives lia_tpu's fp32 greedy tokens over 8 new tokens,
    with projections fused (wqkv and wg1 concatenate the records, zero-points
    included) and unfused, on the woq4z kernel's plain version (native) or
    the int4 one (act-order)."""
    rng = np.random.default_rng(7)
    jcfg = j_get_config("llama-tiny").replace(dtype="float32")
    tcfg = get_config("llama-tiny").replace(dtype="float32")
    sd = llama_gptq_state_dict(jcfg, rng, 16, act_order)
    jt = jgptq.params_from_gptq_state_dict(jcfg, sd, group_size=16)
    tt = gptq.params_from_gptq_state_dict(tcfg, sd, group_size=16)
    ref = np.asarray(JEngine(jcfg, jt, JRuntime()).generate(PROMPTS, JGen(max_new_tokens=8), fused=True).sequences)
    for fuse in (True, False):
        eng = InferenceEngine(tcfg, tt, RuntimeConfig(fuse_projections=fuse), device="cpu")
        mlp = eng.params["layers"]["mlp"]
        assert ("wg1" in mlp) == fuse and mlp["wg1" if fuse else "wg"].fmt == ("woq_int4" if act_order else "woq_int4z")
        out = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=8), fused=True).sequences
        np.testing.assert_array_equal(out, ref)
    assert cm.launch_counts()["woq4z_matmul"] == 0  # the CPU runs the plain version


def gptbigcode_state_dict(cfg, seed):
    """A seeded HF state dict in GPTBigCode's key layout (multi-query c_attn
    [H + 2D, H], learned positions), numpy fp32."""
    rng = np.random.default_rng(seed)
    H, F, V, D = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size, cfg.head_dim
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    sd = {"transformer.wte.weight": r(V, H), "transformer.wpe.weight": r(cfg.max_position_embeddings, H),
          "transformer.ln_f.weight": 1 + r(H), "transformer.ln_f.bias": r(H)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}{ln}.weight"], sd[f"{p}{ln}.bias"] = 1 + r(H), r(H)
        sd.update({p + "attn.c_attn.weight": r(H + 2 * D, H), p + "attn.c_attn.bias": r(H + 2 * D),
                   p + "attn.c_proj.weight": r(H, H), p + "attn.c_proj.bias": r(H),
                   p + "mlp.c_fc.weight": r(F, H), p + "mlp.c_fc.bias": r(F),
                   p + "mlp.c_proj.weight": r(H, F), p + "mlp.c_proj.bias": r(H)})
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gptbigcode_converter_bit_equal_to_lia_tpu(tmp_path, dtype):
    """The port's _params_gptbigcode gives lia_tpu's tree bit for bit, through
    params_from_hf_state_dict and through both packages' load_hf_checkpoint
    over two safetensors shards of the same dict; K and V are one head each."""
    jcfg = j_get_config("gptbigcode-tiny").replace(dtype=dtype)
    tcfg = get_config("gptbigcode-tiny").replace(dtype=dtype)
    sd = gptbigcode_state_dict(tcfg, seed=4)
    ref = jckpt.params_from_hf_state_dict(jcfg, sd)
    out = ckpt.params_from_hf_state_dict(tcfg, sd)
    assert_tree_equal(out, ref)
    assert out["layers"]["attn"]["wk"].shape == (tcfg.num_layers, tcfg.hidden_size, tcfg.head_dim)
    keys = sorted(sd)
    for i, part in enumerate(([k for k in keys if ".h.1." not in k], [k for k in keys if ".h.1." in k])):
        safetensors.save_file({k: torch.from_numpy(sd[k]) for k in part},
                              os.path.join(tmp_path, f"model-0000{i + 1}.safetensors"))
    assert_tree_equal(ckpt.load_hf_checkpoint(tcfg, str(tmp_path)), jckpt.load_hf_checkpoint(jcfg, str(tmp_path)))


def test_gptbigcode_tokens_from_hf_tree():
    """The converted GPTBigCode tree gives lia_tpu's fp32 greedy tokens."""
    jcfg = j_get_config("gptbigcode-tiny").replace(dtype="float32")
    tcfg = get_config("gptbigcode-tiny").replace(dtype="float32")
    sd = gptbigcode_state_dict(tcfg, seed=5)
    ref = JEngine(jcfg, jckpt.params_from_hf_state_dict(jcfg, sd)).generate(PROMPTS, JGen(max_new_tokens=8),
                                                                            fused=True).sequences
    out = InferenceEngine(tcfg, ckpt.params_from_hf_state_dict(tcfg, sd), device="cpu").generate(
        PROMPTS, GenerationConfig(max_new_tokens=8), fused=True).sequences
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_load_engine_from_checkpoint_directories(tmp_path):
    """load_engine's two file sources give lia_tpu.load_engine's fp32 tokens:
    a directory of AutoGPTQ shards (llama layout, lossless records) and a
    directory of Hugging Face shards quantized to weight-only int8 at load."""
    import lia_tpu

    from lia_tpu_torch.api import load_engine

    jcfg = j_get_config("llama-tiny").replace(dtype="float32")
    gptq_sd = llama_gptq_state_dict(jcfg, np.random.default_rng(11), 16)
    hf_sd = {k: v for k, v in gptq_sd.items() if not k.endswith((".qweight", ".qzeros", ".scales", ".g_idx"))}
    for p in {k[: -len(".qweight")] for k in gptq_sd if k.endswith(".qweight")}:
        hf_sd[p + ".weight"] = jgptq.unpack_gptq(gptq_sd[p + ".qweight"], gptq_sd[p + ".qzeros"],
                                                 gptq_sd[p + ".scales"]).T.copy()
    for name, sd, kw in (("gptq", gptq_sd, {"gptq_checkpoint": None}),
                         ("hf", hf_sd, {"checkpoint": None, "weight_dtype": "int8"})):
        d = tmp_path / name
        d.mkdir()
        safetensors.save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                              str(d / "model.safetensors"))
        kw = {k: (str(d) if v is None else v) for k, v in kw.items()}
        ref = lia_tpu.load_engine("llama-tiny", dtype="float32", **kw).generate(PROMPTS, JGen(max_new_tokens=6))
        out = load_engine("llama-tiny", dtype="float32", device="cpu", **kw).generate(
            PROMPTS, GenerationConfig(max_new_tokens=6))
        np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences), err_msg=name)
