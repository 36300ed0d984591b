"""Head dims 80, 96 and 256 (OPT-2.7B, StableLM-3B and CodeGen-2B; GPT-NeoX-20B;
GPT-J-6B and CodeGen-6B) and the CodeGen family, against the JAX package on
the CPU.

Every attention kernel's plain version against the Pallas kernel it replaces
(interpret mode, as tests/test_torch_attention.py runs them) at each new D, at
G = 1 and a G > 1, in fp32 with that file's tolerance; the CodeGen converter
(mp_num = 4 ``qkv_proj``) bit for bit against lia_tpu's, and through
load_hf_checkpoint; then fp32 greedy tokens equal to lia_tpu's, stepwise and
fused with bf16 and int8 KV, for small configs at each D, and paged serving,
grouped beam search and the tiered scheduler (policy 3) at D = 80. Inputs are
drawn with numpy from a seed and handed to both packages; the reference's
trees come across with params_from_jax, built once per module.
"""

import functools
import os

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
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import paged as jpg
from lia_tpu.ops import pallas_attention as pa
from lia_tpu.ops.quant import dequantize_kv as j_dequantize_kv
from lia_tpu.ops.quant import quantize_kv as j_quantize_kv
from lia_tpu.utils.checkpoint import init_dummy_params as j_init
from lia_tpu.utils.checkpoint import params_from_hf_state_dict as j_from_hf

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.quant import quantize_kv
from lia_tpu_torch.utils import safetensors
from lia_tpu_torch.utils.checkpoint import load_hf_checkpoint, params_from_hf_state_dict, params_from_jax

TOL = 2e-5  # fp32: the same math summed in another order
INT8_TOL = 2e-4  # the int8 kernels: the scales multiply in other places
# (D, G): each new head dim at G = 1 and D = 96 and 256 at a group past 1
HEADS = [(80, 1), (96, 2), (256, 1), (256, 4)]


def t(x):
    return torch.from_numpy(np.array(x))


def inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def slot_mask(B, S, ends, starts):
    sm = np.zeros((B, S), bool)
    for b, (st, e) in enumerate(zip(starts, ends)):
        sm[b, st:e] = True
    return sm


def heads(D, G):
    """(N, N_kv): 2 kv heads at G = 1 and 2, one under G = 4."""
    Nkv = 1 if G == 4 else 2
    return Nkv * G, Nkv


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,G", HEADS)
def test_flash_prefill(D, G):
    B, S = 2, 32
    N, Nkv = heads(D, G)
    q, k, v = inputs(D + G, (B, S, N, D), (B, Nkv, S, D), (B, Nkv, S, D))
    mask = slot_mask(B, S, (S, S), (0, 7))
    ref = pa.flash_attention_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                     block_q=16, block_k=16, interpret=True)
    out = ca.flash_attention_prefill(t(q), t(k), t(v), t(mask))
    valid = mask[:, :, None, None]
    np.testing.assert_allclose(out.numpy() * valid, np.asarray(ref) * valid, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D,G", HEADS)
def test_flash_cached(D, G):
    """A chunk of 8 rows at per-row bases 12 and 20 over a left-padded plane,
    with a window of 9."""
    B, C, S = 2, 8, 32
    N, Nkv = heads(D, G)
    q, k, v = inputs(D + G, (B, C, N, D), (B, Nkv, S, D), (B, Nkv, S, D))
    bases = (12, 20)
    sm = slot_mask(B, S, (12 + C, 20 + C), (0, 5))
    ref = pa.flash_attention_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bases, jnp.int32),
                                    jnp.asarray(sm), block_k=16, window=9, interpret=True)
    out = ca.flash_attention_cached(t(q), t(k), t(v), torch.tensor(bases, dtype=torch.int32), t(sm), window=9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D,G", HEADS)
def test_decode_fresh(D, G):
    B, S, past = 2, 32, 21
    N, Nkv = heads(D, G)
    q, kf, vf, k, v = inputs(D + G, (B, 1, N, D), (B, Nkv, 1, D), (B, Nkv, 1, D), (2, B, Nkv, S, D),
                             (2, B, Nkv, S, D))
    sm = slot_mask(B, S, (past, past), (3, 0))
    ref = pa.decode_attention_fresh(*(jnp.asarray(x) for x in (q, kf, vf, k, v)), jnp.asarray(1, jnp.int32),
                                    jnp.asarray(sm), jnp.asarray(past, jnp.int32), block_k=8, interpret=True)
    out = ca.decode_attention_fresh(t(q), t(kf), t(vf), t(k), t(v), 1, t(sm), torch.tensor(past, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D,G", HEADS)
def test_decode_fresh_int8(D, G):
    """The Pallas kernel takes the fresh token after its int8 round trip; the
    port's makes the round trip itself."""
    B, S, past = 2, 32, 21
    N, Nkv = heads(D, G)
    q, kf, vf, k, v = inputs(D + G, (B, 1, N, D), (B, Nkv, 1, D), (B, Nkv, 1, D), (2, B, Nkv, S, D),
                             (2, B, Nkv, S, D))
    sm = slot_mask(B, S, (past, past), (0, 6))
    jk, jv = j_quantize_kv(jnp.asarray(k)), j_quantize_kv(jnp.asarray(v))
    jkf, jvf = (j_dequantize_kv(j_quantize_kv(jnp.asarray(x)), jnp.float32) for x in (kf, vf))
    ref = pa.decode_attention_fresh_int8(jnp.asarray(q), jkf, jvf, jk.q, jk.s, jv.q, jv.s, jnp.asarray(1, jnp.int32),
                                         jnp.asarray(sm), jnp.asarray(past, jnp.int32), block_k=8, interpret=True)
    out = ca.decode_attention_fresh_int8(t(q), t(kf), t(vf), *(t(a) for a in (jk.q, jk.s, jv.q, jv.s)), 1, t(sm),
                                         torch.tensor(past, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=INT8_TOL, atol=INT8_TOL)


@pytest.mark.parametrize("D,G", HEADS)
def test_decode_plane_and_stacked(D, G):
    """B7 over a plane that holds the token, and B8 at layer 1 of the stacked
    cache: both of lia_tpu's stacked entries (prefetch and DMA), bit for bit
    the plane's output."""
    B, S, length = 2, 32, 22
    N, Nkv = heads(D, G)
    q, k, v = inputs(D + G, (B, 1, N, D), (3, B, Nkv, S, D), (3, B, Nkv, S, D))
    sm = slot_mask(B, S, (length, length), (2, 0))
    jl = jnp.asarray(length, jnp.int32)
    ref = pa.decode_attention(jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]), jnp.asarray(sm), jl, block_k=8,
                              interpret=True)
    plane = ca.decode_attention(t(q), t(k[1]), t(v[1]), t(sm), torch.tensor(length, dtype=torch.int32))
    np.testing.assert_allclose(plane.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    stacked = ca.decode_attention_stacked(t(q), t(k), t(v), 1, t(sm), torch.tensor(length, dtype=torch.int32))
    torch.testing.assert_close(stacked, plane, rtol=0, atol=0)
    for fn in (pa.decode_attention_stacked, pa.decode_attention_stacked_dma):
        ref = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(1, jnp.int32), jnp.asarray(sm), jl,
                 block_k=8, interpret=True)
        np.testing.assert_allclose(stacked.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D,G", HEADS)
def test_paged_decode(D, G):
    """C = 2 queries a row through a shuffled block table, the fresh chunk's
    causal triangle merged last, one row empty."""
    L, nb, bs, B, C, P = 2, 16, 8, 3, 2, 4
    N, Nkv = heads(D, G)
    kp, vp, q, kf, vf = inputs(D + G, (L, nb, Nkv, bs, D), (L, nb, Nkv, bs, D), (B, C, N, D), (B, Nkv, C, D),
                               (B, Nkv, C, D))
    table = (np.random.default_rng(D).permutation(nb - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    lengths = (29, 0, 13)
    ref = jpg.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(1, jnp.int32),
                                     jnp.asarray(table), jnp.asarray(lengths, jnp.int32), interpret=True,
                                     k_fresh=jnp.asarray(kf), v_fresh=jnp.asarray(vf))
    out = ca.paged_decode_attention(t(q), t(kp), t(vp), 1, t(table), torch.tensor(lengths, dtype=torch.int32),
                                    t(kf), t(vf))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _beam_args(D, G, int8):
    """Both packages' arguments of B9 (or B10): 3 groups of 2 beams over a
    16-slot prompt (one group's prompt a single token), a tail of 3."""
    L, B0, nb, S_p, T_max, plen, tlen = 2, 3, 2, 16, 8, 12, 3
    N, Nkv = heads(D, G)
    B = B0 * nb
    q, kf, vf, kp, vp, kt, vt = inputs(D + G + int8, (B, 1, N, D), (B, Nkv, 1, D), (B, Nkv, 1, D),
                                       (L, B0, Nkv, S_p, D), (L, B0, Nkv, S_p, D), (L, B, Nkv, T_max, D),
                                       (L, B, Nkv, T_max, D))
    pstarts = (2, 0, 11)
    pm = slot_mask(B0, S_p, (plen,) * B0, pstarts)
    jl = (jnp.asarray(1, jnp.int32), jnp.asarray(pstarts, jnp.int32), jnp.asarray(plen, jnp.int32),
          jnp.asarray(tlen, jnp.int32), nb)
    tl = (1, t(pm), torch.tensor(plen, dtype=torch.int32), torch.tensor(tlen, dtype=torch.int32), nb)
    if not int8:
        return ((*(jnp.asarray(x) for x in (q, kf, vf, kp, vp, kt, vt)), *jl),
                (*(t(x) for x in (q, kf, vf, kp, vp, kt, vt)), *tl))
    planes = [quantize_kv(t(x)) for x in (kp, vp, kt, vt)]
    return ((*(jnp.asarray(x) for x in (q, kf, vf)), *(jnp.asarray(a.numpy()) for p in planes for a in p), *jl),
            (t(q), t(kf), t(vf), *(a for p in planes for a in p), *tl))


@pytest.mark.parametrize("D,G", HEADS)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16-cache", "int8-cache"])
def test_beam_decode(D, G, int8):
    jargs, targs = _beam_args(D, G, int8)
    jk, tk, tol = ((pa.decode_beam_attention_int8, ca.decode_beam_attention_int8, INT8_TOL) if int8
                   else (pa.decode_beam_attention, ca.decode_beam_attention, TOL))
    ref = jk(*jargs, block_k=8, interpret=True)
    np.testing.assert_allclose(tk(*targs).numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_head_dims_admitted_and_planned():
    """The wrappers admit exactly KERNEL_DIMS (112, MPT-30B's, since ALiBi's
    port); D = 256 takes one consumer warpgroup a flash block and 8 queries a
    bf16 beam block, 112 the 128-wide bodies' 16."""
    assert ca.KERNEL_DIMS == (64, 80, 96, 112, 128, 256)
    for D in ca.KERNEL_DIMS:
        ca._check_heads(32, 32, D)
    assert ca.beam_queries(112) == ca.beam_queries(128) == 16
    for D in (48, 120, 160, 512):
        with pytest.raises(ValueError, match="unsupported head shape"):
            ca._check_heads(32, 32, D)
    assert ca.flash_warpgroups(1, 64, 16, 16, 1, 132, D=256) == 1
    assert ca.flash_warpgroups(1, 64, 16, 16, 1, 132, D=80) == 2
    assert ca.beam_plan(16, 4, 64, 16, 256, 32, 132, 256)[0] == 2  # G = 4: two beams a block
    assert ca.beam_plan(16, 4, 64, 16, 256, 32, 132, 96)[0] == 4


# ---------------------------------------------------------------------------
# the CodeGen converter
# ---------------------------------------------------------------------------


def codegen_state_dict(cfg, seed):
    """A seeded HF state dict of ``cfg`` in CodeGen's key layout: qkv_proj
    [3H, H] in mp_num = 4 blocks of [q | v | k] chunks (numpy, fp32)."""
    rng = np.random.default_rng(seed)
    H, F, V = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    sd = {"transformer.wte.weight": rng.standard_normal((V, H)), "transformer.ln_f.weight": rng.standard_normal(H),
          "transformer.ln_f.bias": rng.standard_normal(H), "lm_head.weight": rng.standard_normal((V, H)),
          "lm_head.bias": rng.standard_normal(V)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": rng.standard_normal(H), p + "ln_1.bias": rng.standard_normal(H),
                   p + "attn.qkv_proj.weight": rng.standard_normal((3 * H, H)),
                   p + "attn.out_proj.weight": rng.standard_normal((H, H)),
                   p + "mlp.fc_in.weight": rng.standard_normal((F, H)), p + "mlp.fc_in.bias": rng.standard_normal(F),
                   p + "mlp.fc_out.weight": rng.standard_normal((H, F)),
                   p + "mlp.fc_out.bias": rng.standard_normal(H)})
    return {k: (0.1 * v).astype(np.float32) for k, v in sd.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def test_codegen_converter_matches_lia_tpu(tmp_path):
    """The port's _params_codegen gives lia_tpu's tree bit for bit (bf16 and
    fp32 configs, codegen-tiny widened to D = 80), and load_hf_checkpoint
    over two safetensors shards of the same dict gives it too."""
    for dtype in ("bfloat16", "float32"):
        jcfg = j_get_config("codegen-tiny").replace(dtype=dtype, **WIDE["codegen-d80"][1])
        tcfg = get_config("codegen-tiny").replace(dtype=dtype, **WIDE["codegen-d80"][1])
        sd = codegen_state_dict(tcfg, seed=4)
        ref, out = _flat(j_from_hf(jcfg, sd)), _flat(params_from_hf_state_dict(tcfg, sd))
        assert set(out) == set(ref)
        for k in ref:
            assert out[k].dtype == getattr(torch, dtype) and tuple(out[k].shape) == np.asarray(ref[k]).shape, k
            np.testing.assert_array_equal(out[k].float().numpy(), np.asarray(ref[k], np.float32), err_msg=k)
    keys = sorted(sd)
    halves = [k for k in keys if ".h.1." not in k], [k for k in keys if ".h.1." in k]
    for i, part in enumerate(halves):
        safetensors.save_file({k: t(sd[k]) for k in part}, os.path.join(tmp_path, f"model-0000{i + 1}.safetensors"))
    loaded = _flat(load_hf_checkpoint(tcfg, str(tmp_path)))
    for k, v in _flat(params_from_hf_state_dict(tcfg, sd)).items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_codegen_admitted():
    for name in ("codegen-tiny", "codegen-2b", "codegen-6b"):
        T.check_supported(get_config(name))
    assert get_config("codegen-2b").head_dim == 80 and get_config("codegen-6b").head_dim == 256


# ---------------------------------------------------------------------------
# models at the new head dims: greedy tokens, serving, beam, tiered
# ---------------------------------------------------------------------------

# name: (tiny registry entry, its widening): two heads of the new D each
WIDE = {
    "opt-d80": ("opt-tiny", dict(hidden_size=160, num_heads=2, num_kv_heads=2, head_dim=80)),
    "codegen-d80": ("codegen-tiny", dict(hidden_size=160, num_heads=2, num_kv_heads=2, head_dim=80, rotary_dim=32)),
    "neox-d96": ("neox-tiny", dict(hidden_size=192, num_heads=2, num_kv_heads=2, head_dim=96, rotary_dim=24)),
    "gptj-d256": ("gptj-tiny", dict(hidden_size=512, num_heads=2, num_kv_heads=2, head_dim=256, rotary_dim=64)),
    "codegen-d256": ("codegen-tiny", dict(hidden_size=512, num_heads=2, num_kv_heads=2, head_dim=256,
                                          rotary_dim=64)),
}
PROMPTS = [[5, 9, 23, 41, 7, 7, 19], [100, 7, 3], list(range(30, 52))]
NEW = 8


@functools.lru_cache(maxsize=None)
def model(name):
    """(jax cfg, jax params, port cfg, port params) of a widened config, fp32,
    the reference's dummy tree at scale 0.2 (greedy margins wide)."""
    base, kw = WIDE[name]
    jcfg = j_get_config(base).replace(dtype="float32", **kw)
    jp = j_init(jcfg, seed=29, scale=0.2)
    return jcfg, jp, get_config(base).replace(dtype="float32", **kw), params_from_jax(jp)


@functools.lru_cache(maxsize=None)
def engines(name, kv="none"):
    jcfg, jp, tcfg, tp = model(name)
    return (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv))),
            InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu"))


@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("name", list(WIDE))
def test_generate_matches_lia_tpu(name, kv):
    """Greedy tokens, stepwise and fused, equal lia_tpu's."""
    jeng, teng = engines(name, kv)
    jgen, tgen = JGen(max_new_tokens=NEW), GenerationConfig(max_new_tokens=NEW)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen).sequences, jeng.generate(PROMPTS, jgen).sequences)
    np.testing.assert_array_equal(teng.generate(PROMPTS, tgen, fused=True).sequences,
                                  jeng.generate(PROMPTS, jgen, fused=True).sequences)


def test_generate_beam_matches_lia_tpu():
    """Grouped beam search, 3 beams, at D = 80."""
    jeng, teng = engines("opt-d80")
    gen = dict(max_new_tokens=NEW, num_beams=3)
    np.testing.assert_array_equal(teng.generate_beam(PROMPTS, GenerationConfig(**gen)).sequences,
                                  jeng.generate_beam(PROMPTS, JGen(**gen), grouped=True).sequences)


def test_tiered_matches_lia_tpu():
    """The tiered scheduler at hbm 50 under policy 3 gives lia_tpu's tokens at
    D = 80 (those of its resident engine, as tests/test_torch_families.py)."""
    gen = dict(max_new_tokens=NEW)
    ref = engines("opt-d80")[0].generate(PROMPTS, JGen(**gen)).sequences
    _, _, tcfg, tp = model("opt-d80")
    teng = InferenceEngine(tcfg, tp, RuntimeConfig(hbm_percentage=50, stream_weights=True), device="cpu")
    assert teng.scheduler is not None
    np.testing.assert_array_equal(teng.generate(PROMPTS, GenerationConfig(**gen)).sequences, ref)


def test_paged_serving_matches_lia_tpu():
    """ContinuousBatcher, paged with prefix caching and chunked admission, at
    D = 80: each request's tokens and the prefix hits equal lia_tpu's."""
    sys_prompt = [((7 * i) % 300) + 2 for i in range(20)]
    prompts = [sys_prompt + [401, 402, 403], [8, 8, 8, 8, 8, 12, 13], sys_prompt + [404, 405], list(range(3, 43))]
    jcfg, jp, tcfg, tp = model("opt-d80")
    opts = dict(paged=True, block_size=8, prefill_chunk=16)
    outs, stats = [], []
    for batcher in (JBatcher(jcfg, jp, gen=JGen(max_new_tokens=NEW), max_batch=2, max_len=128, **opts),
                    ContinuousBatcher(tcfg, tp, gen=GenerationConfig(max_new_tokens=NEW), max_batch=2, max_len=128,
                                      device="cpu", **opts)):
        ids = [batcher.submit(p) for p in prompts]
        by_id = {r.req_id: [int(x) for x in r.output] for r in batcher.run()}
        outs.append([by_id[i] for i in ids])
        stats.append(batcher.stats())
    assert outs[1] == outs[0]
    assert stats[1].get("prefix_hits") == stats[0].get("prefix_hits")
