"""The port's decoder and engine against the JAX package on opt-tiny, in fp32 on
the CPU, with the reference's parameters carried across (params_from_jax).

fp32 makes greedy tokens exact; attention runs the kernels' plain versions here
and the JAX reference runs its CPU golden paths.
"""

from functools import partial

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models import transformer as JT
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops.fuse import fuse_projections as j_fuse
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine, bucket_length, pack_prompts
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.utils.checkpoint import init_dummy_params, params_from_jax

PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [3, 4], [100, 200, 300, 400, 17, 18]]


@pytest.fixture(scope="module")
def model():
    """opt-tiny in fp32 with the reference's dummy weights (scale raised so the
    logits are far from flat), as (jax cfg, jax params, port cfg, port params)."""
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=11, scale=0.05)
    return jcfg, jp, get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp)


@pytest.mark.parametrize("fused_proj", [False, True])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_prefill_and_decode_logits_match_lia_tpu(model, kv, fused_proj):
    jcfg, jp, tcfg, tp = model
    if fused_proj:
        jp, tp = j_fuse(jcfg, jp), fuse_projections(tcfg, tp)
    tokens_np, mask_np = pack_prompts(PROMPTS, pad_id=1)
    B, S = tokens_np.shape
    S_max, q = 64, kv == "int8"
    jc = jkvc.init_cache(jcfg, B, S_max, jnp.float32, quantized=q)
    tc = kvc.init_cache(tcfg, B, S_max, torch.float32, quantized=q)
    jprefill = jax.jit(partial(JT.prefill, jcfg))
    jdecode = jax.jit(partial(JT.decode_step, jcfg))
    jl, jc = jprefill(jp, jnp.asarray(tokens_np), jnp.asarray(mask_np), jc)
    tl, tc = T.prefill(tcfg, tp, torch.from_numpy(tokens_np), torch.from_numpy(mask_np), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    pos = mask_np.sum(1).astype(np.int32)
    steps = np.random.default_rng(0).integers(2, tcfg.vocab_size, (8, B)).astype(np.int32)
    for i, tok in enumerate(steps):
        jl, jc = jdecode(jp, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None] + i), jc)
        tl, tc = T.decode_step(tcfg, tp, torch.from_numpy(tok[:, None]),
                               torch.from_numpy(pos[:, None] + i), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert int(tc.length) == int(jc.length) == S + len(steps)
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_generate_tokens_exact_vs_lia_tpu(model, kv, eos):
    """Greedy tokens equal lia_tpu's InferenceEngine, stepwise and fused, and the
    port's fused loop equals its stepwise loop."""
    jcfg, jp, tcfg, tp = model
    n = 10
    jeng = JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv)))
    teng = InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu")
    eos_id = None
    if eos:  # the second token of row 0 becomes EOS, so row 0 finishes early
        eos_id = int(jeng.generate(PROMPTS, JGen(max_new_tokens=2)).sequences[0, 1])
    jgen, tgen = JGen(max_new_tokens=n, eos_token_id=eos_id), GenerationConfig(max_new_tokens=n, eos_token_id=eos_id)
    ref_step = jeng.generate(PROMPTS, jgen).sequences
    ref_fused = jeng.generate(PROMPTS, jgen, fused=True).sequences
    step = teng.generate(PROMPTS, tgen).sequences
    fused = teng.generate(PROMPTS, tgen, fused=True).sequences
    np.testing.assert_array_equal(step, ref_step)
    np.testing.assert_array_equal(fused, ref_fused)
    np.testing.assert_array_equal(fused[:, : step.shape[1]], step)
    assert fused.shape == (len(PROMPTS), n) and fused.dtype == np.int32


def test_generate_bf16_matches_lia_tpu_prefill_logits(model):
    """bf16 on both sides: the two frameworks round in other places, so the
    prompt logits agree to a bf16 tolerance rather than exactly."""
    jcfg, jp, tcfg, tp = model
    jcfg16, tcfg16 = jcfg.replace(dtype="bfloat16"), tcfg.replace(dtype="bfloat16")
    jp16 = jax_tree_cast(jp, jnp.bfloat16)
    tp16 = params_from_jax(jp16)
    tokens_np, mask_np = pack_prompts(PROMPTS, pad_id=1)
    B = tokens_np.shape[0]
    jl, _ = jax.jit(partial(JT.prefill, jcfg16))(jp16, jnp.asarray(tokens_np), jnp.asarray(mask_np),
                       jkvc.init_cache(jcfg16, B, 64, jnp.bfloat16))
    tl, _ = T.prefill(tcfg16, tp16, torch.from_numpy(tokens_np), torch.from_numpy(mask_np),
                      kvc.init_cache(tcfg16, B, 64, torch.bfloat16))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), rtol=0, atol=3e-2)


def jax_tree_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: jax_tree_cast(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree, dtype)


def test_generate_latency_and_streaming(model):
    _, _, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, device="cpu")
    seen = []
    res = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=4), on_token=seen.append)
    assert res.sequences.shape == (3, 4) and len(seen) == 4
    np.testing.assert_array_equal(np.stack(seen, axis=1), res.sequences)
    s = res.summary()
    assert s["first_token_latency_s"] > 0 and s["decode_tokens_per_s"] > 0
    fused = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=4), fused=True)
    assert len(fused.latency.token_latencies_s) == 4
    with pytest.raises(ValueError):
        eng.generate(PROMPTS, GenerationConfig(max_new_tokens=4), fused=True, on_token=print)


def test_generate_sampling_is_seeded(model):
    _, _, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, device="cpu")
    gen = GenerationConfig(max_new_tokens=6, do_sample=True, top_k=20, temperature=1.5)
    a = eng.generate(PROMPTS, gen, fused=True, seed=3).sequences
    b = eng.generate(PROMPTS, gen, fused=True, seed=3).sequences
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()


def test_unported_features_raise(model):
    _, _, tcfg, tp = model
    eng = InferenceEngine(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="generate_beam"):  # beams go through generate_beam
        eng.generate(PROMPTS, GenerationConfig(max_new_tokens=3, num_beams=2))
    for rt in (RuntimeConfig(mesh_shape=(1, 2)), RuntimeConfig(use_pallas=False)):
        with pytest.raises(NotImplementedError):
            InferenceEngine(tcfg, tp, rt, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):  # ALiBi runs since its port; MoE still raises
        InferenceEngine(get_config("mixtral-tiny"), tp, device="cpu")
    bloom = get_config("bloom-tiny").replace(dtype="float32")
    eng = InferenceEngine(bloom, init_dummy_params(bloom, seed=0), device="cpu")
    assert eng.generate(PROMPTS, GenerationConfig(max_new_tokens=2)).sequences.shape[0] == len(PROMPTS)


def test_engine_defaults_to_cuda():
    """Without device="cpu" the engine runs on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("opt-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, {})


def test_slot_buckets_match_lia_tpu(model):
    jcfg, jp, tcfg, tp = model
    for kv in ("none", "int8"):
        j = JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv)))
        t = InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu")
        assert t._slot_bucket() == j._slot_bucket()


def test_bucket_and_pack_match_lia_tpu():
    from lia_tpu.engine.engine import bucket_length as jb
    from lia_tpu.engine.engine import pack_prompts as jpack

    assert [bucket_length(n) for n in (1, 16, 17, 100, 300)] == [jb(n) for n in (1, 16, 17, 100, 300)]
    for a, b in zip(pack_prompts(PROMPTS, 1), jpack(PROMPTS, 1)):
        np.testing.assert_array_equal(a, b)


def _planes_close(tplane, jplane, mask: np.ndarray) -> None:
    """The two packages' cache planes agree over the valid slots of ``mask``
    [B, S]: fp32 to 1e-4, INT8 as dequantized values to one code step (a
    value ~1e-6 from a rounding boundary may take the neighbouring code)."""
    if hasattr(jplane, "q"):
        t = tplane.q.float().numpy() * tplane.s.numpy()[..., None]
        j = np.asarray(jplane.q, np.float32) * np.asarray(jplane.s)[..., None]
        tol = float(np.asarray(jplane.s).max()) * 1.01
    else:
        t, j, tol = tplane.numpy(), np.asarray(jplane), 1e-4
    S = mask.shape[1]
    assert (np.abs(t[..., :S, :] - j[..., :S, :]) * mask[None, :, None, :, None]).max() <= tol


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_prefill_chunk_matches_lia_tpu_and_full_prefill(model, kv):
    """A left-padded 32-token prompt in two 16-token chunks (the first with
    pads) against lia_tpu's prefill_chunk: logits ≤ 1e-4 and the same cache;
    over bf16/fp32 KV the last chunk's logits equal a full prefill's."""
    jcfg, jp, tcfg, tp = model
    tokens_np, mask_np = pack_prompts([list(range(3, 23)), list(range(40, 70))], pad_id=1, bucket=32)
    B, S_max, q = 2, 64, kv == "int8"
    jc = jkvc.init_cache(jcfg, B, S_max, jnp.float32, quantized=q)
    tc = kvc.init_cache(tcfg, B, S_max, torch.float32, quantized=q)
    jchunk = jax.jit(partial(JT.prefill_chunk, jcfg))
    for off in (0, 16):
        sl = slice(off, off + 16)
        jl, jc = jchunk(jp, jnp.asarray(tokens_np[:, sl]), jnp.asarray(mask_np[:, sl]), jc)
        tl, tc = T.prefill_chunk(tcfg, tp, torch.from_numpy(tokens_np[:, sl]), torch.from_numpy(mask_np[:, sl]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert int(tc.length) == int(jc.length) == 32
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    for tp_, jp_ in ((tc.k, jc.k), (tc.v, jc.v)):
        _planes_close(tp_, jp_, mask_np)
    if not q:  # over INT8 the chunks attend to dequantized K/V, a full prefill to its own
        full, _ = T.prefill(tcfg, tp, torch.from_numpy(tokens_np), torch.from_numpy(mask_np),
                            kvc.init_cache(tcfg, B, S_max, torch.float32))
        np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_decode_step_ragged_matches_lia_tpu(model, kv):
    """Two rows admitted with different buckets through insert_slot (per-row
    lengths 16 and 32), then 4 ragged steps with row 1 inactive in one of them:
    logits ≤ 1e-4 against lia_tpu and the same lengths and masks."""
    jcfg, jp, tcfg, tp = model
    B, S_max, q = 2, 64, kv == "int8"
    jc = jkvc.init_cache(jcfg, B, S_max, jnp.float32, quantized=q)
    jc = jc._replace(length=jnp.zeros((B,), jnp.int32))
    tc = kvc.init_cache(tcfg, B, S_max, torch.float32, quantized=q)
    tc = tc._replace(length=torch.zeros(B, dtype=torch.int32))
    pos = []
    for slot, prompt in enumerate(([5, 6, 7, 8, 9], list(range(60, 80)))):
        toks, mask = pack_prompts([prompt], pad_id=1)
        jseg = jkvc.init_cache(jcfg, 1, S_max, jnp.float32, quantized=q)
        tseg = kvc.init_cache(tcfg, 1, S_max, torch.float32, quantized=q)
        _, jseg = JT.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(mask), jseg)
        _, tseg = T.prefill(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(mask), tseg)
        jc = jkvc.insert_slot(jc, jseg, jnp.asarray(slot, jnp.int32))
        tc = kvc.insert_slot(tc, tseg, slot)
        pos.append(len(prompt))
    np.testing.assert_array_equal(tc.length.numpy(), [16, 32])
    pos = np.asarray(pos, np.int32)
    steps = np.random.default_rng(1).integers(2, tcfg.vocab_size, (4, B)).astype(np.int32)
    jstep = jax.jit(partial(JT.decode_step_ragged, jcfg))
    for i, tok in enumerate(steps):
        active = np.array([True, i != 2])
        jl, jc = jstep(jp, jnp.asarray(tok[:, None]), jnp.asarray(pos), jc, jnp.asarray(active))
        tl, tc = T.decode_step_ragged(tcfg, tp, torch.from_numpy(tok[:, None]), torch.from_numpy(pos), tc,
                                      torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        pos = pos + active
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    for tp_, jp_ in ((tc.k, jc.k), (tc.v, jc.v)):
        _planes_close(tp_, jp_, tc.mask.numpy())
