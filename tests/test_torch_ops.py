"""The port's configs, registry, parameter conversion, norms, fusion, KV cache,
quantization, sampling and metrics against the JAX package on the CPU, plus the
port's import boundary and build errors."""

import ast
import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu import config as jconfig
from lia_tpu.models import registry as jreg
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops import norms as jnorms
from lia_tpu.ops import sampling as jsampling
from lia_tpu.ops.fuse import fuse_projections as j_fuse
from lia_tpu.ops.quant import quantize_kv as j_quantize_kv
from lia_tpu.utils import checkpoint as jckpt
from lia_tpu.utils.metrics import LatencyStats as JLatencyStats

from lia_tpu_torch import config as tconfig
from lia_tpu_torch.models import registry as treg
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import norms
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.ops.quant import QuantizedKV, quantize_kv
from lia_tpu_torch.utils import checkpoint as ckpt
from lia_tpu_torch.utils.metrics import LatencyStats, format_summary

REPO = Path(__file__).resolve().parent.parent


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _norm(v):
    """Enum members of either package compare by value; nested configs by fields."""
    if dataclasses.is_dataclass(v):
        return {k: _norm(x) for k, x in _fields(v).items()}
    return v.value if hasattr(v, "value") else v


@pytest.mark.parametrize("name", sorted(jreg.REGISTRY))
def test_registry_entry_equals_lia_tpu(name):
    j, t = jreg.get_config(name), treg.get_config(name)
    assert _norm(t) == _norm(j)
    assert (t.embed_dim, t.q_heads_per_kv, t.num_params) == (j.embed_dim, j.q_heads_per_kv, j.num_params)


def test_registry_has_the_same_names_and_aliases():
    assert sorted(treg.REGISTRY) == sorted(jreg.REGISTRY)
    for alias in ("facebook/opt-6.7b", "meta-llama/Llama-2-7b-hf", "mistralai/Mistral-7B-v0.1"):
        assert treg.get_config(alias).name == jreg.get_config(alias).name
    with pytest.raises(KeyError):
        treg.get_config("no-such-model")


@pytest.mark.parametrize(
    "cls", ["ModelConfig", "QuantConfig", "RuntimeConfig", "GenerationConfig"]
)
def test_config_defaults_equal_lia_tpu(cls):
    assert _norm(getattr(tconfig, cls)()) == _norm(getattr(jconfig, cls)())


def test_config_enums_equal_lia_tpu():
    for enum_name in ("Activation", "Norm", "Placement"):
        assert [m.value for m in getattr(tconfig, enum_name)] == [m.value for m in getattr(jconfig, enum_name)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(dtype):
    cfg = jreg.get_config("opt-tiny").replace(dtype=dtype)
    jp = jckpt.init_dummy_params(cfg, seed=5)
    tp = ckpt.params_from_jax(jp)

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
            return
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape and str(b.dtype).endswith(a.dtype.name)
        if a.dtype.name == "bfloat16":  # bit patterns, without importing ml_dtypes
            np.testing.assert_array_equal(b.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)

    walk(jp, tp)


def test_init_dummy_params_fp32_bit_equal_to_lia_tpu():
    cfg = jreg.get_config("opt-tiny").replace(dtype="float32")
    jp = ckpt.params_from_jax(jckpt.init_dummy_params(cfg, seed=7, scale=0.02))
    tp = ckpt.init_dummy_params(treg.get_config("opt-tiny").replace(dtype="float32"), seed=7, scale=0.02)

    def walk(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                walk(a[k], b[k])
        else:
            assert torch.equal(a, b)

    walk(jp, tp)


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny", "qwen2-tiny", "gptj-tiny"])
def test_dummy_params_structure_matches_lia_tpu(name):
    """bf16 trees: same keys, shapes and dtypes as the reference's (values differ:
    the reference draws bf16 leaves with a native generator), on the host and
    drawn on a device."""
    jp = jckpt.init_dummy_params(jreg.get_config(name), seed=0)
    for tp in (ckpt.init_dummy_params(treg.get_config(name)),
               ckpt.device_dummy_params(treg.get_config(name), device="cpu")):
        def walk(a, b):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    walk(a[k], b[k])
            else:
                assert tuple(b.shape) == np.shape(a) and b.dtype == torch.bfloat16

        walk(jp, tp)


def test_device_dummy_params_is_seeded():
    cfg = treg.get_config("opt-tiny")
    a = ckpt.device_dummy_params(cfg, seed=3, device="cpu")
    b = ckpt.device_dummy_params(cfg, seed=3, device="cpu")
    c = ckpt.device_dummy_params(cfg, seed=4, device="cpu")
    assert torch.equal(a["embed_tokens"], b["embed_tokens"])
    assert not torch.equal(a["embed_tokens"], c["embed_tokens"])
    assert 0.004 < a["layers"]["mlp"]["w1"].float().std().item() < 0.008  # scale 0.006


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_lia_tpu(rng, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    t = [torch.from_numpy(a).to(td) for a in (x, s, b)]
    j = [jnp.asarray(a, jd) for a in (x, s, b)]
    np.testing.assert_allclose(as_np(norms.layernorm(*t)), as_np(jnorms.layernorm(*j)), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        as_np(norms.rmsnorm(t[0], t[1], 1e-6)), as_np(jnorms.rmsnorm(j[0], j[1], 1e-6)), rtol=tol, atol=tol
    )
    assert norms.layernorm(*t).dtype == td


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny", "qwen2-tiny"])
def test_fuse_projections_matches_lia_tpu(name):
    cfg = jreg.get_config(name).replace(dtype="float32")
    jp = jckpt.init_dummy_params(cfg, seed=2)
    jf = j_fuse(cfg, jp)
    tf = fuse_projections(treg.get_config(name), ckpt.params_from_jax(jp))
    for group in ("attn", "mlp"):
        assert jf["layers"][group].keys() == tf["layers"][group].keys()
        for k, a in jf["layers"][group].items():
            np.testing.assert_array_equal(tf["layers"][group][k].numpy(), np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_lia_tpu(rng, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    x = (rng.standard_normal((2, 3, 4, 9, 16)) * 2).astype(np.float32)
    x[0, 0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor scale
    x[1, 2, 3, 4, 5] = 40.0  # an outlier
    j = j_quantize_kv(jnp.asarray(x, jd))
    t = quantize_kv(torch.from_numpy(x).to(td))
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))


def _random_cache(rng, cfg, B, S_max, quantized):
    """The same random cache in both packages (fp32 planes or int8 + scales)."""
    shape = (cfg.num_layers, B, cfg.num_kv_heads, S_max, cfg.head_dim)
    jc = jkvc.init_cache(cfg, B, S_max, jnp.float32, quantized=quantized)
    tc = kvc.init_cache(treg.get_config(cfg.name), B, S_max, torch.float32, quantized=quantized)
    if quantized:
        jk = j_quantize_kv(jnp.asarray(rng.standard_normal(shape), jnp.float32))
        jv = j_quantize_kv(jnp.asarray(rng.standard_normal(shape), jnp.float32))
        tk = QuantizedKV(torch.from_numpy(np.array(jk.q)), torch.from_numpy(np.array(jk.s)))
        tv = QuantizedKV(torch.from_numpy(np.array(jv.q)), torch.from_numpy(np.array(jv.s)))
    else:
        k, v = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    return jc._replace(k=jk, v=jv), tc._replace(k=tk, v=tv)


def _assert_cache_equal(tc, jc):
    for tp, jp in ((tc.k, jc.k), (tc.v, jc.v)):
        if isinstance(tp, QuantizedKV):
            np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
            np.testing.assert_array_equal(tp.s.numpy(), np.asarray(jp.s))
        else:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    assert int(tc.length) == int(jc.length)


@pytest.mark.parametrize("quantized", [False, True])
def test_init_cache_matches_lia_tpu(quantized):
    jcfg = jreg.get_config("llama-tiny")
    jc = jkvc.init_cache(jcfg, 3, 64, jnp.bfloat16, quantized=quantized)
    tc = kvc.init_cache(treg.get_config("llama-tiny"), 3, 64, torch.bfloat16, quantized=quantized)
    for tp, jp in ((tc.k, jc.k), (tc.v, jc.v)):
        if quantized:
            assert tuple(tp.q.shape) == jp.q.shape and tp.q.dtype == torch.int8
            assert tuple(tp.s.shape) == jp.s.shape and tp.s.dtype == torch.float32
        else:
            assert tuple(tp.shape) == jp.shape and tp.dtype == torch.bfloat16
    assert tc.length.dtype == torch.int32 and tc.length.ndim == 0
    assert tuple(tc.mask.shape) == jc.mask.shape and tc.mask.dtype == torch.bool


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_writes_match_lia_tpu(rng, quantized):
    """update_layer (prompt), write_token_all (decode step) and advance, in place
    in the port, give the reference's cache contents."""
    cfg = jreg.get_config("opt-tiny")
    L, B, S_max, Nkv, D = cfg.num_layers, 2, 32, cfg.num_kv_heads, cfg.head_dim
    jc, tc = _random_cache(rng, cfg, B, S_max, quantized)

    # a 12-token prompt into layer 1 at offset 0, then advance with a left-pad mask
    new_k = rng.standard_normal((B, Nkv, 12, D)).astype(np.float32)
    new_v = rng.standard_normal((B, Nkv, 12, D)).astype(np.float32)
    jk1, jv1 = jkvc.update_layer(
        jkvc.index_layer_kv(jc.k, 1), jkvc.index_layer_kv(jc.v, 1),
        jnp.asarray(new_k), jnp.asarray(new_v), jc.length,
    )
    jc = jc._replace(k=jkvc.set_layer_kv(jc.k, jk1, 1), v=jkvc.set_layer_kv(jc.v, jv1, 1))
    kvc.update_layer(kvc.index_layer_kv(tc.k, 1), kvc.index_layer_kv(tc.v, 1),
                     torch.from_numpy(new_k), torch.from_numpy(new_v), tc.length)
    pmask = np.ones((B, 12), bool)
    pmask[1, :5] = False
    jc = jkvc.advance(jc, jnp.asarray(pmask), 12)
    tc = kvc.advance(tc, torch.from_numpy(pmask), 12)
    _assert_cache_equal(tc, jc)

    # one decode step for all layers
    step_k = rng.standard_normal((L, B, Nkv, 1, D)).astype(np.float32)
    step_v = rng.standard_normal((L, B, Nkv, 1, D)).astype(np.float32)
    jc = jc._replace(k=jkvc.write_token_all(jc.k, jnp.asarray(step_k), jc.length),
                     v=jkvc.write_token_all(jc.v, jnp.asarray(step_v), jc.length))
    tk = kvc.write_token_all(tc.k, torch.from_numpy(step_k), tc.length)
    assert tk is tc.k  # written in place
    kvc.write_token_all(tc.v, torch.from_numpy(step_v), tc.length)
    jc = jkvc.advance(jc, jnp.ones((B, 1), bool), 1)
    tc = kvc.advance(tc, torch.ones(B, 1, dtype=torch.bool), 1)
    _assert_cache_equal(tc, jc)


def test_ragged_offsets_are_not_ported_yet():
    cfg = treg.get_config("opt-tiny")
    c = kvc.init_cache(cfg, 2, 16, torch.float32)
    with pytest.raises(NotImplementedError):
        kvc.write_token_all(c.k, torch.zeros(2, 2, 4, 1, 16), torch.tensor([1, 2]))


def test_greedy_matches_lia_tpu(rng):
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = 10.0  # a tie goes to the first index in both
    np.testing.assert_array_equal(
        sampling.greedy(torch.from_numpy(logits)).numpy(), np.asarray(jsampling.greedy(jnp.asarray(logits)))
    )


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 10, 0.6)])
def test_warped_probs_match_lia_tpu(rng, temperature, top_k, top_p):
    logits = (rng.standard_normal((3, 64)) * 2).astype(np.float32)
    tg = tconfig.GenerationConfig(do_sample=True, temperature=temperature, top_k=top_k, top_p=top_p)
    jg = jconfig.GenerationConfig(do_sample=True, temperature=temperature, top_k=top_k, top_p=top_p)
    np.testing.assert_allclose(
        sampling.warped_probs(torch.from_numpy(logits), tg).numpy(),
        np.asarray(jsampling.warped_probs(jnp.asarray(logits), jg)),
        rtol=1e-5, atol=1e-6,
    )


def test_sample_uses_the_generator(rng):
    logits = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    gen = tconfig.GenerationConfig(do_sample=True, top_k=8)
    draws = [sampling.sample(logits, gen, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    allowed = torch.topk(logits, 8).indices
    assert all(bool((d[:, None] == allowed).any(1).all()) for d in draws)
    greedy_cfg = tconfig.GenerationConfig(do_sample=True, top_k=1)
    assert torch.equal(sampling.sample(logits, greedy_cfg, torch.Generator()), sampling.greedy(logits))


def test_latency_stats_match_lia_tpu():
    lats = [0.5, 0.01, 0.02, 0.015, 0.03, 0.011]
    t, j = LatencyStats(), JLatencyStats()
    for x in lats:
        t.record(x)
        j.record(x)
    assert t.summary(4) == j.summary(4)
    assert format_summary(t.summary(4)).startswith("---- latency summary ----")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_lia_tpu():
    """lia_tpu_torch starts with "lia_tpu", so a prefix search would not do: parse
    every module and reject an import of jax, ml_dtypes or lia_tpu, or of a
    module under them."""
    files = sorted((REPO / "lia_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    banned = ("jax", "jaxlib", "ml_dtypes", "lia_tpu")
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imports(f)
        if any(name == b or name.startswith(b + ".") for b in banned)
    ]
    assert bad == []


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    from lia_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.BuildError):
        _build.build_all()


def test_library_names_follow_source_content():
    from lia_tpu_torch.ops import _build

    names = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert names == set(_build.SIGNATURES)
    paths = {n: _build._lib_path(n) for n in names}
    assert len({p.name for p in paths.values()}) == len(names)
    assert paths == {n: _build._lib_path(n) for n in names}  # stable
