"""The port's weight quantization against the JAX package on the CPU: the
quantizers and dummy quantized trees (bit-equal), the plain versions of the
three quantized-matmul kernels against the Pallas kernels in interpret mode,
``quantized_matmul`` for every format, quantized projection fusion, and fp32
greedy generation for every weight format on opt-tiny.

Inputs are made with numpy from a seed and handed to both packages.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu import config as jconfig
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models import transformer as JT
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import dispatch
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops import pallas_matmul as jpm
from lia_tpu.ops import quant as jq
from lia_tpu.ops.fuse import fuse_projections as j_fuse
from lia_tpu.utils import checkpoint as jckpt

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine, pack_prompts
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import cuda_matmul as cm
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import quant
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.utils import checkpoint as ckpt

PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [3, 4], [100, 200, 300, 400, 17, 18]]

# (weight_dtype, group_size, act_quant) of every QuantConfig-made format
CONFIGS = [
    ("int8", -1, "none"), ("int8", 16, "none"), ("int8", -1, "dynamic"),
    ("int4", -1, "none"), ("int4", 16, "none"), ("int4", 32, "dynamic"), ("int4", -1, "dynamic"),
    ("nf4", -1, "none"), ("nf4", 32, "none"),
]


def _qc(pkg, wd, gs, aq):
    return pkg.QuantConfig(weight_dtype=wd, group_size=gs, act_quant=aq)


def assert_rec_equal(t, j):
    """A port record equals a JAX record: format, codes, scales and z, bit for bit."""
    assert quant.is_quantized(t) and t.fmt == j.fmt
    for a, b in ((t.q, j.q), (t.s, j.s)):
        assert str(a.dtype).endswith(np.asarray(b).dtype.name)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (t.z is None) == (j.z is None)
    if t.z is not None:
        np.testing.assert_array_equal(t.z.numpy(), np.asarray(j.z))


def assert_tree_equal(t, j):
    if isinstance(j, dict):
        assert t.keys() == j.keys()
        for k in j:
            assert_tree_equal(t[k], j[k])
    elif hasattr(j, "fmt"):
        assert_rec_equal(t, j)
    else:
        a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(a, np.asarray(j, a.dtype))


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wd,gs,aq", CONFIGS)
def test_quantize_weight_bit_equal_to_lia_tpu(rng, wd, gs, aq):
    w = (rng.standard_normal((2, 64, 48)) * 0.1).astype(np.float32)  # stacked [L, K, N]
    w[0, :16, 0] = 0.0  # an all-zero group takes the 1e-8 floor scale
    w[1, 3, 5] = 4.0  # an outlier
    assert_rec_equal(quant.quantize_weight(torch.from_numpy(w), _qc(jconfig, wd, gs, aq)),
                     jq.quantize_weight(w, _qc(jconfig, wd, gs, aq)))


def test_quantize_weight_rejects_what_lia_tpu_rejects(rng):
    w = rng.standard_normal((64, 16)).astype(np.float32)
    for wd, gs, aq in [("int8", 16, "dynamic"), ("nf4", -1, "dynamic"), ("int4", 48, "none")]:
        with pytest.raises((ValueError, AssertionError)):
            jq.quantize_weight(w, _qc(jconfig, wd, gs, aq))
        with pytest.raises(ValueError):
            quant.quantize_weight(w, QuantConfig(weight_dtype=wd, group_size=gs, act_quant=aq))


@pytest.mark.parametrize("V", [503, 512])
@pytest.mark.parametrize("wd,gs,aq", [("int4", 32, "dynamic"), ("int4", -1, "none"), ("nf4", 32, "none"),
                                      ("int8", -1, "dynamic"), ("int4", 48, "none")])
def test_heads_bit_equal_to_lia_tpu(rng, V, wd, gs, aq):
    """Tied heads (a transposed copy) and 2-D heads: int4 pads the vocab to a
    multiple of 128 where E % 256 and the groups allow, else per-channel int8."""
    E = 256
    embed = (rng.standard_normal((V, E)) * 0.05).astype(np.float32)
    head = np.ascontiguousarray(embed.T)
    qt, qj = _qc(jconfig, wd, gs, aq), QuantConfig(weight_dtype=wd, group_size=gs, act_quant=aq)
    t, j = quant.quantize_tied_head(torch.from_numpy(embed), qj), jq.quantize_tied_head(embed, qt)
    assert_rec_equal(t, j)
    assert_rec_equal(quant.quantize_head_2d(head, qj), jq.quantize_head_2d(head, qt))
    if t.fmt.startswith("woq_int4"):
        assert t.q.shape[-1] == V + (-V % 128)


def test_quantize_weight_static_and_retag_bit_equal(rng):
    w = (rng.standard_normal((3, 64, 32)) * 0.1).astype(np.float32)
    amax = np.array([2.0, 0.5, 7.0], np.float32)
    assert_rec_equal(quant.quantize_weight_static(w, amax), jq.quantize_weight_static(w, amax))
    j4 = jq.quantize_weight(w, _qc(jconfig, "int4", 16, "none"))
    jz = jq.QuantizedWeight(j4.q, j4.s, "woq_int4z", j4.s * 0 + 8.0)
    tree_j = {"a": j4, "b": {"c": jz, "d": np.ones(3, np.float32)}}
    tree_t = ckpt.params_from_jax(tree_j)
    assert_tree_equal(quant.retag_dynamic_act(tree_t), jq.retag_dynamic_act(tree_j))


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny"])
@pytest.mark.parametrize("wd,gs,aq", [("int8", -1, "dynamic"), ("int4", 16, "dynamic"), ("nf4", 32, "none")])
def test_quantize_params_bit_equal_to_lia_tpu(name, wd, gs, aq):
    jcfg = j_get_config(name).replace(dtype="float32")
    jp = jckpt.init_dummy_params(jcfg, seed=3, scale=0.05)
    j = jq.quantize_params(jcfg, jp, _qc(jconfig, wd, gs, aq))
    t = quant.quantize_params(get_config(name), ckpt.params_from_jax(jp),
                              QuantConfig(weight_dtype=wd, group_size=gs, act_quant=aq))
    assert_tree_equal(t, j)


@pytest.mark.parametrize("fmt_cfg", [("int8", 16, "none"), ("int4", 16, "none"), ("nf4", 32, "none"), ("int4", -1, "dynamic")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_lia_tpu(rng, fmt_cfg, dtype):
    w = (rng.standard_normal((2, 64, 48)) * 0.1).astype(np.float32)
    j = jq.quantize_weight(w, _qc(jconfig, *fmt_cfg))
    t = quant.quantize_weight(w, QuantConfig(weight_dtype=fmt_cfg[0], group_size=fmt_cfg[1], act_quant=fmt_cfg[2]))
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    a = quant.dequantize(t, td).float().numpy()
    np.testing.assert_array_equal(a, np.asarray(jq.dequantize(j, jd), np.float32))
    z = (rng.integers(0, 16, (2, 64 // 16, 48))).astype(np.float32)  # zero-point form
    jz, tz = jq.QuantizedWeight(j.q, j.s, "woq_int4z", z), quant.QuantizedWeight(t.q, t.s, "woq_int4z", torch.from_numpy(z))
    if fmt_cfg[:2] == ("int4", 16):
        np.testing.assert_array_equal(quant.dequantize(tz, td).float().numpy(),
                                      np.asarray(jq.dequantize(jz, jd), np.float32))


# ---------------------------------------------------------------------------
# dummy quantized trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny"])
@pytest.mark.parametrize("wd,gs,aq", [("int8", -1, "dynamic"), ("int8", 16, "none"), ("int4", 32, "dynamic"), ("nf4", 16, "none")])
def test_init_dummy_params_quantized_bit_equal_to_lia_tpu(name, wd, gs, aq):
    jp = jckpt.init_dummy_params(j_get_config(name).replace(dtype="float32"), seed=4, scale=0.02,
                                 quant=_qc(jconfig, wd, gs, aq))
    tp = ckpt.init_dummy_params(get_config(name).replace(dtype="float32"), seed=4, scale=0.02,
                                quant=QuantConfig(weight_dtype=wd, group_size=gs, act_quant=aq))
    assert_tree_equal(tp, jp)


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny"])
@pytest.mark.parametrize("wd,gs,aq", [("int8", -1, "dynamic"), ("int4", 32, "dynamic"), ("nf4", 16, "none")])
def test_device_dummy_params_quantized_layout(name, wd, gs, aq):
    """Drawn on a device: the reference's keys, shapes, dtypes and formats, and
    dequantized weights with about the spread of the fp dummy."""
    qc = QuantConfig(weight_dtype=wd, group_size=gs, act_quant=aq)
    jp = jckpt.init_dummy_params(j_get_config(name), seed=0, quant=_qc(jconfig, wd, gs, aq), meta=True)
    tp = ckpt.device_dummy_params(get_config(name), seed=0, device="cpu", quant=qc)

    def walk(t, j):
        if isinstance(j, dict):
            assert t.keys() == j.keys()
            for k in j:
                walk(t[k], j[k])
        elif hasattr(j, "fmt"):
            assert t.fmt == j.fmt and (t.z is None) == (j.z is None)
            for a, b in ((t.q, j.q), (t.s, j.s)):
                assert tuple(a.shape) == np.shape(b) and str(a.dtype).endswith(np.asarray(b).dtype.name)
        else:
            assert tuple(t.shape) == np.shape(j)

    walk(tp, jp)
    std = quant.dequantize(tp["layers"]["mlp"]["w1"], torch.float32).std().item()
    assert 0.0005 < std < 0.012


# ---------------------------------------------------------------------------
# plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _act(rng, M, K):
    x = rng.standard_normal((M, K)).astype(np.float32)
    sx = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0, 1e-8).astype(np.float32)
    return x, np.rint(x / sx).astype(np.int8), sx


@pytest.mark.parametrize("zp", [False, True])
@pytest.mark.parametrize("K,gs,bk", [(128, -1, 64), (128, 32, 64), (512, 32, 64), (256, 64, 128)])
def test_w4a8_plain_matches_pallas(rng, K, gs, bk, zp):
    """ng = 1, grouped, several K tiles; biased codes, or raw codes with zero-points."""
    M, N = 8, 64
    ng = 1 if gs < 0 else K // gs
    _, xq, sx = _act(rng, M, K)
    packed = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    s = rng.uniform(0.01, 0.1, (ng, N)).astype(np.float32)
    z = rng.uniform(4.0, 12.0, (ng, N)).astype(np.float32) if zp else None
    ref = jpm.w4a8_matmul(jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(packed), jnp.asarray(s),
                          None if z is None else jnp.asarray(z), group_size=gs, block_m=8,
                          block_n=32, block_k=bk, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = cm.w4a8_matmul(t(xq), t(sx), t(packed), t(s), t(z))
    assert cm.w4a8_matmul.launches == 0  # the CPU takes the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["int8", "int4", "nf4"])
@pytest.mark.parametrize("K,gs", [(128, -1), (128, 32), (512, 64)])
def test_woq_plain_matches_pallas(rng, kind, K, gs):
    M, N = 8, 64
    ng = 1 if gs < 0 else K // gs
    x = rng.standard_normal((M, K)).astype(np.float32)
    if kind == "int8":
        q = rng.integers(-128, 128, (K, N)).astype(np.int8)
        bk = 64 if gs < 0 else gs
    else:
        q = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
        bk = 128 if gs < 0 else 2 * gs
    s = rng.uniform(0.01, 0.1, (ng, N)).astype(np.float32)
    ref = jpm.woq_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), gs, int4=kind != "int8",
                         nf4=kind == "nf4", block_m=8, block_n=32, block_k=bk, interpret=True)
    out = cm.woq_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s), kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("K,gs", [(128, -1), (128, 32), (512, 64)])
def test_woq4z_plain_matches_pallas(rng, K, gs):
    M, N = 8, 64
    ng = 1 if gs < 0 else K // gs
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(0, 256, (K // 2, N)).astype(np.uint8)
    s = rng.uniform(0.01, 0.1, (ng, N)).astype(np.float32)
    z = rng.integers(1, 16, (ng, N)).astype(np.float32)
    ref = jpm.woq4z_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.asarray(z), gs,
                           block_m=8, block_n=32, block_k=64, interpret=True)
    t = [torch.from_numpy(a) for a in (x, q, s, z)]
    np.testing.assert_allclose(cm.woq4z_matmul(*t).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_nf4_table_rounds_to_the_activation_type():
    """The Pallas select tree rounds codebook values to x's type; so does the plain version."""
    q = torch.tensor([[i | (15 - i) << 4 for i in range(16)]], dtype=torch.uint8).repeat(16, 1)
    x = torch.zeros(1, 32, dtype=torch.bfloat16)
    x[0, 0] = 1.0
    out = cm.woq_matmul(x, q, torch.ones(1, 16), "nf4")
    expect = torch.from_numpy(quant.NF4_CODEBOOK).to(torch.bfloat16).float()
    torch.testing.assert_close(out[0], expect, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# quantized_matmul, every format
# ---------------------------------------------------------------------------


@pytest.fixture
def pallas_interpret():
    dispatch.set_use_pallas(True)
    dispatch.set_interpret(True)
    yield
    dispatch.set_use_pallas(None)
    dispatch.set_interpret(None)


def _records(rng, K, N, wd, gs, aq, zp=False):
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    j = jq.quantize_weight(w, _qc(jconfig, wd, gs, aq))
    if zp:  # raw codes with zero-points, as a GPTQ checkpoint gives
        z = rng.integers(1, 16, np.shape(j.s)).astype(np.float32)
        j = jq.QuantizedWeight(j.q, j.s, "woq_int4z_dyn" if aq == "dynamic" else "woq_int4z", z)
    return ckpt.params_from_jax(j), j


FORMATS = [("int8", -1, "none", False), ("int8", 32, "none", False), ("int8", -1, "dynamic", False),
           ("int4", 32, "none", False), ("int4", -1, "none", False), ("int4", 32, "dynamic", False),
           ("int4", -1, "dynamic", False), ("nf4", 64, "none", False), ("int4", 32, "none", True),
           ("int4", 32, "dynamic", True), ("int4", -1, "dynamic", True)]


@pytest.mark.parametrize("wd,gs,aq,zp", FORMATS)
def test_quantized_matmul_matches_lia_tpu_kernels(rng, pallas_interpret, wd, gs, aq, zp):
    """At shapes the Pallas kernels tile (K % 256, N % 128), the JAX package runs
    its kernels in interpret mode and the port their plain versions: the same
    sums, in another order (fp32, about 1e-6 relative). Grouped weights take
    the groups the Pallas kernels tile at K = 512: 128 for int8, 32 packed."""
    K, N = 512, 128
    if gs > 0:
        gs = 128 if wd == "int8" else 32
    t, j = _records(rng, K, N, wd, gs, aq, zp)
    x = rng.standard_normal((2, 4, K)).astype(np.float32)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), j))
    out = quant.quantized_matmul(torch.from_numpy(x), t)
    assert out.dtype == torch.float32 and out.shape == (2, 4, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("wd,gs,aq,zp", FORMATS)
def test_quantized_matmul_matches_lia_tpu_default_paths(rng, wd, gs, aq, zp):
    """On the CPU the JAX package takes its jnp paths: exact integer dots for
    the int8-activation formats (equal up to fp32 summation order), and for the
    weight-only formats a weight dequantized to bf16, where the port's kernel
    keeps the codes exact: those agree to the bf16 rounding of the weight
    (2^-9 relative per element, over a 64-term sum: 1e-2 of the largest output)."""
    K, N = 64, 48
    t, j = _records(rng, K, N, wd, gs, aq, zp)
    x = rng.standard_normal((5, K)).astype(np.float32)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), j))
    out = quant.quantized_matmul(torch.from_numpy(x), t).numpy()
    tol = 1e-5 if ("dyn" in t.fmt) else 1e-2
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_quantized_matmul_static_int8_matches_lia_tpu(rng):
    w = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    j = jq.quantize_weight_static(w, np.float32(3.0))
    x = (rng.standard_normal((6, 64)) * 1.5).astype(np.float32)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), j))
    np.testing.assert_allclose(quant.quantized_matmul(torch.from_numpy(x), ckpt.params_from_jax(j)).numpy(),
                               ref, rtol=1e-6, atol=1e-6)


def test_shapes_without_a_kernel_dequantize_to_bf16(rng):
    """K/2 = 24 rows are not a multiple of 16: both packages dequantize the
    weight to bf16 (even for fp32 x) and run one matmul."""
    t, j = _records(rng, 48, 16, "int4", 8, "none")
    x = rng.standard_normal((3, 48)).astype(np.float32)
    assert not quant._kernel_takes(48, 6, True)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), j))
    np.testing.assert_allclose(quant.quantized_matmul(torch.from_numpy(x), t).numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K,ng,packed,takes", [
    (4096, 32, True, True), (16384, 1, True, True), (4096, 1, False, True), (64, 4, True, True),
    (64, 2, True, True), (48, 6, True, False), (96, 3, True, False), (4096, 32, False, True),
    (40, 1, False, False), (64, 8, True, False), (256, 16, False, True)])
def test_kernel_routing_rules(K, ng, packed, takes):
    assert quant._kernel_takes(K, ng, packed) == takes


# ---------------------------------------------------------------------------
# fusion, and the model end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny"])
@pytest.mark.parametrize("wd,gs,aq", [("int8", -1, "dynamic"), ("int4", 16, "none"), ("nf4", 32, "none")])
def test_fuse_quantized_projections_matches_lia_tpu(name, wd, gs, aq):
    jcfg = j_get_config(name).replace(dtype="float32")
    jp = jq.quantize_params(jcfg, jckpt.init_dummy_params(jcfg, seed=2), _qc(jconfig, wd, gs, aq))
    assert_tree_equal(fuse_projections(get_config(name), ckpt.params_from_jax(jp)), j_fuse(jcfg, jp))


def test_fuse_static_int8_checks_activation_scales(rng):
    cfg = get_config("opt-tiny")
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = jckpt.init_dummy_params(jcfg, seed=2)
    L = jcfg.num_layers
    scales = {k: np.full((L, 8), 2.0, np.float32) for k in ("qkv", "wo_in", "mlp_in", "w2_in")}
    from lia_tpu.ops.quant import quantize_params_static

    js = quantize_params_static(jcfg, jp, scales)
    assert_tree_equal(fuse_projections(cfg, ckpt.params_from_jax(js)), j_fuse(jcfg, js))
    tp = ckpt.params_from_jax(js)
    wk = tp["layers"]["attn"]["wk"]
    tp["layers"]["attn"]["wk"] = wk._replace(z=wk.z * 2)  # disagreeing calibration stays unfused
    assert "wq" in fuse_projections(cfg, tp)["layers"]["attn"]


ENGINE_FORMATS = {  # name → (QuantConfig kwargs, KV cache type)
    "int8dyn+int8kv": (dict(weight_dtype="int8", group_size=-1, act_quant="dynamic"), "int8"),
    "w4a8+int8kv": (dict(weight_dtype="int4", group_size=32, act_quant="dynamic"), "int8"),
    "int8": (dict(weight_dtype="int8", group_size=-1), "none"),
    "int4-g16": (dict(weight_dtype="int4", group_size=16), "none"),
    "nf4-g32": (dict(weight_dtype="nf4", group_size=32), "none"),
    "static_int8": (None, "none"),
}
# Logit tolerance against the JAX package, fp32 on both sides. The int8
# activation formats compute the same exact integer sums (1e-4: an activation
# code can flip where fp32 sums round differently upstream). For the
# weight-only formats the JAX package on the CPU dequantizes to bf16 and the
# port's kernel keeps the codes exact: 2^-9 relative per weight, a few 1e-3
# in the logits.
LOGIT_TOL = {"int8dyn+int8kv": 1e-3, "w4a8+int8kv": 1e-3, "static_int8": 1e-3,
             "int8": 1e-2, "int4-g16": 1e-2, "nf4-g32": 1e-2}


@pytest.fixture(scope="module")
def quantized_models():
    """opt-tiny fp32 trees of every weight format, made by the JAX package, as
    (jax cfg, {name: (jax tree, port tree, kv)}, port cfg)."""
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = jckpt.init_dummy_params(jcfg, seed=11, scale=0.05)
    out = {}
    for name, (qkw, kv) in ENGINE_FORMATS.items():
        if qkw is None:
            from lia_tpu.ops.quant import quantize_params_static

            L = jcfg.num_layers
            scales = {k: np.full((L, 8), a, np.float32) for k, a in
                      (("qkv", 4.0), ("wo_in", 2.0), ("mlp_in", 4.0), ("w2_in", 1.0))}
            jt = quantize_params_static(jcfg, jp, scales)
        else:
            jt = jq.quantize_params(jcfg, jp, jconfig.QuantConfig(**qkw))
        out[name] = (jt, ckpt.params_from_jax(jt), kv)
    return jcfg, out, get_config("opt-tiny").replace(dtype="float32")


@pytest.mark.parametrize("name", list(ENGINE_FORMATS))
def test_quantized_generate_tokens_exact_vs_lia_tpu(quantized_models, name):
    """fp32 greedy tokens equal the JAX engine's over 8 new tokens, fused and
    stepwise, for every weight format; the head of the int4 formats is padded
    and sliced back."""
    jcfg, trees, tcfg = quantized_models
    jt, tt, kv = trees[name]
    jeng = JEngine(jcfg, jt, jconfig.RuntimeConfig(quant=jconfig.QuantConfig(kv_cache_dtype=kv)))
    teng = InferenceEngine(tcfg, tt, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu")
    from lia_tpu.config import GenerationConfig as JGen

    ref = jeng.generate(PROMPTS, JGen(max_new_tokens=8), fused=True).sequences
    np.testing.assert_array_equal(teng.generate(PROMPTS, GenerationConfig(max_new_tokens=8), fused=True).sequences, ref)
    np.testing.assert_array_equal(teng.generate(PROMPTS, GenerationConfig(max_new_tokens=8)).sequences, ref)


@pytest.mark.parametrize("name", list(ENGINE_FORMATS))
def test_quantized_logits_match_lia_tpu(quantized_models, name):
    from functools import partial

    import jax

    jcfg, trees, tcfg = quantized_models
    jt, tt, kv = trees[name]
    jt, tt = j_fuse(jcfg, jt), fuse_projections(tcfg, tt)
    tokens_np, mask_np = pack_prompts(PROMPTS, pad_id=1)
    B = tokens_np.shape[0]
    q = kv == "int8"
    jc = jkvc.init_cache(jcfg, B, 64, jnp.float32, quantized=q)
    tc = kvc.init_cache(tcfg, B, 64, torch.float32, quantized=q)
    jl, jc = jax.jit(partial(JT.prefill, jcfg))(jt, jnp.asarray(tokens_np), jnp.asarray(mask_np), jc)
    tl, tc = T.prefill(tcfg, tt, torch.from_numpy(tokens_np), torch.from_numpy(mask_np), tc)
    assert tl.shape == (B, tcfg.vocab_size)
    tol = LOGIT_TOL[name] * float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    pos = mask_np.sum(1).astype(np.int32)
    jdecode = jax.jit(partial(JT.decode_step, jcfg))
    for i, tok in enumerate(np.random.default_rng(0).integers(2, tcfg.vocab_size, (3, B)).astype(np.int32)):
        jl, jc = jdecode(jt, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None] + i), jc)
        tl, tc = T.decode_step(tcfg, tt, torch.from_numpy(tok[:, None]), torch.from_numpy(pos[:, None] + i), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)


def test_wrappers_count_no_launch_on_the_cpu(rng):
    cm.reset_launch_counts()
    t, _ = _records(rng, 64, 32, "int4", 16, "dynamic")
    quant.quantized_matmul(torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)), t)
    assert cm.launch_counts() == {"w4a8_matmul": 0, "woq_matmul": 0, "woq4z_matmul": 0}
