"""The port's tiered weight streaming (lia_tpu_torch.runtime) against the JAX
package on the CPU, in fp32.

Mirrors tests/test_streaming.py: tiered residency, no-overlap, minibatch
prefill and the in-flight window must give exactly lia_tpu's tokens under the
same RuntimeConfig, with the reference's numpy-seeded parameters carried across
(params_from_jax). On the CPU the manager's ring runs with plain copies and
the kernels' plain versions attend; the card runs the same code with pinned
buffers, a copy stream and the CUDA kernels (tests/test_torch_cuda.py).
"""

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
from lia_tpu.ops import attention as jatt
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops.quant import quantize_params as j_quantize_params
from lia_tpu.runtime.weight_manager import TieredWeightManager as JManager
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine, pack_prompts
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.ops.quant import QuantizedWeight
from lia_tpu_torch.runtime.weight_manager import TieredWeightManager, slice_layer
from lia_tpu_torch.utils.checkpoint import params_from_jax, to_host

PROMPTS = [[5, 9, 23, 41], [100, 7, 3], [8, 8, 8, 8, 8], [50, 60]]
NEW = 6


@pytest.fixture(scope="module")
def model():
    """opt-tiny at 4 layers in fp32 (scale raised so greedy margins are wide),
    as (jax cfg, jax params, port cfg, port params)."""
    jcfg = j_get_config("opt-tiny").replace(num_layers=4, dtype="float32")
    jp = j_init(jcfg, seed=7, scale=0.05)
    return jcfg, jp, get_config("opt-tiny").replace(num_layers=4, dtype="float32"), params_from_jax(jp)


def _runtimes(**kw):
    q = kw.pop("kv", "none")
    return (JRuntime(quant=JQuant(kv_cache_dtype=q), **kw),
            RuntimeConfig(quant=QuantConfig(kv_cache_dtype=q), **kw))


def _check_tokens(model, n=NEW, **kw):
    """Tokens of the port's tiered engine equal lia_tpu's under the same
    RuntimeConfig; returns the two engines."""
    jcfg, jp, tcfg, tp = model
    jrt, trt = _runtimes(**kw)
    jeng, teng = JEngine(jcfg, jp, jrt), InferenceEngine(tcfg, tp, trt, device="cpu")
    assert teng.scheduler is not None
    ref = jeng.generate(PROMPTS, JGen(max_new_tokens=n)).sequences
    out = teng.generate(PROMPTS, GenerationConfig(max_new_tokens=n)).sequences
    np.testing.assert_array_equal(out, ref)
    return jeng, teng


def _check_first_logits(jeng, teng, max_len=64):
    """Prefill logits and the first decode step's logits within 1e-4."""
    tokens, mask = pack_prompts(PROMPTS, 1)
    jl, jstate = jeng.scheduler.prefill_pass(tokens, mask, max_len)
    tl, tstate = teng.scheduler.prefill_pass(tokens, mask, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    pos = mask.sum(1).astype(np.int32)
    jl2, _ = jeng.scheduler.decode_pass(jnp.asarray(tok), jnp.asarray(pos), jstate)
    tl2, _ = teng.scheduler.decode_pass(torch.from_numpy(tok), torch.from_numpy(pos), tstate)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hbm_pct", [0, 50, 100])
def test_streaming_matches_lia_tpu(model, hbm_pct):
    jeng, teng = _check_tokens(model, hbm_percentage=hbm_pct, stream_weights=True)
    assert teng.scheduler.wm.n_resident == jeng.scheduler.wm.n_resident
    _check_first_logits(jeng, teng)


def test_streaming_matches_resident_engine(model):
    """Tiered and resident generation agree in fp32 (the two decode-context
    conventions meet here: past-only for the resident prefix, inclusive for the
    streamed layers)."""
    _, _, tcfg, tp = model
    ref = InferenceEngine(tcfg, tp, device="cpu").generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences
    out = InferenceEngine(tcfg, tp, RuntimeConfig(hbm_percentage=50), device="cpu").generate(
        PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences
    np.testing.assert_array_equal(out, ref)


def test_streaming_no_overlap_matches(model):
    _check_tokens(model, hbm_percentage=25, stream_weights=True, overlap=False)


def test_minibatch_prefill_matches(model):
    jeng, teng = _check_tokens(model, hbm_percentage=50, stream_weights=True, num_minibatch=2)
    _check_first_logits(jeng, teng)


@pytest.mark.parametrize("window", [1, 3])
def test_inflight_window_matches(model, window):
    """max_inflight_layers sets the device ring's depth (at least 2) and so how
    many layers are in flight ahead of the one computing; it never changes the
    tokens."""
    _, teng = _check_tokens(model, hbm_percentage=25, stream_weights=True, max_inflight_layers=window)
    assert teng.scheduler.wm.memory_report()["ring_bytes"] == max(2, window) * teng.scheduler.wm.layer_bytes


@pytest.mark.parametrize("ring", [2, 3])
def test_prefetch_after_keeps_ring_minus_one_in_flight(ring):
    """Before layer idx is taken, prefetch_after(idx) has the ring - 1 layers
    after it in flight (fewer near the end), each in a slot that no layer in
    flight holds."""
    cfg = j_get_config("opt-tiny").replace(num_layers=6)
    wm = TieredWeightManager(params_from_jax(j_init(cfg, seed=1))["layers"], 6, hbm_percentage=0, device="cpu",
                             ring=ring)
    wm.prefetch(0)
    for idx in range(6):
        wm.prefetch_after(idx)
        assert sorted(wm._inflight) == list(range(idx, min(6, idx + ring)))
        assert len({slot for slot, _ in wm._inflight.values()}) == len(wm._inflight)
        wm.get_layer(idx)
    wm.close()


def test_all_host_plans_build_no_ring(model):
    """Policy 1 in both phases runs every streamed layer on the host over
    views of the packed buffers: no device ring is built, and the host views
    are bit-equal to the given tree's layers."""
    _, teng = _check_tokens(model, hbm_percentage=50, prefill_policy=1, decode_policy=1)
    wm = teng.scheduler.wm
    assert wm.memory_report()["ring_bytes"] == 0 and wm._ring == []
    fused = fuse_projections(model[2], model[3])["layers"]
    for idx in range(wm.n_resident, 4):
        _tree_equal(wm.host_layer(idx), slice_layer(fused, idx))
    with pytest.raises(RuntimeError, match="no ring"):
        wm.get_layer(wm.n_resident)


@pytest.mark.parametrize("hbm_pct", [0, 50])
def test_int8_kv_streaming_matches(model, hbm_pct):
    jeng, teng = _check_tokens(model, hbm_percentage=hbm_pct, stream_weights=True, kv="int8")
    _check_first_logits(jeng, teng, max_len=128)


@pytest.mark.parametrize("fmt", ["woq-int4-g128", "int8dyn"])
def test_quantized_tree_streams_identically(fmt):
    """A quantized tree (lia_tpu's quantize_params, carried across) streams with
    its records packed and unpacked bit for bit: tokens equal lia_tpu's."""
    jcfg = j_get_config("opt-125m").replace(num_layers=2, dtype="float32", vocab_size=512)
    qkw = (dict(weight_dtype="int4", group_size=128) if fmt == "woq-int4-g128"
           else dict(weight_dtype="int8", group_size=-1, act_quant="dynamic"))
    jp = j_quantize_params(jcfg, j_init(jcfg, seed=3, scale=0.05), JQuant(**qkw))
    model = (jcfg, jp, get_config("opt-125m").replace(num_layers=2, dtype="float32", vocab_size=512),
             params_from_jax(jp))
    _check_tokens(model, n=4, hbm_percentage=50, stream_weights=True)


def test_weight_manager_report_matches_lia_tpu():
    cfg = j_get_config("opt-tiny")
    jp = j_init(cfg, seed=0)
    jwm = JManager(jp["layers"], cfg.num_layers, hbm_percentage=50)
    twm = TieredWeightManager(params_from_jax(jp)["layers"], cfg.num_layers, hbm_percentage=50, device="cpu")
    jrep, trep = jwm.memory_report(), twm.memory_report()
    jwm.close()
    for key, value in jrep.items():
        assert trep[key] == pytest.approx(value), key
    assert trep["streamed_layer_bytes"] >= trep["layer_bytes_total"] / cfg.num_layers
    assert trep["streamed_layer_bytes"] % 256 == 0


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, QuantizedWeight):
        assert a.fmt == b.fmt
        for x, y in zip((a.q, a.s, a.z), (b.q, b.s, b.z)):
            assert (x is None) == (y is None)
            if x is not None:
                _tree_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride()
        assert torch.equal(a, b)


def test_streamed_layers_are_bit_equal_to_the_host_tree():
    """Every streamed layer handed out (through the ring, prefetched or not) is
    bit-equal to slice_layer of the host tree, strides included: a quantized
    tree with int8 × int8 codes laid column-major, as to_host lays them for the
    card, keeps that layout through the packed buffer."""
    cfg = j_get_config("opt-125m").replace(num_layers=4)
    jp = j_quantize_params(cfg, j_init(cfg, seed=7), JQuant(weight_dtype="int8", group_size=-1, act_quant="dynamic"))
    layers = params_from_jax(jp)["layers"]
    # the card's layout of the int8 x int8 codes, made on the CPU
    w = layers["attn"]["wq"]
    layers["attn"]["wq"] = w._replace(q=w.q.transpose(-1, -2).contiguous().transpose(-1, -2))
    wm = TieredWeightManager(layers, 4, hbm_percentage=25, device="cpu")
    assert wm.n_resident == 1
    _tree_equal(slice_layer(wm.resident, 0), slice_layer(layers, 0))
    wm.prefetch(1)
    wm.prefetch(2)
    for idx in (1, 2, 3):
        got = wm.get_layer(idx)
        _tree_equal(got, slice_layer(layers, idx))
        assert got["attn"]["wq"].q.stride() == (1, w.q.shape[-2])
        wm.prefetch(idx + 1)
    wm.close()


def test_ring_refuses_to_overwrite_a_layer_not_yet_taken():
    cfg = j_get_config("opt-tiny").replace(num_layers=4)
    wm = TieredWeightManager(params_from_jax(j_init(cfg, seed=1))["layers"], 4, hbm_percentage=0, device="cpu")
    wm.prefetch(0)
    wm.prefetch(1)
    with pytest.raises(RuntimeError, match="ring slot"):
        wm.prefetch(2)  # slot of layer 0, which nobody has taken yet
    wm.close()


def test_to_host_keeps_host_leaves():
    """A host tree in the device's layout is kept as it is: no copy."""
    cfg = get_config("opt-tiny")
    tree = params_from_jax(j_init(j_get_config("opt-tiny"), seed=2))
    host = to_host(tree, "cpu")
    assert host["layers"]["attn"]["wq"] is tree["layers"]["attn"]["wq"]
    assert host["embed_tokens"] is tree["embed_tokens"]
    assert cfg.num_layers == host["layers"]["attn"]["wq"].shape[0]


def test_decoder_layer_decode_matches_lia_tpu(model):
    """One write-then-attend decode layer over its own plane (A4), and the
    host tier's form of it, against lia_tpu's decoder_layer_decode."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(0)
    B, S_max, length = 3, 32, 11
    x = rng.standard_normal((B, 1, tcfg.hidden_size)).astype(np.float32)
    kc = rng.standard_normal((B, tcfg.num_kv_heads, S_max, tcfg.head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    sm = np.zeros((B, S_max), bool)
    for b, p in enumerate((0, 2, 6)):
        sm[b, p : length + 1] = True
    pos = (length - np.array([0, 2, 6]))[:, None].astype(np.int32)
    jlp = jax.tree.map(lambda a: a[2], jp["layers"])
    jctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(length + 1, jnp.int32))
    jx, jk, jv = JT.decoder_layer_decode(jcfg, jlp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                                         jnp.asarray(length, jnp.int32), jctx, jnp.asarray(pos))
    for host in (False, True):
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        tctx = att.decode_attn_ctx(torch.from_numpy(sm), torch.tensor(length + 1, dtype=torch.int32))
        tx, tk2, tv2 = T.decoder_layer_decode(tcfg, T.layer_params(tp["layers"], 2), torch.from_numpy(x), tk, tv,
                                              torch.tensor(length, dtype=torch.int32), tctx, torch.from_numpy(pos),
                                              host=host)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)  # written in place
        np.testing.assert_allclose(tv2.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_set_layer_kv_and_host_cache_match_lia_tpu(kv):
    cfg = get_config("opt-tiny").replace(num_layers=3)
    jcfg = j_get_config("opt-tiny").replace(num_layers=3)
    q = kv == "int8"
    tc = kvc.init_cache(cfg, 2, 16, torch.float32, quantized=q, device="cpu", pin_memory=False)
    jc = jkvc.init_cache(jcfg, 2, 16, jnp.float32, quantized=q)
    rng = np.random.default_rng(1)
    new = rng.standard_normal((2, cfg.num_kv_heads, 16, cfg.head_dim)).astype(np.float32)
    if q:
        from lia_tpu.ops.quant import quantize_kv as jq
        from lia_tpu_torch.ops.quant import quantize_kv as tq

        jl, tl = jq(jnp.asarray(new)), tq(torch.from_numpy(new))
    else:
        jl, tl = jnp.asarray(new), torch.from_numpy(new)
    jk = jkvc.set_layer_kv(jc.k, jl, 1)
    tk = kvc.set_layer_kv(tc.k, tl, 1)
    for a, b in zip(jax.tree.leaves(jk), (tk.q, tk.s) if q else (tk,)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # a view of the stacked plane is written through and not copied onto itself
    view = kvc.index_layer_kv(tc.k, 2)
    assert kvc.set_layer_kv(tc.k, view, 2) is tc.k
