"""The port's GPTQ algorithm against the JAX package on the CPU, in fp32 and
float64, on the same numpy inputs.

``gptq_quantize_matrix`` at 4 and 8 bits, per channel and g 32, with and
without act-order, with an identity Hessian (plain round to nearest) and a
dead channel: the same codes, scales and zeros as lia_tpu's numpy solver,
bit for bit (no difference was found, so none is allowed). The shared solve
of the weights that read one Hessian equals solving each alone. A layer's
four Hessians equal lia_tpu's within 1e-6 of their largest entry (fp32
Gram matrices of activations that XLA and torch round ~1e-7 apart).

End to end (``gptq_quantize_params`` over opt-tiny and llama-tiny, 4 x 64
calibration tokens): the two packages' fp32 Gram matrices round ~2e-7
apart, and the solve amplifies that through H⁻¹ into codes a step or more
apart. So lia_tpu's Hessians are handed to the port's solver, and every
record must then equal lia_tpu's bit for bit, with equal fp32 greedy
tokens. The port's own Hessians must lie within 1e-6 of lia_tpu's (6e-7
measured) at every layer where both packages run the quantized layers
through the same matmul: on the CPU the reference rounds a quantized
weight to bf16, as the port does where its kernel does not take the shape
(4 bits in groups of 8). Where the port's kernel sums the exact codes in
fp32 (8 bits per channel), the later layers' Hessians lie ~1e-3 apart, so
only layer 0's are held there.
"""

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import gptq as jgptq
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import gptq
from lia_tpu_torch.utils.checkpoint import params_from_jax

PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 4, 90], [100, 200, 300, 17]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the many small CPU ops here run faster without a
    pool contending with XLA's threads in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _correlated_hessian(K: int, n: int, rng) -> np.ndarray:
    """XᵀX of correlated features with a few outlier channels."""
    base = rng.standard_normal((n, K // 4))
    X = np.repeat(base, 4, axis=1) + 0.3 * rng.standard_normal((n, K))
    X *= 1.0 + 3.0 * (rng.random(K) < 0.05)
    return X.T @ X


def _assert_solves_equal(got, ref):
    codes, s, z = got
    assert codes.dtype == torch.float64 and s.dtype == z.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), ref[0])
    np.testing.assert_array_equal(s.numpy(), ref[1])
    np.testing.assert_array_equal(z.numpy(), ref[2])


@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("group_size", [-1, 32])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_matrix_equals_lia_tpu(bits, group_size, actorder):
    rng = np.random.default_rng(bits * 10 + group_size)
    K, N = 128, 48
    w = rng.standard_normal((K, N)).astype(np.float32)
    H = _correlated_hessian(K, 256, rng)
    kw = dict(bits=bits, group_size=group_size, actorder=actorder)
    _assert_solves_equal(gptq.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(H), **kw),
                         jgptq.gptq_quantize_matrix(w, H, **kw))


@pytest.mark.parametrize("case", ["identity", "dead channel"])
def test_quantize_matrix_edges_equal_lia_tpu(case):
    """H = I degenerates to round to nearest; a dead channel (zero Hessian
    diagonal) is zeroed and its codes are the grid's zero."""
    rng = np.random.default_rng(5)
    K, N = 64, 32
    w = rng.standard_normal((K, N)).astype(np.float32)
    if case == "identity":
        H = np.eye(K)
    else:
        H = _correlated_hessian(K, 128, rng)
        H[9, :] = H[:, 9] = 0.0
    for bits in (4, 8):
        ref = jgptq.gptq_quantize_matrix(w, H, bits=bits, group_size=16)
        _assert_solves_equal(gptq.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(H), bits=bits,
                                                       group_size=16), ref)
        if case == "identity" and bits == 4:
            g = np.arange(K) // 16
            np.testing.assert_array_equal(ref[0], np.clip(np.rint(w / ref[1][g]) + ref[2][g], 0, 15))
        if case == "dead channel":
            assert (ref[0][9] == (ref[2][9 // 16] if bits == 4 else 0)).all()


@pytest.mark.parametrize("bits,actorder", [(4, False), (8, False), (4, True)])
def test_shared_hessian_solve_equals_per_weight_solves(bits, actorder):
    """The walk treats each output column on its own: wq | wk | wv solved as
    one [K, ΣN] matrix give each weight's own codes, scales and zeros."""
    rng = np.random.default_rng(11)
    K = 64
    H = torch.from_numpy(_correlated_hessian(K, 256, rng))
    ws = [torch.from_numpy(rng.standard_normal((K, n)).astype(np.float32)) for n in (32, 16, 16)]
    joint = gptq.gptq_quantize_matrix(torch.cat(ws, dim=1), H, bits=bits, group_size=16, actorder=actorder)
    col = 0
    for w in ws:
        alone = gptq.gptq_quantize_matrix(w, H, bits=bits, group_size=16, actorder=actorder)
        part = slice(col, col + w.shape[1])
        col += w.shape[1]
        for a, b in zip(alone, joint):
            np.testing.assert_array_equal(b[:, part].numpy(), a.numpy())


def _trees(name):
    jcfg = j_get_config(name).replace(dtype="float32")
    cfg = get_config(name).replace(dtype="float32")
    jp = j_init(jcfg, seed=0)
    return jcfg, cfg, jp, params_from_jax(jp)


def _calib(cfg):
    rng = np.random.default_rng(0)
    return [list(rng.integers(10, min(cfg.vocab_size - 10, 30000), size=64)) for _ in range(4)]


_JFLOWS = {}


def _lia_tpu_flow(name, bits, actorder):
    """Both packages' trees of ``name``, lia_tpu's GPTQ tree over them (4 bits
    in groups of 8, or 8 bits per channel) and the Hessian it handed each
    solve (one a weight: wq, wk, wv, wo, w1[, wg], w2 per layer), made once a
    module."""
    key = (name, bits, actorder)
    if key not in _JFLOWS:
        jcfg, cfg, jp, tp = _trees(name)
        seen = []
        jsolve = jgptq.gptq_quantize_matrix
        jgptq.gptq_quantize_matrix = lambda w, H, **k: seen.append(np.array(H)) or jsolve(w, H, **k)
        try:
            jq = jgptq.gptq_quantize_params(jcfg, jp, _calib(cfg), bits=bits, group_size=8 if bits == 4 else -1,
                                            actorder=actorder)
        finally:
            jgptq.gptq_quantize_matrix = jsolve
        per_layer = len(seen) // cfg.num_layers
        # the port solves one matrix a Hessian: q/k/v, wo, w1[/wg], w2
        hessians = [seen[l * per_layer + i] for l in range(cfg.num_layers) for i in (0, 3, 4, per_layer - 1)]
        _JFLOWS[key] = dict(jcfg=jcfg, cfg=cfg, tp=tp, jq=jq, hessians=hessians)
    return _JFLOWS[key]


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny"])
def test_layer_hessians_equal_lia_tpu(name, monkeypatch):
    """The first layer's four Hessians (q/k/v, wo, MLP and w2 inputs), as each
    package hands them to its solver."""
    flow = _lia_tpu_flow(name, 4, name == "llama-tiny")
    seen = []
    tsolve = gptq.gptq_quantize_matrix
    monkeypatch.setattr(gptq, "gptq_quantize_matrix", lambda w, H, **k: seen.append(H.numpy().copy()) or tsolve(w, H, **k))
    gptq.gptq_quantize_params(flow["cfg"].replace(num_layers=1), flow["tp"], _calib(flow["cfg"]), bits=4, group_size=16)
    assert len(seen) == 4
    for H, ref in zip(seen, flow["hessians"][:4]):
        assert H.shape == ref.shape and H.dtype == np.float64
        assert np.abs(H - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("name,bits,actorder", [("opt-tiny", 4, False), ("opt-tiny", 8, False),
                                                ("llama-tiny", 4, True)])
def test_gptq_params_end_to_end_against_lia_tpu(name, bits, actorder, monkeypatch):
    """The whole flow, with lia_tpu's Hessians handed to the port's solver:
    every record equal bit for bit, then the same fp32 tokens; the port's
    own Hessians within 1e-6 of lia_tpu's at every layer where both
    packages run the quantized layers through the same matmul (4 bits in
    groups of 8: both dequantize the weight to bf16), at layer 0 otherwise
    (8 bits per channel: the port's kernel sums the exact codes in fp32)."""
    flow = _lia_tpu_flow(name, bits, actorder)
    jcfg, cfg, jq, ref_h = flow["jcfg"], flow["cfg"], flow["jq"], flow["hessians"]
    own_err = []
    tsolve = gptq.gptq_quantize_matrix

    def solve(w, H, **k):
        ref = ref_h[len(own_err)]
        own_err.append(np.abs(H.numpy() - ref).max() / np.abs(ref).max())
        return tsolve(w, torch.from_numpy(ref), **k)

    monkeypatch.setattr(gptq, "gptq_quantize_matrix", solve)
    q = gptq.gptq_quantize_params(cfg, flow["tp"], _calib(cfg), bits=bits, group_size=8 if bits == 4 else -1,
                                  actorder=actorder)
    assert len(own_err) == len(ref_h)
    assert max(own_err[: 4 if bits == 8 else None]) <= 1e-6, own_err
    for grp, ws in jq["layers"].items():
        for k, rec in ws.items():
            got = q["layers"][grp][k]
            if not hasattr(rec, "fmt"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(rec))
                continue
            assert got.fmt == rec.fmt == ("woq_int4z" if bits == 4 else "woq_int8"), (grp, k)
            assert got.q.dtype == (torch.uint8 if bits == 4 else torch.int8)
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(rec.q), err_msg=f"{grp}.{k}")
            np.testing.assert_array_equal(got.s.numpy(), np.asarray(rec.s), err_msg=f"{grp}.{k}")
            if bits == 4:
                np.testing.assert_array_equal(got.z.numpy(), np.asarray(rec.z), err_msg=f"{grp}.{k}")
            else:
                assert got.z is None and rec.z is None
    ref = JEngine(jcfg, jq).generate(PROMPTS, JGen(max_new_tokens=6)).sequences
    out = InferenceEngine(cfg, q, device="cpu").generate(PROMPTS, GenerationConfig(max_new_tokens=6)).sequences
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_gptq_refuses_moe_and_odd_bits():
    cfg = get_config("opt-tiny").replace(dtype="float32")
    with pytest.raises(ValueError, match="bit-width"):
        gptq.gptq_quantize_params(cfg, {}, [[1, 2]], bits=3)
    with pytest.raises(NotImplementedError, match="MoE"):
        gptq.gptq_quantize_params(get_config("mixtral-8x7b"), {}, [[1, 2]])
