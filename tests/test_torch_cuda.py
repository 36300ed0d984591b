"""The port's CUDA kernels on the card, against their plain PyTorch versions,
and the model on the card against the CPU.

These tests need a CUDA device and skip elsewhere. They import nothing of JAX
(the machine with the card has none), so run them there without the test
suite's conftest, which configures JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.quant import quantize_kv

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("N,Nkv,D", [(8, 8, 64), (8, 2, 128), (12, 4, 64), (16, 2, 128), (6, 6, 128)])
def test_flash_prefill_kernel_matches_plain(cuda, N, Nkv, D, window):
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, S, dtype = 3, 80, torch.bfloat16
    q, k, v = _randn(gen, B, S, N, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    mask[1, :7] = False
    mask[2, :70] = False
    before = ca.flash_attention_prefill.launches
    out = ca.flash_attention_prefill(q, k, v, mask, window=window)
    assert ca.flash_attention_prefill.launches == before + 1
    ref = ca.flash_attention_prefill_plain(q, k, v, mask, window=window)
    valid = mask[:, :, None, None]
    torch.testing.assert_close((out.float() * valid), (ref.float() * valid), rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 128), (2, 64), (8, 64)])
def test_decode_kernels_match_plain(cuda, dtype, int8, G, D):
    gen = torch.Generator(device=cuda).manual_seed(1)
    L, B, Nkv, S_max, past = 2, 3, 4, 128, 77
    N = Nkv * G
    q = _randn(gen, B, 1, N, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    for b, p in enumerate((0, 9, 76)):
        sm[b, p:past] = True
    length = torch.tensor(past, dtype=torch.int32, device=cuda)
    if int8:
        kc = quantize_kv(_randn(gen, L, B, Nkv, S_max, D, dtype=torch.float32))
        vc = quantize_kv(_randn(gen, L, B, Nkv, S_max, D, dtype=torch.float32))
        args = (q, kf, vf, kc.q, kc.s, vc.q, vc.s, 1, sm, length)
        out, ref = ca.decode_attention_fresh_int8(*args), ca.decode_attention_fresh_int8_plain(*args)
    else:
        kc, vc = _randn(gen, L, B, Nkv, S_max, D, dtype=dtype), _randn(gen, L, B, Nkv, S_max, D, dtype=dtype)
        args = (q, kf, vf, kc, vc, 1, sm, length)
        out, ref = ca.decode_attention_fresh(*args), ca.decode_attention_fresh_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_cuda_tensors_never_take_the_plain_version(cuda):
    """A shape the kernel does not take raises; it does not fall back."""
    q = torch.zeros(1, 16, 2, 16, device=cuda, dtype=torch.bfloat16)  # D=16: no kernel
    k = torch.zeros(1, 2, 16, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ca.flash_attention_prefill(q, k, k, torch.ones(1, 16, dtype=torch.bool, device=cuda))
    q, k = torch.zeros(1, 16, 2, 64, device=cuda), torch.zeros(1, 2, 16, 64, device=cuda)
    for dt in (torch.float32, torch.float16):  # the prefill kernel is bf16 only
        with pytest.raises(TypeError):
            ca.flash_attention_prefill(q.to(dt), k.to(dt), k.to(dt), torch.ones(1, 16, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_model_on_the_card_matches_the_cpu(cuda, kv):
    """opt-125m widths at 2 layers: the card (bf16, kernels) against the CPU
    (fp32, plain versions), prefill and 4 decode steps; the tolerance is the
    bf16 model's rounding."""
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    cfg = get_config("opt-125m").replace(num_layers=2)
    params = init_dummy_params(cfg, seed=0, scale=0.02)
    cfg32 = cfg.replace(dtype="float32")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 32)).astype(np.int32))
    mask = torch.ones(2, 32, dtype=torch.bool)
    mask[1, :10] = False
    steps = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 2, 1)).astype(np.int32))
    ca.reset_launch_counts()

    def run(device, c, dtype):
        p = to_device(params, device, dtype)
        cache = kvc.init_cache(c, 2, 64, dtype, quantized=kv == "int8", device=device)
        logits, cache = T.prefill(c, p, tokens.to(device), mask.to(device), cache)
        out = [logits.cpu()]
        pos = mask.to(device).to(torch.int32).sum(1, keepdim=True)
        for i, t in enumerate(steps):
            logits, cache = T.decode_step(c, p, t.to(device), pos + i, cache)
            out.append(logits.cpu())
        return torch.stack(out)

    gpu, cpu = run(cuda, cfg, torch.bfloat16), run("cpu", cfg32, torch.float32)
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=5e-2)
    counts = ca.launch_counts()
    assert counts["flash_attention_prefill"] == 2
    assert counts["decode_attention_fresh_int8" if kv == "int8" else "decode_attention_fresh"] == 8


# ---------------------------------------------------------------------------
# quantized matmuls
# ---------------------------------------------------------------------------

MM_TOL = 1e-4  # relative to the largest |output|: fp32 sums in another order


def _rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _mm_inputs(gen, M, K, N, gs):
    from lia_tpu_torch.ops.quant import quantize_act

    ng = 1 if gs < 0 else K // gs
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    xq, sx = quantize_act(x)
    packed = torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
    i8 = torch.randint(-128, 128, (K, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    s = torch.rand(ng, N, generator=gen, device="cuda") * 0.01 + 0.001
    z = torch.randint(0, 16, (ng, N), generator=gen, device="cuda").float()
    return x, xq, sx, packed, i8, s, z


MM_SHAPES = [(16, 256, 96, 32), (3, 128, 64, -1), (40, 512, 200, 64), (16, 1024, 4100, 128), (130, 256, 40, 16)]


@pytest.mark.parametrize("M,K,N,gs", MM_SHAPES)
def test_w4a8_kernel_matches_plain(cuda, M, K, N, gs):
    gen = torch.Generator(device=cuda).manual_seed(2)
    _, xq, sx, packed, _, s, z = _mm_inputs(gen, M, K, N, gs)
    from lia_tpu_torch.ops import cuda_matmul as cm

    for zz in (None, z):
        before = cm.w4a8_matmul.launches
        out = cm.w4a8_matmul(xq, sx, packed, s, zz)
        assert cm.w4a8_matmul.launches == before + 1
        assert _rel_err(out, cm.w4a8_matmul_plain(xq, sx, packed, s, zz)) <= MM_TOL


@pytest.mark.parametrize("kind", ["int8", "int4", "nf4", "int4z"])
@pytest.mark.parametrize("M,K,N,gs", MM_SHAPES)
def test_woq_kernels_match_plain(cuda, kind, M, K, N, gs):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, _, _, packed, i8, s, z = _mm_inputs(gen, M, K, N, gs)
    from lia_tpu_torch.ops import cuda_matmul as cm

    if kind == "int4z":
        out, ref = cm.woq4z_matmul(x, packed, s, z), cm.woq4z_matmul_plain(x, packed, s, z)
    else:
        q = i8 if kind == "int8" else packed
        out, ref = cm.woq_matmul(x, q, s, kind), cm.woq_matmul_plain(x, q, s, kind)
    assert _rel_err(out, ref) <= MM_TOL


def test_quantized_matmul_wrappers_raise_on_the_card(cuda):
    """What the kernels do not take raises on a CUDA tensor; nothing falls back."""
    from lia_tpu_torch.ops import cuda_matmul as cm

    gen = torch.Generator(device=cuda).manual_seed(4)
    x, xq, sx, packed, i8, s, z = _mm_inputs(gen, 16, 256, 64, 32)
    with pytest.raises(TypeError):  # the weight-only kernel takes bf16 activations
        cm.woq_matmul(x.float(), packed, s, "int4")
    with pytest.raises(ValueError):  # K/2 = 24 rows: no kernel
        cm.woq_matmul(x[:, :48].contiguous(), packed[:24], s[:6], "int4")
    with pytest.raises(ValueError):  # three groups cannot split over the packed halves
        cm.w4a8_matmul(xq[:, :96].contiguous(), sx, packed[:48], s[:3])
    with pytest.raises(ValueError):  # not contiguous
        cm.woq_matmul(x, i8.t().contiguous().t(), s[:1], "int8")


@pytest.mark.parametrize("fmt", ["int8dyn+int8kv", "w4a8+int8kv", "woq-int4-g128", "woq-nf4-g128"])
def test_quantized_model_on_the_card_matches_the_cpu(cuda, fmt):
    """opt-125m widths at 2 layers, one quantized tree: the card (bf16, kernels)
    against the CPU (fp32, plain versions), prefill and 4 decode steps."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.quant import quantize_params
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    qkw, kv = {
        "int8dyn+int8kv": (dict(weight_dtype="int8", group_size=-1, act_quant="dynamic"), "int8"),
        "w4a8+int8kv": (dict(weight_dtype="int4", group_size=128, act_quant="dynamic"), "int8"),
        "woq-int4-g128": (dict(weight_dtype="int4", group_size=128), "none"),
        "woq-nf4-g128": (dict(weight_dtype="nf4", group_size=128), "none"),
    }[fmt]
    cfg = get_config("opt-125m").replace(num_layers=2)
    cfg32 = cfg.replace(dtype="float32")
    params = quantize_params(cfg32, init_dummy_params(cfg32, seed=0, scale=0.02), QuantConfig(**qkw))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 32)).astype(np.int32))
    mask = torch.ones(2, 32, dtype=torch.bool)
    mask[1, :10] = False
    steps = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 2, 1)).astype(np.int32))
    cm.reset_launch_counts()

    def run(device, c, dtype):
        p = to_device(params, device, dtype)
        cache = kvc.init_cache(c, 2, 64, dtype, quantized=kv == "int8", device=device)
        logits, cache = T.prefill(c, p, tokens.to(device), mask.to(device), cache)
        out = [logits.cpu()]
        pos = mask.to(device).to(torch.int32).sum(1, keepdim=True)
        for i, t in enumerate(steps):
            logits, cache = T.decode_step(c, p, t.to(device), pos + i, cache)
            out.append(logits.cpu())
        return torch.stack(out)

    gpu, cpu = run(cuda, cfg, torch.bfloat16), run("cpu", cfg32, torch.float32)
    # int8 activations: bf16 and fp32 activations can round to neighbouring
    # codes, which moves the logits more than bf16 rounding alone
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=0.15 if "8kv" in fmt else 5e-2)
    expected = {"w4a8_matmul": 0, "woq_matmul": 0, "woq4z_matmul": 0}
    if fmt != "int8dyn+int8kv":  # int8 activations x int8 weights go to torch._int_mm
        # unfused q/k/v: six linears per layer, two layers, the head; 5 forwards
        expected["w4a8_matmul" if fmt == "w4a8+int8kv" else "woq_matmul"] = (6 * 2 + 1) * 5
    assert cm.launch_counts() == expected


# ---------------------------------------------------------------------------
# write-then-attend decode and the tiered scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_attention_kernel_matches_plain(cuda, dtype, G, D):
    """decode_attention over one plane (the token written, length counting it)
    and its stacked entry at a layer offset, against their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    L, B, Nkv, S_max, length = 3, 3, 2, 128, 78
    N = Nkv * G
    q = _randn(gen, B, 1, N, D, dtype=dtype)
    kc, vc = _randn(gen, L, B, Nkv, S_max, D, dtype=dtype), _randn(gen, L, B, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    for b, p in enumerate((0, 9, 77)):
        sm[b, p:length] = True
    ln = torch.tensor(length, dtype=torch.int32, device=cuda)
    before = (ca.decode_attention.launches, ca.decode_attention_stacked.launches)
    out = ca.decode_attention(q, kc[1].contiguous(), vc[1].contiguous(), sm, ln)
    ref = ca.decode_attention_plain(q, kc[1], vc[1], sm, ln)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    out2 = ca.decode_attention_stacked(q, kc, vc, 1, sm, ln)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    assert (ca.decode_attention.launches, ca.decode_attention_stacked.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("overlap", [True, False])
def test_weight_manager_ring_on_the_card(cuda, overlap):
    """The ring on the card: every streamed layer (prefetched on the copy
    stream, ring - 1 ahead, as the scheduler does) is bit-equal to the host
    tree's layer in the card's layout, column-major int8 codes included, and
    the packed host buffers are pinned."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops.quant import quantize_params
    from lia_tpu_torch.runtime.weight_manager import TieredWeightManager, slice_layer, tree_tensors
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_host

    cfg = get_config("opt-125m").replace(num_layers=6)
    qc = QuantConfig(weight_dtype="int8", group_size=-1, act_quant="dynamic")
    layers = to_host(quantize_params(cfg, init_dummy_params(cfg, seed=2), qc)["layers"], cuda)
    wm = TieredWeightManager(layers, 6, hbm_percentage=34, overlap=overlap, device=cuda)
    assert wm.n_resident == 2 and all(b.is_pinned() for b in wm._packed)
    wm.prefetch(2)
    for idx in range(2, 6):
        wm.prefetch_after(idx)
        got = wm.get_layer(idx)
        for a, b in zip(tree_tensors(got), tree_tensors(slice_layer(layers, idx))):
            assert a.is_cuda and a.stride() == b.stride()
            assert torch.equal(a.cpu(), b)
        torch.cuda.current_stream().synchronize()
    stats = wm.copy_stats()
    assert stats["copies"] == 4 and stats["copy_ms"] > 0
    wm.close()


@pytest.mark.parametrize("policies", [(3, 3), (0, 0), (0, 2), (1, 1)])
def test_tiered_engine_on_the_card_matches_the_cpu(cuda, policies):
    """opt-125m widths at 4 layers, half resident: the tiered scheduler on the
    card (bf16, kernels, streamed weights) against the CPU (fp32), prefill and
    4 decode steps."""
    from lia_tpu_torch.config import RuntimeConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.runtime.scheduler import StreamingScheduler
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    cfg = get_config("opt-125m").replace(num_layers=4)
    params = init_dummy_params(cfg, seed=0, scale=0.02)
    rt = RuntimeConfig(hbm_percentage=50, prefill_policy=policies[0], decode_policy=policies[1])
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab_size, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), bool)
    mask[1, :10] = False
    steps = rng.integers(2, cfg.vocab_size, (4, 2)).astype(np.int32)

    def run(device, c, dtype):
        sched = StreamingScheduler(c, rt, to_device(params, "cpu", dtype), device)
        logits, state = sched.prefill_pass(tokens, mask, 64)
        out = [logits.cpu()]
        pos = mask.sum(1).astype(np.int32)
        for i, t in enumerate(steps):
            logits, state = sched.decode_pass(torch.from_numpy(t).to(device), torch.from_numpy(pos + i).to(device),
                                              state)
            out.append(logits.cpu())
        return torch.stack(out)

    ca.reset_launch_counts()
    gpu = run(cuda, cfg, torch.bfloat16)
    counts = ca.launch_counts()
    cpu = run("cpu", cfg.replace(dtype="float32"), torch.float32)
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=5e-2)
    card = policies[1] in (0, 3)
    assert counts["decode_attention"] == (2 * 4 if card else 0)
    assert counts["decode_attention_fresh"] == 2 * 4
