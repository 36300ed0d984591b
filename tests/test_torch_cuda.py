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
    expected = {"w4a8_matmul": 0, "w4a8_matmul_stacked": 0, "woq_matmul": 0, "woq4z_matmul": 0}
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


# ---------------------------------------------------------------------------
# serving: chunk-over-cache and paged decode attention, the batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("per_row_base", [False, True])
@pytest.mark.parametrize("N,Nkv,D", [(8, 8, 64), (8, 2, 128), (16, 2, 128), (32, 4, 64)])
def test_flash_cached_kernel_matches_plain(cuda, N, Nkv, D, per_row_base, window):
    """A chunk of C rows over a 200-slot plane that holds it: left pads (a first
    chunk), a cached prefix with base > 0, and per-row bases."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, C, S_max, dtype = 3, 72, 200, torch.bfloat16
    bases = [0, 96, 128] if per_row_base else [96] * B
    q = _randn(gen, B, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, B, Nkv, S_max, D, dtype=dtype), _randn(gen, B, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    starts = [5, 0, 30]  # row 0 under per-row bases: 5 pad rows of a first chunk
    for b, (s, base) in enumerate(zip(starts, bases)):
        sm[b, s : base + C] = True
    base = torch.tensor(bases, dtype=torch.int32, device=cuda) if per_row_base else torch.tensor(
        bases[0], dtype=torch.int32, device=cuda)
    before = ca.flash_attention_cached.launches
    out = ca.flash_attention_cached(q, kc, vc, base, sm, window=window)
    assert ca.flash_attention_cached.launches == before + 1
    ref = ca.flash_attention_cached_plain(q, kc, vc, base, sm, window=window)
    valid = torch.zeros(B, C, 1, 1, dtype=torch.bool, device=cuda)  # rows at a valid slot
    for b, (s, bb) in enumerate(zip(starts, bases)):
        valid[b, max(s - bb, 0):] = True
    torch.testing.assert_close(out.float() * valid, ref.float() * valid, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.isfinite(out.float()).all()


def _paged_case(gen, dtype, B, C, G, D, L=2, Nkv=2, bs=16, P=8, lengths=(0, 37, 128)):
    """A shuffled pool: each sequence's pages are drawn at random from blocks
    1.., and the table's unused entries hold the null page 0."""
    nb = B * P + 1
    N = Nkv * G
    kp, vp = _randn(gen, L, nb, Nkv, bs, D, dtype=dtype), _randn(gen, L, nb, Nkv, bs, D, dtype=dtype)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(0))[: B * P] + 1
    table = torch.zeros(B, P, dtype=torch.int32)
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        table[b, :used] = perm[b * P : b * P + used].to(torch.int32)
    q = _randn(gen, B, C, N, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, C, D, dtype=dtype), _randn(gen, B, Nkv, C, D, dtype=dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.cuda(), lens, kf, vf


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 128), (8, 64), (2, 64)])
def test_paged_decode_kernel_matches_plain(cuda, G, D, dtype, C, fresh):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, kp, vp, table, lens, kf, vf = _paged_case(gen, dtype, 3, C, G, D)
    args = (q, kp, vp, 1, table, lens) + ((kf, vf) if fresh else ())
    before = ca.paged_decode_attention.launches
    out = ca.paged_decode_attention(*args)
    assert ca.paged_decode_attention.launches == before + 1
    ref = ca.paged_decode_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if not fresh:  # row 0 has no key and no fresh token
        assert (out[0] == 0).all()


def test_paged_and_cached_wrappers_raise_on_the_card(cuda):
    """What the kernels do not take raises on a CUDA tensor; nothing falls back."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, kp, vp, table, lens, kf, vf = _paged_case(gen, torch.bfloat16, 3, 1, 1, 128)
    with pytest.raises(ValueError):  # an int64 table
        ca.paged_decode_attention(q, kp, vp, 0, table.long(), lens)
    with pytest.raises(ValueError):  # layer out of range
        ca.paged_decode_attention(q, kp, vp, 2, table, lens)
    with pytest.raises(TypeError):  # the chunk kernel takes bf16 only
        ca.flash_attention_cached(q.float(), kp[0, :3].float(), vp[0, :3].float(), 0,
                                  torch.ones(3, 2, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("mode", ["paged", "paged-chunked", "slab-int8kv"])
def test_batcher_on_the_card_matches_the_cpu(cuda, mode):
    """opt-125m widths at 2 layers: the batcher on the card (bf16, kernels)
    serves the requests a CPU batcher (fp32) serves, with the same step count;
    every page comes back, and the kernels of the mode ran."""
    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    cfg = get_config("opt-125m").replace(num_layers=2)
    params = init_dummy_params(cfg, seed=0, scale=0.02)
    kw = dict(max_batch=3, max_len=128, gen=GenerationConfig(max_new_tokens=5))
    kw.update({"paged": dict(paged=True), "paged-chunked": dict(paged=True, prefill_chunk=32),
               "slab-int8kv": dict(kv_quantized=True)}[mode])
    rng = np.random.default_rng(0)
    shared = rng.integers(2, cfg.vocab_size, 40).tolist()
    prompts = [shared + [7, 8], rng.integers(2, cfg.vocab_size, 19).tolist(), shared + [9, 10, 11], [5, 6]]
    ca.reset_launch_counts()
    cb = ContinuousBatcher(cfg, params, device=cuda, **kw)
    for p in prompts:
        cb.submit(p)
    done = {r.req_id: r.output for r in cb.run()}
    counts = ca.launch_counts()
    cpu = ContinuousBatcher(cfg.replace(dtype="float32"), to_device(params, "cpu", torch.float32), device="cpu", **kw)
    for p in prompts:
        cpu.submit(p)
    ref = {r.req_id: r.output for r in cpu.run()}
    assert sorted(done) == sorted(ref) and all(len(done[i]) == 5 for i in done)
    assert cb.stats()["decode_steps"] == cpu.stats()["decode_steps"]
    steps = int(cb.stats()["decode_steps"])
    if mode == "slab-int8kv":
        assert counts["decode_attention_fresh_int8"] == 2 * steps and counts["paged_decode_attention"] == 0
    else:
        assert counts["paged_decode_attention"] == 2 * steps and counts["decode_attention_fresh"] == 0
        assert counts["flash_attention_cached"] > 0  # the shared prefix hit, or the chunks
        assert (cb.page_rc == 0).all() and len(cb.free_blocks) + len(cb.cached_pages) == cb.num_blocks - 1


# ---------------------------------------------------------------------------
# grouped-beam decode (B9 decode_beam_attention, B10 decode_beam_attention_int8)
# ---------------------------------------------------------------------------


def _beam_case(gen, dtype, int8, G, D, tlen, nb=3, B0=3, Nkv=2, S_p=64, T_max=32, L=2, plen=50):
    """Beam-kernel inputs over layer 1 of a 2-layer grouped cache: group
    prompts starting at 0, 13 and plen - 1, and ``tlen`` tail slots."""
    B, N = B0 * nb, Nkv * G
    q = _randn(gen, B, 1, N, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    pm = torch.zeros(B0, S_p, dtype=torch.bool, device="cuda")
    for g, p in enumerate((0, 13, plen - 1)):
        pm[g, p:plen] = True
    lens = (pm, torch.tensor(plen, dtype=torch.int32, device="cuda"),
            torch.tensor(tlen, dtype=torch.int32, device="cuda"), nb)

    def planes(rows, S):
        if int8:
            return [part for _ in range(2) for part in quantize_kv(_randn(gen, L, rows, Nkv, S, D, dtype=torch.float32))]
        return [_randn(gen, L, rows, Nkv, S, D, dtype=dtype) for _ in range(2)]

    prompt, tail = planes(B0, S_p), planes(B, T_max)
    if int8:
        return (q, kf, vf, *prompt, *tail, 1, *lens)
    return (q, kf, vf, prompt[0], prompt[1], tail[0], tail[1], 1, *lens)


@pytest.mark.parametrize("tlen", [0, 3, 32])
@pytest.mark.parametrize("G,D", [(1, 128), (2, 64), (4, 128), (4, 64), (8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_beam_decode_kernels_match_plain(cuda, int8, dtype, G, D, tlen):
    gen = torch.Generator(device=cuda).manual_seed(7)
    args = _beam_case(gen, dtype, int8, G, D, tlen)
    kernel, plain = ((ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain) if int8
                     else (ca.decode_beam_attention, ca.decode_beam_attention_plain))
    before = kernel.launches
    out = kernel(*args)
    assert kernel.launches == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_beam_wrappers_raise_on_the_card(cuda):
    """nb must divide the batch, and a CUDA tensor never takes the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = list(_beam_case(gen, torch.bfloat16, False, 1, 128, 3))
    with pytest.raises(ValueError, match="nb"):
        ca.decode_beam_attention(*args[:-1], 2)
    args[0] = args[0][..., :16]  # D = 16: no kernel
    with pytest.raises(ValueError):
        ca.decode_beam_attention(*args)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_grouped_beam_on_the_card_matches_the_cpu(cuda, kv):
    """opt-125m widths at 2 layers: prefill into a grouped beam cache and 4 beam
    decode steps with a fixed shuffle, the card (bf16, kernels) against the CPU
    (fp32, plain versions); then one grouped generate_beam on the card, whose
    prompt runs the prefill kernel once per layer and every step the beam kernel."""
    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    cfg = get_config("opt-125m").replace(num_layers=2)
    params = init_dummy_params(cfg, seed=0, scale=0.02)
    cfg32, nb = cfg.replace(dtype="float32"), 2
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 32)).astype(np.int32))
    mask = torch.ones(2, 32, dtype=torch.bool)
    mask[1, :10] = False
    steps = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 2 * nb, 1)).astype(np.int32))
    src = torch.tensor([1, 0, 2, 2])  # within each group

    def run(device, c, dtype):
        p = to_device(params, device, dtype)
        cache = kvc.init_cache(c, 2, 128, dtype, quantized=kv == "int8", device=device)
        logits, cache = T.prefill(c, p, tokens.to(device), mask.to(device), cache)
        cache = kvc.beam_cache_from_prefill(cache, nb, 8)
        out = [logits.cpu()]
        pos = mask.to(device).to(torch.int32).sum(1, keepdim=True).repeat_interleave(nb, 0)
        for i, t in enumerate(steps):
            logits, cache = T.beam_decode_step(c, p, t.to(device), pos + i, cache)
            cache = kvc.beam_tail_reorder(cache, src.to(device))
            out.append(logits.cpu())
        return torch.cat(out)

    ca.reset_launch_counts()
    gpu, cpu = run(cuda, cfg, torch.bfloat16), run("cpu", cfg32, torch.float32)
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=5e-2)
    beam_kernel = "decode_beam_attention_int8" if kv == "int8" else "decode_beam_attention"
    assert ca.launch_counts()[beam_kernel] == 2 * len(steps)
    eng = InferenceEngine(cfg, params, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
    ca.reset_launch_counts()
    res = eng.generate_beam([[5, 9, 23, 41], [100, 7, 3]], GenerationConfig(max_new_tokens=6, num_beams=4))
    counts = ca.launch_counts()
    assert res.sequences.shape == (2, 6) and ((res.sequences >= 0) & (res.sequences < cfg.vocab_size)).all()
    assert counts["flash_attention_prefill"] == 2 and counts[beam_kernel] == 2 * 5
    assert counts["decode_attention_fresh"] == counts["decode_attention_fresh_int8"] == 0


@pytest.mark.parametrize("quantized", [False, True])
def test_host_cache_beam_reorder_stays_pinned(cuda, quantized):
    """The expanded path's whole-cache gather over a pinned host cache (policy
    0's streamed segment) copies back into the same pinned planes, so later
    asynchronous copies stay asynchronous."""
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc

    cache = kvc.init_cache(get_config("opt-tiny"), 4, 16, torch.bfloat16, quantized=quantized, device="cpu",
                           pin_memory=True)
    gen = torch.Generator().manual_seed(9)
    parts = [p for plane in (cache.k, cache.v) for p in (plane if quantized else (plane,))]
    for p in parts:
        p.copy_(torch.randn(p.shape, generator=gen).to(p.dtype))
    cache.mask.copy_(torch.rand(cache.mask.shape, generator=gen) < 0.5)
    before = [p.clone() for p in parts] + [cache.mask.clone()]
    ptrs = [p.data_ptr() for p in parts]
    idx = torch.tensor([3, 3, 0, 1], device=cuda)
    kvc.beam_reorder(cache, idx)
    after = parts + [cache.mask]
    assert all(p.is_pinned() for p in after) and [p.data_ptr() for p in parts] == ptrs
    for b, a in zip(before, after):
        torch.testing.assert_close(a, b.index_select(0 if a.dim() == 2 else 1, idx.cpu()), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# B13 (stacked W4A8) and B14 (fused MLP)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("zp", [False, True])
@pytest.mark.parametrize("K,N", [(4096, 12288), (16384, 4096)])  # OPT-6.7B's wqkv and fc2
@pytest.mark.parametrize("M", [16, 4096])
def test_w4a8_stacked_is_b4_on_the_view(cuda, M, K, N, zp):
    """At every layer of a 3-layer stack the stacked entry gives B4's output
    on that layer's view bit for bit (the same int32 group sums, the same
    scaling), reading the layer from device memory; an index outside the
    stack reads nothing and writes NaN."""
    from lia_tpu_torch.ops import cuda_matmul as cm

    gen = torch.Generator(device=cuda).manual_seed(5)
    L, ng = 3, K // 128
    _, xq, sx, _, _, _, _ = _mm_inputs(gen, M, K, 8, 128)
    q = torch.randint(0, 256, (L, K // 2, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
    s = torch.rand(L, ng, N, generator=gen, device="cuda") * 0.01 + 0.001
    z = torch.randint(0, 16, (L, ng, N), generator=gen, device="cuda").float() if zp else None
    layers = torch.arange(L + 1, dtype=torch.int32, device=cuda)
    for li in range(L):
        before = cm.w4a8_matmul_stacked.launches
        out = cm.w4a8_matmul_stacked(xq, sx, q, s, z, layers[li])
        assert cm.w4a8_matmul_stacked.launches == before + 1
        ref = cm.w4a8_matmul(xq, sx, q[li], s[li], None if z is None else z[li])
        torch.cuda.synchronize()
        assert torch.equal(out, ref), f"layer {li}: max |diff| {(out - ref).abs().max().item()}"
    assert torch.isnan(cm.w4a8_matmul_stacked(xq, sx, q, s, z, layers[L])).all()


FUSED_MLP_CASES = [  # (label, H, F, activation, rms, biases): OPT-6.7B's arms and Llama-3-8B's
    ("opt-relu", 4096, 16384, "relu", False, True),
    ("opt-gelu", 4096, 16384, "gelu", False, True),
    ("opt-gelu_new", 4096, 16384, "gelu_new", False, True),
    ("llama3-swiglu", 4096, 14336, "silu", True, False),
]


def fused_mlp_inputs(gen, rows, H, F, act, biases, device="cuda"):
    """bf16 inputs of one MLP block at the main path's widths: weights of
    std 0.02 keep the up-projection and the sum over F of O(1)."""
    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen, device=device) * sc).to(torch.bfloat16)

    return dict(x=r(rows, H), ln_scale=(1 + r(H, sc=0.1).float()).to(torch.bfloat16),
                ln_bias=r(H, sc=0.1) if biases else None, w1=r(H, F, sc=0.02), b1=r(F, sc=0.1) if biases else None,
                wg=r(H, F, sc=0.02) if act == "silu" else None, w2=r(F, H, sc=0.02),
                b2=r(H, sc=0.1) if biases else None)


FUSED_MLP_TOL = 2e-2  # bf16 outputs of O(1): one or two bf16 steps; the kernel's
# fp32 sums run in another order (its atomics in one that varies run to run),
# which can move a rounding of the normed input or the activation by one step


@pytest.mark.parametrize("rows", [1, 16, 256])
@pytest.mark.parametrize("case", FUSED_MLP_CASES, ids=[c[0] for c in FUSED_MLP_CASES])
def test_fused_mlp_kernel_matches_plain(cuda, case, rows):
    from lia_tpu_torch.ops import cuda_mlp

    _, H, F, act, rms, biases = case
    gen = torch.Generator(device=cuda).manual_seed(rows)
    a = fused_mlp_inputs(gen, rows, H, F, act, biases)
    before = cuda_mlp.fused_mlp.launches
    out = cuda_mlp.fused_mlp(**a, activation=act, rms=rms)
    again = cuda_mlp.fused_mlp(**a, activation=act, rms=rms)
    ref = cuda_mlp.fused_mlp_plain(**a, activation=act, rms=rms)
    torch.cuda.synchronize()
    assert cuda_mlp.fused_mlp.launches == before + 2
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=FUSED_MLP_TOL, atol=FUSED_MLP_TOL)
    torch.testing.assert_close(again.float(), out.float(), rtol=FUSED_MLP_TOL, atol=FUSED_MLP_TOL)
    ws, tickets = cuda_mlp._workspace(torch.cuda.current_device(), H)
    assert not ws.any() and not tickets.any()  # left zero for the next launch


def test_fused_mlp_wrapper_raises_on_the_card(cuda):
    from lia_tpu_torch.ops import cuda_mlp

    gen = torch.Generator(device=cuda).manual_seed(0)
    a = fused_mlp_inputs(gen, 4, 256, 512, "relu", True)
    with pytest.raises(TypeError):
        cuda_mlp.fused_mlp(**{**a, "x": a["x"].float()}, activation="relu")
    with pytest.raises(ValueError):  # more rows than the kernel takes
        cuda_mlp.fused_mlp(**{**a, "x": torch.zeros(257, 256, dtype=torch.bfloat16, device=cuda)})
    with pytest.raises(ValueError):  # H % 128
        b = fused_mlp_inputs(gen, 4, 192, 512, "relu", True)
        cuda_mlp.fused_mlp(**b, activation="relu")


# ---------------------------------------------------------------------------
# B1-B3 at Llama-3-8B's heads (32 over 8 KV heads, D 128) and with a window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 64])
def test_attention_kernels_at_llama3_heads(cuda, window):
    """Prefill (B1) and decode over bf16 (B2) and int8 (B3) caches at G = 4,
    D = 128, without a window and with one of 64 that binds (prompts of up to
    256 tokens, decode past 272)."""
    from lia_tpu_torch.ops import attention as att

    gen = torch.Generator(device=cuda).manual_seed(7)
    B, N, Nkv, D, S, past = 4, 32, 8, 128, 256, 272
    bf = torch.bfloat16
    q = _randn(gen, B, S, N, D, dtype=bf)
    k, v = _randn(gen, B, Nkv, S, D, dtype=bf), _randn(gen, B, Nkv, S, D, dtype=bf)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    for b, p in enumerate((0, 7, 100, 200)):
        mask[b, :p] = False
    out = ca.flash_attention_prefill(q, k, v, mask, window=window)
    ref = ca.flash_attention_prefill_plain(q, k, v, mask, window=window)
    valid = mask[:, :, None, None]
    torch.testing.assert_close(out.float() * valid, ref.float() * valid, rtol=2e-2, atol=2e-2)
    L, S_max = 2, 320
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    for b, p in enumerate((0, 3, 100, 250)):
        sm[b, p:past] = True
    length = torch.tensor(past, dtype=torch.int32, device=cuda)
    ctx = att.decode_attn_ctx(sm, length, window)
    qd = _randn(gen, B, 1, N, D, dtype=bf)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=bf), _randn(gen, B, Nkv, 1, D, dtype=bf)
    kc, vc = _randn(gen, L, B, Nkv, S_max, D, dtype=bf), _randn(gen, L, B, Nkv, S_max, D, dtype=bf)
    args = (qd, kf, vf, kc, vc, 1, ctx.slot_mask, length)
    torch.testing.assert_close(ca.decode_attention_fresh(*args).float(), ca.decode_attention_fresh_plain(*args).float(),
                               rtol=2e-2, atol=2e-2)
    kq = quantize_kv(_randn(gen, L, B, Nkv, S_max, D, dtype=torch.float32))
    vq = quantize_kv(_randn(gen, L, B, Nkv, S_max, D, dtype=torch.float32))
    args = (qd, kf, vf, kq.q, kq.s, vq.q, vq.s, 1, ctx.slot_mask, length)
    torch.testing.assert_close(ca.decode_attention_fresh_int8(*args).float(),
                               ca.decode_attention_fresh_int8_plain(*args).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("weights", ["bf16", "w4a8"])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_llama_on_the_card_matches_the_cpu_with_both_gates(cuda, kv, weights):
    """A llama at H 512, F 1536 (G = 4, D = 128), 2 layers, unfused
    projections, both gates on: the card (bf16, kernels) against the CPU
    (fp32, plain versions), prefill and 4 decode steps. With bf16 weights the
    fused MLP runs at every decode step and the prefill of 2 x 32 rows; with
    W4A8 weights (int4 g128, int8 activations) each decode step's seven
    linears per layer run the stacked entry, its layer index read from the
    device."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops import cuda_mlp, dispatch
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.quant import quantize_params
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    cfg = get_config("llama-3-8b").replace(num_layers=2, hidden_size=512, ffn_size=1536, num_heads=4,
                                           num_kv_heads=1, vocab_size=1000, head_dim=128)
    cfg32 = cfg.replace(dtype="float32")
    params = init_dummy_params(cfg32, seed=0, scale=0.02)
    if weights == "w4a8":
        params = quantize_params(cfg32, params, QuantConfig(weight_dtype="int4", group_size=128, act_quant="dynamic"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 32)).astype(np.int32))
    mask = torch.ones(2, 32, dtype=torch.bool)
    mask[1, :10] = False
    steps = torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 2, 1)).astype(np.int32))

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

    dispatch.set_fused_mlp(True)
    dispatch.set_stacked_w4a8(True)
    try:
        fused, stacked = cuda_mlp.fused_mlp.launches, cm.w4a8_matmul_stacked.launches
        gpu = run(cuda, cfg, torch.bfloat16)
        fused, stacked = cuda_mlp.fused_mlp.launches - fused, cm.w4a8_matmul_stacked.launches - stacked
        cpu = run("cpu", cfg32, torch.float32)
    finally:
        dispatch.set_fused_mlp(False)
        dispatch.set_stacked_w4a8(False)
    assert fused == (2 * 5 if weights == "bf16" else 0)
    assert stacked == (0 if weights == "bf16" else 7 * 2 * 4)
    # int8 activations: bf16 and fp32 activations can round to neighbouring
    # codes (see test_quantized_model_on_the_card_matches_the_cpu)
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=5e-2 if weights == "bf16" else 0.15)


def test_fused_mlp_route_on_an_fp32_card_model_raises(cuda):
    """The route's rules have no type term: with the gate on, an fp32 layer on
    the card reaches the kernel, which takes bf16 and raises (a CUDA tensor
    never takes the plain version)."""
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import cuda_mlp, dispatch
    from lia_tpu_torch.utils.checkpoint import init_dummy_params, to_device

    cfg = get_config("llama-3-8b").replace(num_layers=1, hidden_size=512, ffn_size=1536, num_heads=4,
                                           num_kv_heads=1, vocab_size=1000, head_dim=128, dtype="float32")
    lp = T.layer_params(to_device(init_dummy_params(cfg, seed=0, scale=0.02), cuda, torch.float32)["layers"], 0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn(2, 1, 512, generator=gen, device=cuda)
    attn_out = torch.randn(2, 1, 4, 128, generator=gen, device=cuda)
    dispatch.set_fused_mlp(True)
    try:
        assert T._fused_mlp_viable(cfg, lp, x)
        before = cuda_mlp.fused_mlp.launches
        with pytest.raises(TypeError, match="bfloat16"):
            T.attn_post_mlp(cfg, lp, x, attn_out)
        assert cuda_mlp.fused_mlp.launches == before
    finally:
        dispatch.set_fused_mlp(False)
