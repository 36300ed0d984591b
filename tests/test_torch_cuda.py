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
@pytest.mark.parametrize("N,Nkv,D", [(8, 8, 64), (8, 2, 128), (12, 4, 64), (16, 2, 128), (6, 6, 128),
                                     (16, 4, 64), (16, 2, 64), (64, 1, 64), (64, 1, 128)])
def test_flash_prefill_kernel_matches_plain(cuda, N, Nkv, D, window):
    """G = 1, 3, 4, 8 and 64 at D 64 and 128, S = 80 (not a multiple of the
    64-key tile), a window whose edge falls inside a tile, left pads and a row
    of pads only (its output finite)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, S, dtype = 4, 80, torch.bfloat16
    q, k, v = _randn(gen, B, S, N, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    mask[1, :7] = False
    mask[2, :70] = False
    mask[3] = False
    before = ca.flash_attention_prefill.launches
    out = ca.flash_attention_prefill(q, k, v, mask, window=window)
    assert ca.flash_attention_prefill.launches == before + 1
    ref = ca.flash_attention_prefill_plain(q, k, v, mask, window=window)
    valid = mask[:, :, None, None]
    torch.testing.assert_close((out.float() * valid), (ref.float() * valid), rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
def test_decode_kernels_match_plain(cuda, monkeypatch, dtype, int8, G, D):
    """B2 (bf16 on the host's route: the plane body at G = 1, the bf16 beam
    body past it; fp32 on the warp body) and B3 over a 128-slot cache with
    left pads 0, 9 and 76."""
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


MM_SHAPES = [(16, 256, 96, 32), (3, 128, 64, -1), (40, 512, 200, 64), (16, 1024, 4100, 128), (130, 256, 40, 16),
             # the tile edges of the Hopper body: decode up to 16 rows, 128-row blocks above; 128-column
             # blocks; K split in whole groups at decode; per-channel scales; N of OPT-6.7B's head
             (1, 512, 128, 64), (17, 1024, 256, 128), (64, 256, 96, 32), (65, 512, 4100, -1),
             (128, 16384, 256, 128), (16, 16384, 512, -1), (4096, 1024, 200, 128), (16, 1024, 50304, 128)]


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


@pytest.mark.parametrize("M", [16, 256])
@pytest.mark.parametrize("entry", ["w4a8", "w4a8 zero-points", "w4a8_stacked", "woq int8", "woq int4", "woq nf4",
                                   "woq4z"])
def test_matmul_graph_replay_equals_eager(cuda, entry, M):
    """Each entry point captured once in a CUDA graph (decode with a K split,
    and prefill) and replayed on new inputs equals the eager call on them:
    scratch comes from the allocator, the split's counters are left at zero,
    and the stacked entry reads its layer from device memory at replay."""
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops.quant import quantize_act

    gen = torch.Generator(device=cuda).manual_seed(6)
    K, N = 2048, 1024
    x, xq, sx, packed, i8, s, z = _mm_inputs(gen, M, K, N, 128)
    q3, s3, z3 = torch.stack([packed, packed.flip(0)]), torch.stack([s, s.flip(0)]), torch.stack([z, z.flip(1)])
    layer = torch.tensor(0, dtype=torch.int32, device=cuda)
    fn = {
        "w4a8": lambda: cm.w4a8_matmul(xq, sx, packed, s),
        "w4a8 zero-points": lambda: cm.w4a8_matmul(xq, sx, packed, s, z),
        "w4a8_stacked": lambda: cm.w4a8_matmul_stacked(xq, sx, q3, s3, z3, layer),
        "woq int8": lambda: cm.woq_matmul(x, i8, s[:1].contiguous(), "int8"),
        "woq int4": lambda: cm.woq_matmul(x, packed, s, "int4"),
        "woq nf4": lambda: cm.woq_matmul(x, packed, s, "nf4"),
        "woq4z": lambda: cm.woq4z_matmul(x, packed, s, z),
    }[entry]
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    x2 = torch.randn(M, K, generator=gen, device=cuda).to(torch.bfloat16)
    xq2, sx2 = quantize_act(x2)
    x.copy_(x2), xq.copy_(xq2), sx.copy_(sx2), layer.fill_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn())


def _split_entries(cm, x, xq, sx, packed, i8, s, z):
    """Each kind's kernel call, its plain matmul as ``split_plain`` takes it,
    and its operands and plan format."""
    s1 = s[:1].contiguous()
    return {
        "w4a8": (lambda: cm.w4a8_matmul(xq, sx, packed, s),
                 lambda a, q, ss, zs: cm.w4a8_matmul_plain(a, sx, q, ss, zs), xq, packed, s, None, "w4a8"),
        "w4a8 zero-points": (lambda: cm.w4a8_matmul(xq, sx, packed, s, z),
                             lambda a, q, ss, zs: cm.w4a8_matmul_plain(a, sx, q, ss, zs), xq, packed, s, z, "w4a8"),
        "woq int8": (lambda: cm.woq_matmul(x, i8, s1, "int8"),
                     lambda a, q, ss, zs: cm.woq_matmul_plain(a, q, ss, "int8"), x, i8, s1, None, "int8"),
        "woq int4": (lambda: cm.woq_matmul(x, packed, s, "int4"),
                     lambda a, q, ss, zs: cm.woq_matmul_plain(a, q, ss, "int4"), x, packed, s, None, "int4"),
        "woq nf4": (lambda: cm.woq_matmul(x, packed, s, "nf4"),
                    lambda a, q, ss, zs: cm.woq_matmul_plain(a, q, ss, "nf4"), x, packed, s, None, "nf4"),
        "woq4z": (lambda: cm.woq4z_matmul(x, packed, s, z), cm.woq4z_matmul_plain, x, packed, s, z, "int4z"),
    }


@pytest.mark.parametrize("entry", ["w4a8", "w4a8 zero-points", "woq int8", "woq int4", "woq nf4", "woq4z"])
def test_matmul_split_matches_split_plain(cuda, entry):
    """A decode call whose weight rows the plan splits (K 16384, 4 column
    tiles) against the split's plain version at the plan's slices."""
    from lia_tpu_torch.ops import cuda_matmul as cm

    gen = torch.Generator(device=cuda).manual_seed(8)
    M, K, N = 16, 16384, 512
    args = _mm_inputs(gen, M, K, N, 128)
    kernel, fn, a, q, s, z, fmt = _split_entries(cm, *args)[entry]
    pl = cm.plan(M, N, K, s.shape[0], fmt, z is not None)
    assert pl.splits > 1
    ref = cm.split_plain(fn, a, q, s, z, split_rows=pl.split_rows, packed=fmt != "int8")
    assert _rel_err(kernel(), ref) <= MM_TOL


def test_matmul_split_calls_on_two_streams(cuda):
    """Split calls on two streams at once keep their own tile counters: every
    output equals the call made alone."""
    from lia_tpu_torch.ops import cuda_matmul as cm

    gen = torch.Generator(device=cuda).manual_seed(9)
    entries = _split_entries(cm, *_mm_inputs(gen, 16, 16384, 512, 128))
    alone = {name: e[0]() for name, e in entries.items()}
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(8):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs += [(name, e[0]()) for name, e in list(entries.items())[j::2]]
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for name, out in outs:
        assert torch.equal(out, alone[name]), name


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


_REAL_PLANE_PLAN = ca.plane_plan


def _plane_parts(monkeypatch, parts):
    """B2's and B7/B8's split forced to ``parts`` through plane_plan (None: the
    host's own choice), on the host's route (the plane body up to
    PLANE_MAX_GROUP, the bf16 beam body past it); fp32 calls (the warp body)
    never split."""
    monkeypatch.setattr(ca, "plane_plan", _REAL_PLANE_PLAN if parts is None else
                        (lambda *a, **k: _REAL_PLANE_PLAN(*a, parts=parts)))


def _plane_rows(S_max):
    """(start, length) of the plane edge rows: left pads 0, 3, 7 and 15 under
    one length, a row of one key, an empty row, a sliding window of 24."""
    n = S_max - 29
    return [(0, n), (3, n), (7, n), (15, n), (0, 1), (0, 0), (n - 24, n)]


def _plane_case(gen, dtype, G, D, S_max, Nkv=2, L=3):
    rows = _plane_rows(S_max)
    B, N = len(rows), Nkv * G
    q = _randn(gen, B, 1, N, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    kc, vc = _randn(gen, L, B, Nkv, S_max, D, dtype=dtype), _randn(gen, L, B, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device="cuda")
    for b, (s0, n) in enumerate(rows):
        sm[b, s0:n] = True
    length = torch.tensor([n for _, n in rows], dtype=torch.int32, device="cuda")
    return q, kf, vf, kc, vc, sm, length


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
def test_decode_attention_kernel_matches_plain(cuda, monkeypatch, dtype, G, D):
    """B2 (the fresh token merged), B7 (the plane holds the token) and B8 (its
    stacked entry at a layer offset, bit for bit B7) against their plain
    versions: bf16 on the host's route (the plane body up to PLANE_MAX_GROUP,
    the bf16 beam body past it), fp32 on the warp body; over a 128- and
    a 1024-slot plane whose rows carry left pads 0/3/7/15, one key, none (B7:
    0; B2: the fresh value) and a sliding window of 24; with the host's split
    and forced to 1 and 3 parts, one launch a call and the split counted."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    Nkv = 2
    fns = (ca.decode_attention_fresh, ca.decode_attention, ca.decode_attention_stacked)
    for S_max in (128, 1024):
        q, kf, vf, kc, vc, sm, length = _plane_case(gen, dtype, G, D, S_max, Nkv)
        B, N = q.shape[0], q.shape[2]
        ref2 = ca.decode_attention_fresh_plain(q, kf, vf, kc, vc, 1, sm, length)
        ref7 = ca.decode_attention_plain(q, kc[1], vc[1], sm, length)
        for parts in (None, 1, 3):
            _plane_parts(monkeypatch, parts)
            plan = ca.plane_plan(B, N, Nkv, S_max, dtype is torch.bfloat16, sms, D)
            assert plan.body == ("warp" if dtype is not torch.bfloat16 else
                                 "plane" if G <= ca.PLANE_MAX_GROUP else "beam")
            before = [(fn.launches, fn.split_launches) for fn in fns]
            out2 = ca.decode_attention_fresh(q, kf, vf, kc, vc, 1, sm, length)
            out7 = ca.decode_attention(q, kc[1].contiguous(), vc[1].contiguous(), sm, length)
            out8 = ca.decode_attention_stacked(q, kc, vc, 1, sm, length)
            assert [(fn.launches, fn.split_launches) for fn in fns] == [(n + 1, k + (plan.parts > 1))
                                                                        for n, k in before]
            torch.testing.assert_close(out2.float(), ref2.float(), rtol=TOL[dtype], atol=TOL[dtype])
            torch.testing.assert_close(out7.float(), ref7.float(), rtol=TOL[dtype], atol=TOL[dtype])
            torch.testing.assert_close(out8, out7, rtol=0, atol=0)
            assert (out7[5] == 0).all()  # the empty row
            torch.testing.assert_close(out2[5, 0].float(), vf[5, :, 0].float().repeat_interleave(G, 0),
                                       rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("entry", ["B2", "B7"])
def test_plane_decode_graph_replay_equals_eager(cuda, monkeypatch, entry, G, parts):
    """B2 and B7 in bf16 over 8 kv heads on both bodies of the host's route
    (G = 1: the plane body; Llama-3-8B's G = 4: the bf16 beam body), with and
    without the split and its merge launch, captured once in a CUDA graph and
    replayed on new queries, lengths and masks equals the eager call on them:
    the lengths and the mask are read on the device, and the captured split
    keeps a workspace of its own that needs no memset."""
    gen = torch.Generator(device=cuda).manual_seed(37)
    _plane_parts(monkeypatch, parts)
    q, kf, vf, kc, vc, sm, length = _plane_case(gen, torch.bfloat16, G, 128, 256, Nkv=8)

    def fn():
        if entry == "B2":
            return ca.decode_attention_fresh(q, kf, vf, kc, vc, 1, sm, length)
        return ca.decode_attention(q, kc[1], vc[1], sm, length)

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    wrapper = ca.decode_attention_fresh if entry == "B2" else ca.decode_attention
    splits = wrapper.split_launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    assert wrapper.split_launches == splits + (parts > 1)
    q.copy_(_randn(gen, *q.shape, dtype=torch.bfloat16))
    length.copy_(torch.tensor([200, 17, 0, 226, 1, 150, 99], dtype=torch.int32))
    sm.zero_()
    for b, (s0, n) in enumerate([(0, 200), (5, 17), (0, 0), (2, 226), (0, 1), (126, 150), (0, 99)]):
        sm[b, s0:n] = True
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn())
    ref = (ca.decode_attention_fresh_plain(q, kf, vf, kc, vc, 1, sm, length) if entry == "B2"
           else ca.decode_attention_plain(q, kc[1], vc[1], sm, length))
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


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
@pytest.mark.parametrize("N,Nkv,D", [(8, 8, 64), (8, 2, 128), (16, 2, 128), (32, 4, 64), (4, 4, 128), (16, 4, 64),
                                     (64, 1, 64), (64, 1, 128)])
def test_flash_cached_kernel_matches_plain(cuda, N, Nkv, D, per_row_base, window):
    """A chunk of C rows over a 200-slot plane that holds it (neither a multiple
    of the 64-key tile): left pads (a first chunk), a cached prefix with base >
    0, per-row bases, a window whose edge falls inside a tile, and a row of
    pads only (its output finite); G = 1, 4, 8 and 64 at D 64 and 128."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, C, S_max, dtype = 4, 72, 200, torch.bfloat16
    bases = [0, 96, 128, 64] if per_row_base else [96] * B
    q = _randn(gen, B, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, B, Nkv, S_max, D, dtype=dtype), _randn(gen, B, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    starts = [5, 0, 30, 200]  # row 0 under per-row bases: 5 pad rows of a first chunk; row 3: all pads
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


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("Nkv", [32, 8])
@pytest.mark.parametrize("C,base,parts", [(256, 768, None), (256, 768, 2), (48, 960, None), (48, 960, 2),
                                          (48, 960, 16)])
def test_flash_cached_split_matches_plain(cuda, monkeypatch, C, base, parts, Nkv, window):
    """The split path at serving's shapes (32 heads, D 128, 1024 slots): a
    256-row suffix at base 768 and a 48-row one at base 960, with the parts
    the host chooses (None) and forced ones, at G = 1 and 4, with a window.
    The kernel's output equals the plain version and, on every row, the plain
    split merged as the kernel merges it; a split launch is counted."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    N, D, S_max, dtype = 32, 128, 1024, torch.bfloat16
    q = _randn(gen, 1, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, 1, Nkv, S_max, D, dtype=dtype), _randn(gen, 1, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(1, S_max, dtype=torch.bool, device=cuda)
    sm[0, 3 : base + C] = True
    b = torch.tensor(base, dtype=torch.int32, device=cuda)
    if parts is not None:
        monkeypatch.setattr(ca, "flash_split_parts", lambda *a: parts)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    used = parts or ca.flash_split_parts(1, C, N, Nkv, S_max, sms)
    splits = ca.flash_attention_cached.split_launches
    out = ca.flash_attention_cached(q, kc, vc, b, sm, window=window)
    assert ca.flash_attention_cached.split_launches == splits + (used > 1)
    ref = ca.flash_attention_cached_plain(q, kc, vc, b, sm, window=window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    merged = ca.flash_merge_plain(*ca.flash_partials_plain(q, kc, vc, b, sm, used, window=window))
    torch.testing.assert_close(out.float(), merged, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("B,S,Nkv", [(16, 256, 32), (16, 256, 8), (1, 256, 32), (1, 200, 8)])
def test_flash_prefill_main_path_widths(cuda, B, S, Nkv, window):
    """B1 at the main path's widths (32 heads, D 128), G = 1 and 4, with left
    pads: 16 rows of 256 give more tiles than SMs (one consumer warpgroup a
    block, two blocks an SM), one row fewer (two warpgroups split each walk)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    N, D, dtype = 32, 128, torch.bfloat16
    q, k, v = _randn(gen, B, S, N, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    for b in range(B):
        mask[b, : (37 * b) % 201] = False
    out = ca.flash_attention_prefill(q, k, v, mask, window=window)
    ref = ca.flash_attention_prefill_plain(q, k, v, mask, window=window)
    valid = mask[:, :, None, None]
    torch.testing.assert_close(out.float() * valid, ref.float() * valid, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.isfinite(out.float()).all()


def test_flash_cached_chunk_batch(cuda):
    """B6 over a batch of four 256-row chunks at bases 0-768 of 1024 slots
    (more tiles than SMs: one consumer warpgroup a block)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, C, N, D, S_max, dtype = 4, 256, 32, 128, 1024, torch.bfloat16
    q = _randn(gen, B, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, B, N, S_max, D, dtype=dtype), _randn(gen, B, N, S_max, D, dtype=dtype)
    bases = torch.tensor([0, 256, 512, 768], dtype=torch.int32, device=cuda)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    for b in range(B):
        sm[b, 11 * b : 256 * b + C] = True
    out = ca.flash_attention_cached(q, kc, vc, bases, sm)  # every chunk row sits past its start
    ref = ca.flash_attention_cached_plain(q, kc, vc, bases, sm)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_split_parts_on_card(cuda):
    """On this card the short prefix-cache suffix is split and B1's main-path
    shape (OPT-6.7B b16 s256) is not."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ca.flash_split_parts(1, 48, 32, 32, 1024, sms) > 1
    assert ca.flash_split_parts(16, 256, 32, 32, 256, sms) == 1


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


def _paged_parts(monkeypatch, parts):
    """The paged kernel's split forced to ``parts`` (None: the host's own choice)."""
    if parts is not None:
        monkeypatch.setattr(ca, "paged_split_parts", lambda *a: parts)


@pytest.mark.parametrize("parts", [None, 1, 3])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,Nkv", [(1, 128, 2), (4, 128, 2), (8, 64, 2), (2, 64, 2), (4, 128, 8)])
def test_paged_decode_kernel_matches_plain(cuda, monkeypatch, G, D, Nkv, dtype, C, fresh, bs, parts):
    """Lengths 0, 37 (mid-page) and 128 (a page end at bs 8, 16 and 32), G = 4
    at Nkv 8 (Llama-3-8B's heads), C = 4, the split off and forced on."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    P = 128 // bs + 1
    q, kp, vp, table, lens, kf, vf = _paged_case(gen, dtype, 3, C, G, D, Nkv=Nkv, bs=bs, P=P)
    args = (q, kp, vp, 1, table, lens) + ((kf, vf) if fresh else ())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    used = parts or ca.paged_split_parts(3, C, Nkv * G, Nkv, P, sms)
    _paged_parts(monkeypatch, parts)
    before, splits = ca.paged_decode_attention.launches, ca.paged_decode_attention.split_launches
    out = ca.paged_decode_attention(*args)
    assert ca.paged_decode_attention.launches == before + 1
    assert ca.paged_decode_attention.split_launches == splits + (used > 1)
    ref = ca.paged_decode_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if not fresh:  # row 0 has no key and no fresh token
        assert (out[0] == 0).all()


@pytest.mark.parametrize("parts", [1, 3])
def test_paged_decode_graph_replay_equals_eager(cuda, monkeypatch, parts):
    """The call (and with a split, its merge launch) captured once in a CUDA
    graph and replayed on new queries and lengths equals the eager call on
    them: the table and lengths are read on the device, the split's scratch
    comes from the allocator and needs no memset."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, kp, vp, table, lens, kf, vf = _paged_case(gen, torch.bfloat16, 3, 1, 4, 128, Nkv=8)
    _paged_parts(monkeypatch, parts)

    def fn():
        return ca.paged_decode_attention(q, kp, vp, 1, table, lens, kf, vf)

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    q.copy_(_randn(gen, *q.shape, dtype=torch.bfloat16))
    lens.copy_(torch.tensor([17, 0, 64], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn())


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
# speculative decoding's verify shapes: B6 and B5 at C = k + 1 = 5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bases", ["verify", "spread"])
@pytest.mark.parametrize("N,Nkv", [(32, 32), (32, 8)])
def test_flash_cached_at_the_verify_shape(cuda, N, Nkv, bases):
    """B6 over 16 rows of a C = 5 verify chunk at D 128 (OPT-6.7B's heads and
    Llama-3-8B's, G = 1 and 4), each row at its own base after uneven
    acceptance: bases 256-301 (the main path's), or spread over 5-290 so that
    rows differ by several 64-key tiles; left pads per row."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, C, D, S_max, dtype = 16, 5, 128, 384, torch.bfloat16
    base_list = [256 + 3 * b for b in range(B)] if bases == "verify" else [5 + 19 * b for b in range(B)]
    starts = [min(p, bb) for p, bb in zip([0, 3, 7, 15, 31, 64, 100, 200] * 2, base_list)]
    q = _randn(gen, B, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, B, Nkv, S_max, D, dtype=dtype), _randn(gen, B, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    for b, (st, bb) in enumerate(zip(starts, base_list)):
        sm[b, st : bb + C] = True
    base = torch.tensor(base_list, dtype=torch.int32, device=cuda)
    before = ca.flash_attention_cached.launches
    out = ca.flash_attention_cached(q, kc, vc, base, sm)
    assert ca.flash_attention_cached.launches == before + 1
    ref = ca.flash_attention_cached_plain(q, kc, vc, base, sm)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("G,Nkv", [(1, 32), (4, 8)])
def test_paged_verify_chunk_matches_plain(cuda, G, Nkv):
    """B5 at C = 5 with the chunk merged causally: lengths that put the
    chunk across a page boundary (13, 30 and 47 at 16-slot pages), a long
    row, and inactive rows at length 0 over the null page; then the chunk's
    write (write_chunk_all_layers) on the card equals the CPU's, the
    inactive rows' into page 0."""
    from lia_tpu_torch.ops import paged as pg

    gen = torch.Generator(device=cuda).manual_seed(14)
    lengths = (13, 0, 30, 160, 47, 0)
    q, kp, vp, table, lens, kf, vf = _paged_case(gen, torch.bfloat16, len(lengths), 5, G, 128, Nkv=Nkv, bs=16, P=12,
                                                 lengths=lengths)
    out = ca.paged_decode_attention(q, kp, vp, 1, table, lens, kf, vf)
    ref = ca.paged_decode_attention_plain(q, kp, vp, 1, table, lens, kf, vf)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    active = lens > 0
    # one chunk a row, every layer: [L, B, N_kv, C, D]
    ks = torch.stack([kf, kf * 2]).contiguous()
    vs = torch.stack([vf, vf * 2]).contiguous()
    kp_cpu, vp_cpu = kp.cpu(), vp.cpu()
    pg.write_chunk_all_layers(kp, vp, ks, vs, table, lens, active)
    pg.write_chunk_all_layers(kp_cpu, vp_cpu, ks.cpu(), vs.cpu(), table.cpu(), lens.cpu(), active.cpu())
    torch.testing.assert_close(kp[:, 1:].cpu(), kp_cpu[:, 1:], rtol=0, atol=0)
    torch.testing.assert_close(vp[:, 1:].cpu(), vp_cpu[:, 1:], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["lookup", "draft", "serve-paged", "serve-slab-draft"])
def test_speculation_on_the_card_launches_its_kernels(cuda, mode):
    """opt-125m widths at 2 layers, bf16 on the card: prompt lookup and a
    draft through generate (B6 per verify layer, B2 per draft layer and
    step) and speculative serving (B5 per paged verify layer): every token in
    the vocabulary, the verify steps within [ceil(new / (k+1)), new], the
    exact launch counts of the kernels on each path."""
    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import init_dummy_params

    cfg = get_config("opt-125m").replace(num_layers=2)
    params = init_dummy_params(cfg, seed=0, scale=0.02)
    rng = np.random.default_rng(2)
    pattern = rng.integers(2, cfg.vocab_size, 8).tolist()
    prompts = [pattern * 4, rng.integers(2, cfg.vocab_size, 21).tolist(), pattern * 2 + [5, 6]]
    k, new, L = 4, 12, cfg.num_layers
    ca.reset_launch_counts()
    if mode in ("lookup", "draft"):
        eng = InferenceEngine(cfg, params, device=cuda)
        ca.reset_launch_counts()
        gen = GenerationConfig(max_new_tokens=new)
        if mode == "lookup":
            seqs, steps = eng.generate_speculative(prompts, gen, k=k)
        else:
            seqs, steps = eng.generate_speculative_draft(eng, prompts, gen, k=k)
        counts = ca.launch_counts()
        assert seqs.shape == (3, new) and ((seqs >= 0) & (seqs < cfg.vocab_size)).all()
        assert -(-new // (k + 1)) <= steps <= new
        assert counts["flash_attention_cached"] == L * steps
        assert counts["flash_attention_prefill"] == L * (2 if mode == "draft" else 1)
        assert counts["decode_attention_fresh"] == (L * (k + 1) * steps if mode == "draft" else 0)
        if mode == "draft":
            assert steps == -(-new // (k + 1))  # the draft is the target: every proposal is accepted
        return
    kw = dict(max_batch=2, max_len=128, gen=GenerationConfig(max_new_tokens=new), speculate_k=k)
    if mode == "serve-paged":
        kw["paged"] = True
    else:
        kw["draft"] = (cfg, params)
    cb = ContinuousBatcher(cfg, params, device=cuda, **kw)
    for p in prompts:
        cb.submit(p)
    done = cb.run()
    counts = ca.launch_counts()
    steps = int(cb.stats()["decode_steps"])
    assert len(done) == 3 and all(len(r.output) == new for r in done)
    if mode == "serve-paged":
        assert counts["paged_decode_attention"] == L * steps and counts["flash_attention_cached"] == 0
        assert (cb.page_rc == 0).all() and len(cb.free_blocks) + len(cb.cached_pages) == cb.num_blocks - 1
    else:
        assert counts["flash_attention_cached"] == L * steps and counts["paged_decode_attention"] == 0
        assert counts["decode_attention_fresh"] == L * (k + 1) * steps


# ---------------------------------------------------------------------------
# grouped-beam decode (B9 decode_beam_attention, B10 decode_beam_attention_int8)
# ---------------------------------------------------------------------------


def _beam_case(gen, dtype, int8, G, D, tlen, nb=3, B0=3, Nkv=2, S_p=64, T_max=32, L=2, plen=50):
    """Beam-kernel inputs over layer 1 of a 2-layer grouped cache: group
    prompts starting at 0, 13 and plen - 1 (a fourth group at 7), and
    ``tlen`` tail slots."""
    B, N = B0 * nb, Nkv * G
    q = _randn(gen, B, 1, N, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    pm = torch.zeros(B0, S_p, dtype=torch.bool, device="cuda")
    for g, p in enumerate((0, 13, plen - 1, 7)[:B0]):
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


def _beam_parts(monkeypatch, parts):
    """The beam kernels' split forced to ``parts`` (None: the host's own
    choice): B9's bf16 plan (beam_plan) and B10's (int8_split_parts)."""
    if parts is not None:
        real = ca.beam_plan
        monkeypatch.setattr(ca, "beam_plan", lambda *a: (real(*a)[0], parts))
        monkeypatch.setattr(ca, "int8_split_parts", lambda *a: parts)


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("tlen", [0, 3, 32])
# (G, D, beams a group, prompt slots): 3, 6, 12 and 24 queries a group of 3
# beams, 16 (one bf16 block) and 32 (two) of 4 beams, a 1024-slot prompt
@pytest.mark.parametrize("G,D,nb,S_p", [(1, 128, 3, 64), (2, 64, 3, 64), (4, 128, 3, 64), (4, 64, 3, 64),
                                        (8, 64, 3, 64), (4, 128, 4, 64), (8, 128, 4, 64), (1, 128, 3, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_beam_decode_kernels_match_plain(cuda, monkeypatch, int8, dtype, G, D, nb, S_p, tlen, parts):
    """B9 and B10 with the host's split and forced to 3 parts (B9's fp32
    calls take the warp body, which never splits); one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    args = _beam_case(gen, dtype, int8, G, D, tlen, nb=nb, S_p=S_p, plen=50 if S_p == 64 else S_p - 24)
    _beam_parts(monkeypatch, parts)
    kernel, plain = ((ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain) if int8
                     else (ca.decode_beam_attention, ca.decode_beam_attention_plain))
    before, splits = kernel.launches, kernel.split_launches
    out = kernel(*args)
    assert kernel.launches == before + 1
    if parts is not None and (int8 or dtype is torch.bfloat16):
        assert kernel.split_launches == splits + 1
    torch.testing.assert_close(out.float(), plain(*args).float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [1, 3])
def test_beam_decode_graph_replay_equals_eager(cuda, monkeypatch, parts):
    """B9 (bf16, 4 groups of 4 beams, G = 4: 16 queries a block), with a
    split and its merge launch, captured once in a CUDA graph and replayed on
    new queries and lengths equals the eager call on them: the lengths and
    the mask are read on the device, and the captured split keeps a
    workspace of its own that needs no memset."""
    gen = torch.Generator(device=cuda).manual_seed(36)
    _beam_parts(monkeypatch, parts)
    args = _beam_case(gen, torch.bfloat16, False, 4, 128, 5, nb=4, B0=4, S_p=128, plen=100)

    def fn():
        return ca.decode_beam_attention(*args)

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    args[0].copy_(_randn(gen, *args[0].shape, dtype=torch.bfloat16))
    args[-3].copy_(torch.tensor(128, dtype=torch.int32))  # prompt length
    args[-2].copy_(torch.tensor(17, dtype=torch.int32))  # tail length
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn())
    torch.testing.assert_close(out.float(), ca.decode_beam_attention_plain(*args).float(), rtol=2e-2, atol=2e-2)


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
FUSED_MLP_WIDE_CASES = [  # the widths whose rows of H take chunks of 8 and 4 rows in phase 1
    ("llama3-70b-swiglu", 8192, 28672, "silu", True, False),
    ("opt-175b-relu", 12288, 49152, "relu", False, True),
]


def fused_mlp_inputs(gen, rows, H, F, act, biases, device="cuda"):
    """bf16 inputs of one MLP block: weights of std 0.02 at the main path's
    widths (H 4096, F up to 16384), scaled by sqrt(4096 / H) (w1, wg) and
    sqrt(16384 / F) (w2) past them, keep the up-projection and the sum over F
    of O(1) at every width, as a trained model's are."""
    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen, device=device) * sc).to(torch.bfloat16)

    up, down = 0.02 * min(1.0, (4096 / H) ** 0.5), 0.02 * min(1.0, (16384 / F) ** 0.5)
    return dict(x=r(rows, H), ln_scale=(1 + r(H, sc=0.1).float()).to(torch.bfloat16),
                ln_bias=r(H, sc=0.1) if biases else None, w1=r(H, F, sc=up), b1=r(F, sc=0.1) if biases else None,
                wg=r(H, F, sc=up) if act == "silu" else None, w2=r(F, H, sc=down),
                b2=r(H, sc=0.1) if biases else None)


FUSED_MLP_TOL = 2e-2  # bf16 outputs of O(1): one or two bf16 steps; the kernel's
# fp32 sums run in another (fixed) order, which can move a rounding of the
# normed input or the activation by one step


@pytest.mark.parametrize("rows", [1, 16, 17, 256])
@pytest.mark.parametrize("case", FUSED_MLP_CASES + FUSED_MLP_WIDE_CASES,
                         ids=[c[0] for c in FUSED_MLP_CASES + FUSED_MLP_WIDE_CASES])
def test_fused_mlp_kernel_matches_plain(cuda, case, rows):
    """Rows 1, the b16 decode step's 16, 17 (a second chunk of rows) and the
    kernel's most, at OPT-6.7B's and Llama-3-8B's widths and at Llama-3-70B's
    and OPT-175B's; a second call gives the same bits (the sums' order is
    fixed), and the grid barrier's counters are left zero."""
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
    assert torch.equal(again, out)
    _, barrier = cuda_mlp._workspace(torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream, rows, F)
    assert not barrier.any()  # left zero for the next launch


@pytest.mark.parametrize("rows", [17, 256])
def test_fused_mlp_wide_error_is_the_plain_versions(cuda, rows):
    """Llama-3-70B's SwiGLU with weights of std 0.02, unscaled, so outputs
    reach ~35: against the same six roundings evaluated in fp64, the kernel
    errs by no more than the plain version (cuBLAS's fp32 sums) plus one bf16
    step of the largest output, and on average by less than an eighth of a
    bf16 step of a typical output. Its fp32 sums run on the tensor cores,
    whose accumulation rounds coarser than cuBLAS's: the activation scratch
    differs from the fp64 one where a rounding flips (~1% of it; by a few
    bf16 steps where a gate near 0 multiplies a large up), and the mean error
    is several times the plain version's (printed)."""
    from lia_tpu_torch.ops import cuda_mlp

    _, H, F, act, rms, biases = FUSED_MLP_WIDE_CASES[0]
    gen = torch.Generator(device=cuda).manual_seed(rows)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * sc).to(torch.bfloat16)

    a = dict(x=r(rows, H), ln_scale=(1 + r(H, sc=0.1).float()).to(torch.bfloat16), ln_bias=None, w1=r(H, F, sc=0.02),
             b1=None, wg=r(H, F, sc=0.02), w2=r(F, H, sc=0.02), b2=None)
    out = cuda_mlp.fused_mlp(**a, activation=act, rms=rms)
    ref = cuda_mlp.fused_mlp_plain(**a, activation=act, rms=rms)
    scratch, _ = cuda_mlp._workspace(torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream, rows, F)
    kact = scratch.reshape(-1)[: rows * F].view(rows, F)  # the kernel's [rows, F] activation, whatever the scratch's F
    x = a["x"].double()
    h = (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * a["ln_scale"].double()).to(torch.bfloat16).double()
    act64 = (torch.nn.functional.silu(h @ a["wg"].double()) * (h @ a["w1"].double())).to(torch.bfloat16)
    out64 = (x + act64.double() @ a["w2"].double()).to(torch.bfloat16).double()
    e_kernel, e_plain = (out.double() - out64).abs(), (ref.double() - out64).abs()
    step = 2.0 ** (torch.floor(torch.log2(out64.abs().max())).item() - 7)  # a bf16 step at the largest output
    flips = kact != act64  # a rounding flip where the sums differ in their last bits
    mag = act64.double().abs().clamp(min=0.125)  # near 0, the sums' absolute error
    d_act = (kact.double() - act64.double()).abs() / 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    print({"rows": rows, "e_kernel max, mean": [e_kernel.max().item(), e_kernel.mean().item()],
           "e_plain max, mean": [e_plain.max().item(), e_plain.mean().item()], "step": step,
           "mean |out|": out64.abs().mean().item(), "flips": flips.float().mean().item(),
           "act steps": d_act.max().item()})
    assert e_kernel.max() <= e_plain.max() + step
    assert e_kernel.mean() <= 2.0 ** -10 * out64.abs().mean()
    assert flips.float().mean() < 0.02


def test_fused_mlp_row_chunks_cover_every_width(cuda):
    """The kernel takes every H % 128 up to MAX_H: its phase-1 chunk of rows
    (read from the library) is at least one row there, 16 at the 4096 of the
    main path, and every registered model's width is within MAX_H."""
    from lia_tpu_torch.models.registry import REGISTRY
    from lia_tpu_torch.ops import _build, cuda_mlp

    lib = _build.library("fused_mlp")
    chunks = {H: lib.lia_fused_mlp_row_chunk(H) for H in range(128, cuda_mlp.MAX_H + 1, 128)}
    assert min(chunks.values()) >= 1 and chunks[4096] == 16
    assert chunks[8192] == 8 and chunks[12288] == 4  # the wide cases above run these
    assert all(lib.lia_fused_mlp_smem_bytes(H) <= 232448 for H in chunks)
    assert max(cfg.hidden_size for cfg in REGISTRY.values()) <= cuda_mlp.MAX_H


@pytest.mark.parametrize("rows", [16, 40])
def test_fused_mlp_graph_replay_equals_eager(cuda, monkeypatch, rows):
    """Llama-3-8B's SwiGLU captured once in a CUDA graph and replayed on a new
    x equals the eager call on it, and the grid barrier is zero afterwards:
    no host value and no memset sit between launches."""
    from lia_tpu_torch.ops import cuda_mlp

    _, H, F, act, rms, biases = FUSED_MLP_CASES[3]
    gen = torch.Generator(device=cuda).manual_seed(21)
    a = fused_mlp_inputs(gen, rows, H, F, act, biases)

    def fn():
        return cuda_mlp.fused_mlp(**a, activation=act, rms=rms)

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    held = []  # the captured call's own scratch and barrier
    take = cuda_mlp._workspace
    monkeypatch.setattr(cuda_mlp, "_workspace", lambda *k: held.append(take(*k)) or held[-1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    monkeypatch.setattr(cuda_mlp, "_workspace", take)
    eager = take(torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream, rows, F)
    assert len(held) == 1 and held[0][1].data_ptr() != eager[1].data_ptr()
    a["x"].copy_(_randn(gen, rows, H, dtype=torch.bfloat16))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert not held[0][1].any() and not eager[1].any()
    assert torch.equal(out, fn())


def test_fused_mlp_streams_do_not_share_a_barrier(cuda):
    """Calls on two streams at once each take their stream's scratch and
    barrier, and give what one stream gives alone."""
    from lia_tpu_torch.ops import cuda_mlp

    _, H, F, act, rms, biases = FUSED_MLP_CASES[3]
    gen = torch.Generator(device=cuda).manual_seed(22)
    a, b = fused_mlp_inputs(gen, 16, H, F, act, biases), fused_mlp_inputs(gen, 16, H, F, act, biases)
    ref_a = cuda_mlp.fused_mlp(**a, activation=act, rms=rms)
    ref_b = cuda_mlp.fused_mlp(**b, activation=act, rms=rms)
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(8):
        for st, inp in zip(streams, (a, b)):
            with torch.cuda.stream(st):
                outs.append(cuda_mlp.fused_mlp(**inp, activation=act, rms=rms))
    torch.cuda.synchronize()
    sets = [cuda_mlp._workspace(torch.cuda.current_device(), st.cuda_stream, 16, F) for st in streams]
    assert sets[0][1].data_ptr() != sets[1][1].data_ptr()
    assert not sets[0][1].any() and not sets[1][1].any()
    for i, out in enumerate(outs):
        assert torch.equal(out, ref_a if i % 2 == 0 else ref_b)


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
    with pytest.raises(ValueError):  # wider than x's TMA box
        b = fused_mlp_inputs(gen, 4, cuda_mlp.MAX_H + 128, 64, "relu", True)
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


# ---------------------------------------------------------------------------
# the int8 decode body (B3 decode_attention_fresh_int8, B10 decode_beam_attention_int8)
# ---------------------------------------------------------------------------

# (length, start) of plane rows: empty, start = length, a start off a multiple
# of 4, a window, rows over several ring stages, one key, a full row
INT8_ROWS = [(0, 0), (19, 19), (37, 3), (45, 37), (200, 5), (1, 0), (333, 0)]


def _int8_parts(monkeypatch, parts):
    """The int8 decode kernels' split forced to ``parts`` (None: the host's own choice)."""
    if parts is not None:
        monkeypatch.setattr(ca, "int8_split_parts", lambda *a: parts)


def _int8_plane(gen, dtype, rows, Nkv, G, D, S_max, L=2):
    """B3's arguments over layer 1 of an int8 cache, row b valid on [start, length)."""
    B = len(rows)
    q = _randn(gen, B, 1, Nkv * G, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    kc = quantize_kv(_randn(gen, L, B, Nkv, S_max, D, dtype=torch.float32))
    vc = quantize_kv(_randn(gen, L, B, Nkv, S_max, D, dtype=torch.float32))
    sm = torch.zeros(B, S_max, dtype=torch.bool, device="cuda")
    for b, (n, s0) in enumerate(rows):
        sm[b, s0:n] = True
    lens = torch.tensor([n for n, _ in rows], dtype=torch.int32, device="cuda")
    return (q, kf, vf, kc.q, kc.s, vc.q, vc.s, 1, sm, lens)


@pytest.mark.parametrize("parts", [None, 1, 3, 8])
@pytest.mark.parametrize("S_max", [384, 387])  # 387: scale rows off 16-byte boundaries
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D,Nkv", [(1, 128, 2), (4, 128, 2), (2, 64, 2), (8, 64, 1), (4, 128, 8)])
def test_int8_decode_split_matches_plain(cuda, monkeypatch, G, D, Nkv, dtype, S_max, parts):
    """B3 at the plan test's edges (a row with no key gives the fresh token's
    value), the split off and forced on; one launch a call, a split counted."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    args = _int8_plane(gen, dtype, INT8_ROWS, Nkv, G, D, S_max)
    used = parts or ca.int8_decode_parts(len(INT8_ROWS), Nkv * G, Nkv, S_max,
                                         torch.cuda.get_device_properties(cuda).multi_processor_count)
    _int8_parts(monkeypatch, parts)
    fn = ca.decode_attention_fresh_int8
    before, splits = fn.launches, fn.split_launches
    out = fn(*args)
    assert fn.launches == before + 1 and fn.split_launches == splits + (used > 1)
    torch.testing.assert_close(out.float(), ca.decode_attention_fresh_int8_plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# (plen, group starts, tlen, T_max): the prompt/tail boundary inside a part, a
# group with no prompt key and no tail, a full tail, long prompts
INT8_BEAMS = [(12, (2, 0, 11), 3, 8), (16, (3, 16, 0), 0, 8), (61, (0, 13, 60), 32, 32), (256, (0, 100, 7), 16, 128)]


def _int8_beam(gen, dtype, case, nb, Nkv, G, D, L=2):
    plen, starts, tlen, T_max = case
    B0 = len(starts)
    S_p = max(plen, 16)
    B = B0 * nb
    q = _randn(gen, B, 1, Nkv * G, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    pm = torch.zeros(B0, S_p, dtype=torch.bool, device="cuda")
    for g, p in enumerate(starts):
        pm[g, p:plen] = True
    planes = [x for rows, S in ((B0, S_p), (B, T_max)) for _ in range(2)
              for x in quantize_kv(_randn(gen, L, rows, Nkv, S, D, dtype=torch.float32))]
    return (q, kf, vf, *planes, 1, pm, torch.tensor(plen, dtype=torch.int32, device="cuda"),
            torch.tensor(tlen, dtype=torch.int32, device="cuda"), nb)


@pytest.mark.parametrize("parts", [None, 1, 3, 8])
@pytest.mark.parametrize("case", INT8_BEAMS, ids=["boundary", "empty group", "full tail", "long prompt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,G,D", [(4, 1, 128), (3, 2, 64), (4, 4, 128), (2, 8, 64)])
def test_int8_beam_split_matches_plain(cuda, monkeypatch, nb, G, D, dtype, case, parts):
    """B10 at the plan test's edges, all of a group's beams in one block (or,
    past 8 queries, in several), the split off and forced on."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    args = _int8_beam(gen, dtype, case, nb, 2, G, D)
    _int8_parts(monkeypatch, parts)
    fn = ca.decode_beam_attention_int8
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1
    torch.testing.assert_close(out.float(), ca.decode_beam_attention_int8_plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _int8_entries(gen):
    """B3 at Llama-3-8B's heads and B10 at 4 x 4 beams (bf16), as zero-argument calls."""
    plane = _int8_plane(gen, torch.bfloat16, INT8_ROWS, 8, 4, 128, 384)
    beam = _int8_beam(gen, torch.bfloat16, INT8_BEAMS[3][:3] + (128,), 4, 4, 1, 128)
    return {"B3": (lambda: ca.decode_attention_fresh_int8(*plane), plane),
            "B10": (lambda: ca.decode_beam_attention_int8(*beam), beam)}


@pytest.mark.parametrize("parts", [None, 1, 4])
@pytest.mark.parametrize("entry", ["B3", "B10"])
def test_int8_decode_reruns_are_bit_identical(cuda, monkeypatch, entry, parts):
    """The sums run in a fixed order: the same inputs give the same bits."""
    _int8_parts(monkeypatch, parts)
    fn, _ = _int8_entries(torch.Generator(device=cuda).manual_seed(33))[entry]
    first = fn()
    for _ in range(3):
        assert torch.equal(fn(), first)


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("entry", ["B3", "B10"])
def test_int8_decode_graph_replay_equals_eager(cuda, monkeypatch, entry, parts):
    """The call (and with a split, its merge launch) captured once in a CUDA
    graph and replayed on new queries and lengths equals the eager call on
    them: lengths are read on the device, and the captured split keeps a
    workspace of its own that needs no memset."""
    gen = torch.Generator(device=cuda).manual_seed(34)
    _int8_parts(monkeypatch, parts)
    fn, args = _int8_entries(gen)[entry]
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    args[0].copy_(_randn(gen, *args[0].shape, dtype=torch.bfloat16))
    if entry == "B3":
        args[-1].copy_(torch.tensor([300, 0, 64, 2, 45, 384, 17], dtype=torch.int32))
    else:
        args[-2].copy_(torch.tensor(9, dtype=torch.int32))  # tail length
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn())


@pytest.mark.parametrize("entry", ["B3", "B10"])
def test_int8_decode_streams_do_not_share_a_workspace(cuda, monkeypatch, entry):
    """Split calls on two streams at once each take their stream's workspace,
    and give what one stream gives alone."""
    _int8_parts(monkeypatch, 4)
    gen = torch.Generator(device=cuda).manual_seed(35)
    (fa, _), (fb, _) = _int8_entries(gen)[entry], _int8_entries(gen)[entry]
    ref_a, ref_b = fa(), fb()
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(8):
        for st, fn in zip(streams, (fa, fb)):
            with torch.cuda.stream(st):
                outs.append(fn())
    torch.cuda.synchronize()
    dev = torch.cuda.current_device()
    ws = [ca._split_workspaces[dev, st.cuda_stream] for st in streams]
    assert ws[0].data_ptr() != ws[1].data_ptr()
    for i, out in enumerate(outs):
        assert torch.equal(out, ref_a if i % 2 == 0 else ref_b)


def test_int8_decode_wrappers_raise_on_the_card(cuda):
    """What the int8 kernels do not take raises on a CUDA tensor; nothing falls back."""
    gen = torch.Generator(device=cuda).manual_seed(36)
    args = list(_int8_plane(gen, torch.bfloat16, INT8_ROWS, 2, 1, 128, 384))
    args[3] = args[3].view(torch.uint8).view(torch.int8)[..., :64].contiguous()  # D mismatch
    with pytest.raises(ValueError):
        ca.decode_attention_fresh_int8(*args)
    args = list(_int8_plane(gen, torch.bfloat16, INT8_ROWS, 2, 1, 128, 384))
    misaligned = torch.empty(args[3].numel() + 1, dtype=torch.int8, device=cuda)[1:].view(args[3].shape)
    misaligned.copy_(args[3])
    args[3] = misaligned  # codes off 16 bytes
    with pytest.raises(ValueError, match="16-byte"):
        ca.decode_attention_fresh_int8(*args)


def test_int8_decode_takes_scales_at_any_offset(cuda):
    """Scales are copied 4 bytes at a time: a scale tensor 4 bytes off a
    16-byte boundary gives the plain version's output."""
    gen = torch.Generator(device=cuda).manual_seed(37)
    args = list(_int8_plane(gen, torch.bfloat16, INT8_ROWS, 2, 1, 128, 387))
    for i in (4, 6):
        shifted = torch.empty(args[i].numel() + 1, dtype=torch.float32, device=cuda)[1:].view(args[i].shape)
        shifted.copy_(args[i])
        args[i] = shifted
    torch.testing.assert_close(ca.decode_attention_fresh_int8(*args).float(),
                               ca.decode_attention_fresh_int8_plain(*args).float(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# query-head groups past 8: Falcon-7B (N 71, N_kv 1, D 64: G = 71, a ragged
# last run of queries), ChatGLM3-6B (N 32, N_kv 2, D 128: G = 16), and the
# gate's edges (G = 3 and 128)
# ---------------------------------------------------------------------------

LARGE_GROUPS = [(71, 1, 64), (32, 2, 128), (6, 2, 64), (128, 1, 64)]  # (N, N_kv, D)
LARGE_IDS = ["falcon-7b G71", "chatglm3-6b G16", "G3", "G128"]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("N,Nkv,D", LARGE_GROUPS, ids=LARGE_IDS)
def test_flash_kernels_at_large_groups(cuda, N, Nkv, D, window):
    """B1 and B6 where a group straddles 64-row tiles: prompt rows with left
    pads and a pad-only row, and a chunk over a plane at per-row bases."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    B, S, dtype = 4, 80, torch.bfloat16
    q, k, v = _randn(gen, B, S, N, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    mask[1, :7] = False
    mask[3] = False
    out = ca.flash_attention_prefill(q, k, v, mask, window=window)
    ref = ca.flash_attention_prefill_plain(q, k, v, mask, window=window)
    valid = mask[:, :, None, None]
    torch.testing.assert_close(out.float() * valid, ref.float() * valid, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.isfinite(out.float()).all()
    C, S_max, bases, starts = 40, 200, [0, 96, 128, 64], [5, 0, 30, 100]
    q = _randn(gen, B, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, B, Nkv, S_max, D, dtype=dtype), _randn(gen, B, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    for b, (s, base) in enumerate(zip(starts, bases)):
        sm[b, s : base + C] = True
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    out = ca.flash_attention_cached(q, kc, vc, base, sm, window=window)
    ref = ca.flash_attention_cached_plain(q, kc, vc, base, sm, window=window)
    valid = torch.zeros(B, C, 1, 1, dtype=torch.bool, device=cuda)  # rows at a valid slot (row 3's first 36: none)
    for b, (s, bb) in enumerate(zip(starts, bases)):
        valid[b, max(s - bb, 0):] = True
    torch.testing.assert_close(out.float() * valid, ref.float() * valid, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [2, 5])
@pytest.mark.parametrize("N,Nkv,D", LARGE_GROUPS[:2], ids=LARGE_IDS[:2])
def test_flash_cached_split_at_large_groups(cuda, monkeypatch, N, Nkv, D, parts):
    """B6's split where tiles straddle positions: each tile's walk is cut from
    its own first and last position (flash_tile_rows); the kernel equals the
    plain version and the plain split merged."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    C, S_max, base, dtype = 48, 1024, 960, torch.bfloat16
    q = _randn(gen, 1, C, N, D, dtype=dtype)
    kc, vc = _randn(gen, 1, Nkv, S_max, D, dtype=dtype), _randn(gen, 1, Nkv, S_max, D, dtype=dtype)
    sm = torch.zeros(1, S_max, dtype=torch.bool, device=cuda)
    sm[0, 3 : base + C] = True
    b = torch.tensor(base, dtype=torch.int32, device=cuda)
    monkeypatch.setattr(ca, "flash_split_parts", lambda *a: parts)
    splits = ca.flash_attention_cached.split_launches
    out = ca.flash_attention_cached(q, kc, vc, b, sm, window=100)
    assert ca.flash_attention_cached.split_launches == splits + 1
    torch.testing.assert_close(out.float(), ca.flash_attention_cached_plain(q, kc, vc, b, sm, window=100).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    merged = ca.flash_merge_plain(*ca.flash_partials_plain(q, kc, vc, b, sm, parts, window=100))
    torch.testing.assert_close(out.float(), merged, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,D", LARGE_GROUPS, ids=LARGE_IDS)
def test_decode_kernels_at_large_groups(cuda, monkeypatch, dtype, N, Nkv, D, ragged, parts):
    """B2 (fresh token merged), B7 and B8 (the plane holds the token): fp32
    calls on the warp body in runs of 8 heads (the last ragged), bf16 calls
    up to PLANE_MAX_GROUP on the plane body and past it on the bf16 beam body (a row a group of one beam, runs of 16
    heads), with one length for all rows or one a row (a row with no key: 0
    without the fresh token) and its split forced to 3 parts."""
    gen = torch.Generator(device=cuda).manual_seed(42)
    L, B, S_max, past = 2, 3, 128, 77
    q = _randn(gen, B, 1, N, D, dtype=dtype)
    kf, vf = _randn(gen, B, Nkv, 1, D, dtype=dtype), _randn(gen, B, Nkv, 1, D, dtype=dtype)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device=cuda)
    ends = (past, 40, 0) if ragged else (past,) * B
    for b, (p, e) in enumerate(zip((0, 9, 76), ends)):
        sm[b, min(p, e):e] = True
    length = torch.tensor(ends if ragged else past, dtype=torch.int32, device=cuda)
    kc, vc = _randn(gen, L, B, Nkv, S_max, D, dtype=dtype), _randn(gen, L, B, Nkv, S_max, D, dtype=dtype)
    _plane_parts(monkeypatch, parts)
    used = ca.plane_plan(B, N, Nkv, S_max, dtype is torch.bfloat16,
                         torch.cuda.get_device_properties(cuda).multi_processor_count, D).parts
    args = (q, kf, vf, kc, vc, 1, sm, length)
    splits = ca.decode_attention_fresh.split_launches
    torch.testing.assert_close(ca.decode_attention_fresh(*args).float(), ca.decode_attention_fresh_plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert ca.decode_attention_fresh.split_launches == splits + (used > 1)
    out = ca.decode_attention(q, kc[1].contiguous(), vc[1].contiguous(), sm, length)
    torch.testing.assert_close(out.float(), ca.decode_attention_plain(q, kc[1], vc[1], sm, length).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(ca.decode_attention_stacked(q, kc, vc, 1, sm, length), out, rtol=0, atol=0)
    if ragged:  # row 2 holds no key and takes no fresh token
        assert (out[2] == 0).all()


@pytest.mark.parametrize("parts", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,D", LARGE_GROUPS, ids=LARGE_IDS)
def test_int8_decode_at_large_groups(cuda, monkeypatch, N, Nkv, D, dtype, parts):
    """B3 with a plane row's G heads in runs of 8, each run with the fresh
    token's round trip, the split off and forced on."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    args = _int8_plane(gen, dtype, INT8_ROWS, Nkv, N // Nkv, D, 384)
    used = parts or ca.int8_decode_parts(len(INT8_ROWS), N, Nkv, 384,
                                         torch.cuda.get_device_properties(cuda).multi_processor_count)
    _int8_parts(monkeypatch, parts)
    fn = ca.decode_attention_fresh_int8
    splits = fn.split_launches
    out = fn(*args)
    assert fn.split_launches == splits + (used > 1)
    torch.testing.assert_close(out.float(), ca.decode_attention_fresh_int8_plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("tlen", [0, 3])
@pytest.mark.parametrize("nb", [4, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("N,Nkv,D", LARGE_GROUPS, ids=LARGE_IDS)
def test_beam_decode_at_large_groups(cuda, monkeypatch, N, Nkv, D, int8, dtype, nb, tlen, parts):
    """B9 and B10 where one beam's queries take several blocks and a run
    straddles two beams (G = 71: runs of 16 (bf16) or 8 (int8) over nb * 71
    flat queries), each run with its beams' tails and fresh tokens."""
    gen = torch.Generator(device=cuda).manual_seed(44)
    args = _beam_case(gen, dtype, int8, N // Nkv, D, tlen, nb=nb, Nkv=Nkv)
    _beam_parts(monkeypatch, parts)
    kernel, plain = ((ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain) if int8
                     else (ca.decode_beam_attention, ca.decode_beam_attention_plain))
    before = kernel.launches
    out = kernel(*args)
    assert kernel.launches == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,D", LARGE_GROUPS, ids=LARGE_IDS)
def test_paged_decode_at_large_groups(cuda, monkeypatch, N, Nkv, D, dtype, C, fresh, parts):
    """B5's blocks take a (kv head, row)'s G * C queries 16 at a time, the
    last run ragged."""
    gen = torch.Generator(device=cuda).manual_seed(45)
    q, kp, vp, table, lens, kf, vf = _paged_case(gen, dtype, 3, C, N // Nkv, D, Nkv=Nkv, bs=16, P=9)
    args = (q, kp, vp, 1, table, lens) + ((kf, vf) if fresh else ())
    _paged_parts(monkeypatch, parts)
    out = ca.paged_decode_attention(*args)
    torch.testing.assert_close(out.float(), ca.paged_decode_attention_plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# head dims 80, 96 and 256 (OPT-2.7B, StableLM-3B, CodeGen-2B; GPT-NeoX-20B;
# GPT-J-6B, CodeGen-6B): the padded bodies, rows D apart
# ---------------------------------------------------------------------------

# (N, N_kv, D): G = 1 and 4 at each new D, and G = 2, 8 and 16 (past the warp
# body's 8 heads a block, and two bf16 beam runs at D = 256)
HEAD_DIMS = [(4, 4, 80), (8, 2, 80), (4, 4, 96), (8, 2, 96), (4, 2, 96), (2, 2, 256), (8, 2, 256), (16, 2, 256),
             (16, 1, 256)]
HEAD_IDS = ["D80 G1", "D80 G4", "D96 G1", "D96 G4", "D96 G2", "D256 G1", "D256 G4", "D256 G8", "D256 G16"]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS, ids=HEAD_IDS)
def test_flash_kernels_at_head_dims(cuda, N, Nkv, D, window):
    """B1 and B6 at the new head dims: the tensor map's columns past D read as
    zeros, and only D columns are stored."""
    test_flash_kernels_at_large_groups(cuda, N, Nkv, D, window)


@pytest.mark.parametrize("parts", [2, 5])
@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS[::2], ids=HEAD_IDS[::2])
def test_flash_cached_split_at_head_dims(cuda, monkeypatch, N, Nkv, D, parts):
    """B6's split and its merge launch over rows D apart."""
    test_flash_cached_split_at_large_groups(cuda, monkeypatch, N, Nkv, D, parts)


@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS, ids=HEAD_IDS)
def test_flash_prefill_main_shape_at_head_dims(cuda, N, Nkv, D):
    """B1 at the main path's 16 rows x 256 positions with left pads."""
    gen = torch.Generator(device=cuda).manual_seed(50)
    B, S, dtype = 16, 256, torch.bfloat16
    q, k, v = _randn(gen, B, S, N, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype), _randn(gen, B, Nkv, S, D, dtype=dtype)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    for b in range(B):
        mask[b, : 13 * b] = False
    valid = mask[:, :, None, None]
    out, ref = ca.flash_attention_prefill(q, k, v, mask), ca.flash_attention_prefill_plain(q, k, v, mask)
    torch.testing.assert_close(out.float() * valid, ref.float() * valid, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS, ids=HEAD_IDS)
def test_decode_kernels_at_head_dims(cuda, monkeypatch, dtype, N, Nkv, D, ragged, parts):
    """B2, B7 and B8 at the new head dims: bf16 on the plane body (exact
    D * 2-byte rows, D / 8 lanes a row) up to PLANE_MAX_GROUP and on the bf16
    beam body past it, fp32 on the warp body (lanes past D idle)."""
    test_decode_kernels_at_large_groups(cuda, monkeypatch, dtype, N, Nkv, D, ragged, parts)


@pytest.mark.parametrize("parts", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS, ids=HEAD_IDS)
def test_int8_decode_at_head_dims(cuda, monkeypatch, N, Nkv, D, dtype, parts):
    """B3 at the new head dims: rows of D code bytes in DP-byte ring rows,
    the q slices past D zero."""
    test_int8_decode_at_large_groups(cuda, monkeypatch, N, Nkv, D, dtype, parts)


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS, ids=HEAD_IDS)
def test_beam_decode_at_head_dims(cuda, monkeypatch, N, Nkv, D, int8, dtype, parts):
    """B9 and B10 at the new head dims, 4 beams a group, a tail of 3 (B9's
    bf16 blocks hold 8 queries at D = 256)."""
    test_beam_decode_at_large_groups(cuda, monkeypatch, N, Nkv, D, int8, dtype, 4, 3, parts)


@pytest.mark.parametrize("parts", [None, 3])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Nkv,D", HEAD_DIMS, ids=HEAD_IDS)
def test_paged_decode_at_head_dims(cuda, monkeypatch, N, Nkv, D, dtype, C, fresh, parts):
    """B5 at the new head dims: pages of rows D apart, copied as they are."""
    test_paged_decode_at_large_groups(cuda, monkeypatch, N, Nkv, D, dtype, C, fresh, parts)


def test_other_head_dims_raise_on_the_card(cuda):
    """D = 120 and 48 raise on the card (112, MPT-30B's, runs since ALiBi's
    port): no plain version runs on a CUDA tensor."""
    dt = torch.bfloat16
    for D in (120, 48):
        q = torch.zeros(2, 16, 4, D, device=cuda, dtype=dt)
        k = torch.zeros(2, 4, 16, D, device=cuda, dtype=dt)
        mask = torch.ones(2, 16, dtype=torch.bool, device=cuda)
        with pytest.raises(ValueError, match="unsupported head shape"):
            ca.flash_attention_prefill(q, k, k, mask)
        qd = torch.zeros(2, 1, 4, D, device=cuda, dtype=dt)
        kc = torch.zeros(2, 2, 4, 16, D, device=cuda, dtype=dt)
        fresh = torch.zeros(2, 4, 1, D, device=cuda, dtype=dt)
        with pytest.raises(ValueError, match="unsupported head shape"):
            ca.decode_attention_fresh(qd, fresh, fresh, kc, kc, 1, mask, 8)
        with pytest.raises(ValueError, match="unsupported head shape"):
            ca.decode_attention(qd, kc[0], kc[0], mask, 8)

