"""The port's CUDA kernels on the card, against their plain PyTorch versions.

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
