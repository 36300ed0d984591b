"""The port's attention (lia_tpu_torch.ops.attention / cuda_attention) against
the JAX package on the CPU.

Each kernel's plain PyTorch version is held against the Pallas kernel it
replaces, run in interpret mode (as tests/test_pallas_attention.py runs it);
the front doors are held against lia_tpu's. Inputs are drawn with numpy from a
seed and handed to both packages.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.ops import attention as jatt
from lia_tpu.ops import pallas_attention as pa
from lia_tpu.ops.quant import dequantize_kv as j_dequantize_kv
from lia_tpu.ops.quant import quantize_kv as j_quantize_kv

from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.quant import QuantizedKV

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def both(a: np.ndarray, dtype: str):
    """One numpy array as (jax array, torch tensor) of the same dtype."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def left_pad_mask(B, S, pads):
    m = np.ones((B, S), bool)
    for b, p in enumerate(pads):
        m[b, :p] = False
    return m


def slot_mask(B, S, past, pads):
    sm = np.zeros((B, S), bool)
    for b, p in enumerate(pads):
        sm[b, p:past] = True
    return sm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("pads", [(0, 0), (3, 7), (15, 0)])
def test_flash_prefill_plain_matches_pallas(rng, pads, gqa, dtype):
    B, S, N, D = 2, 32, 4, 16
    Nkv = 2 if gqa else N
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    k = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    mask = left_pad_mask(B, S, pads)
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    ref = pa.flash_attention_prefill(jq, jk, jv, jnp.asarray(mask), block_q=16, block_k=16, interpret=True)
    out = ca.flash_attention_prefill(tq, tk, tv, torch.from_numpy(mask))
    assert out.dtype == tq.dtype and out.shape == (B, S, N, D)
    valid = mask[:, :, None, None]  # pad query rows are meaningless in both
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(f32(out) * valid, f32(ref) * valid, rtol=tol, atol=tol)
    assert np.isfinite(f32(out)).all()


@pytest.mark.parametrize("window", [5, 12])
def test_flash_prefill_plain_window_matches_pallas(rng, window):
    B, S, N, D = 2, 32, 4, 16
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    k = rng.standard_normal((B, N, S, D)).astype(np.float32)
    v = rng.standard_normal((B, N, S, D)).astype(np.float32)
    mask = left_pad_mask(B, S, (0, 3))
    ref = pa.flash_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        block_q=16, block_k=16, window=window, interpret=True,
    )
    out = ca.flash_attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask), window=window
    )
    valid = mask[:, :, None, None]
    np.testing.assert_allclose(f32(out) * valid, f32(ref) * valid, rtol=2e-5, atol=2e-5)


def _decode_inputs(rng, gqa, L=3, B=2, S=32, D=16, Nkv=4):
    N = Nkv * (2 if gqa else 1)
    return dict(
        q=rng.standard_normal((B, 1, N, D)).astype(np.float32),
        kf=rng.standard_normal((B, Nkv, 1, D)).astype(np.float32),
        vf=rng.standard_normal((B, Nkv, 1, D)).astype(np.float32),
        k=rng.standard_normal((L, B, Nkv, S, D)).astype(np.float32),
        v=rng.standard_normal((L, B, Nkv, S, D)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("pads", [(0, 0), (3, 7), (15, 0)])
def test_decode_fresh_plain_matches_pallas(rng, pads, gqa, dtype):
    x = _decode_inputs(rng, gqa)
    past = 21
    sm = slot_mask(2, 32, past, pads)
    j = {n: both(a, dtype)[0] for n, a in x.items()}
    t = {n: both(a, dtype)[1] for n, a in x.items()}
    ref = pa.decode_attention_fresh(
        j["q"], j["kf"], j["vf"], j["k"], j["v"], jnp.asarray(1, jnp.int32),
        jnp.asarray(sm), jnp.asarray(past, jnp.int32), block_k=8, interpret=True,
    )
    out = ca.decode_attention_fresh(
        t["q"], t["kf"], t["vf"], t["k"], t["v"], 1, torch.from_numpy(sm),
        torch.tensor(past, dtype=torch.int32),
    )
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(f32(out), f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("pads", [(0, 0), (3, 7), (15, 0)])
def test_decode_fresh_int8_plain_matches_pallas(rng, pads, gqa, dtype):
    x = _decode_inputs(rng, gqa)
    past = 21
    sm = slot_mask(2, 32, past, pads)
    jk, jv = j_quantize_kv(jnp.asarray(x["k"])), j_quantize_kv(jnp.asarray(x["v"]))
    j = {n: both(x[n], dtype)[0] for n in ("q", "kf", "vf")}
    t = {n: both(x[n], dtype)[1] for n in ("q", "kf", "vf")}
    # the Pallas kernel takes the fresh token after its int8 round trip; the
    # port's takes it unquantized and makes the round trip itself
    for n in ("kf", "vf"):
        j[n] = j_dequantize_kv(j_quantize_kv(j[n]), j["q"].dtype)
    ref = pa.decode_attention_fresh_int8(
        j["q"], j["kf"], j["vf"], jk.q, jk.s, jv.q, jv.s, jnp.asarray(1, jnp.int32),
        jnp.asarray(sm), jnp.asarray(past, jnp.int32), block_k=8, interpret=True,
    )
    tt = [torch.from_numpy(np.array(a)) for a in (jk.q, jk.s, jv.q, jv.s)]
    out = ca.decode_attention_fresh_int8(
        t["q"], t["kf"], t["vf"], *tt, 1, torch.from_numpy(sm), torch.tensor(past, dtype=torch.int32)
    )
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(f32(out), f32(ref), rtol=tol, atol=tol)


def test_decode_fresh_plain_takes_per_row_lengths(rng):
    """A [B] length gives each row its own validity range, as a scalar does for all."""
    x = _decode_inputs(rng, False)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    sm = torch.from_numpy(slot_mask(2, 32, 21, (0, 4)))
    per_row = ca.decode_attention_fresh(t["q"], t["kf"], t["vf"], t["k"], t["v"], 2, sm,
                                        torch.tensor([21, 21], dtype=torch.int32))
    scalar = ca.decode_attention_fresh(t["q"], t["kf"], t["vf"], t["k"], t["v"], 2, sm, 21)
    torch.testing.assert_close(per_row, scalar, rtol=0, atol=0)


def test_attend_matches_lia_tpu(rng):
    B, S, N, Nkv, D = 2, 12, 4, 2, 8
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    k = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    mask = left_pad_mask(B, S, (0, 5))
    ref = jatt.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jatt.causal_mask(jnp.asarray(mask)))
    out = att.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     att.causal_mask(torch.from_numpy(mask)))
    np.testing.assert_allclose(f32(out), f32(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_masks_match_lia_tpu(window):
    mask = left_pad_mask(3, 10, (0, 2, 6))
    np.testing.assert_array_equal(
        att.causal_mask(torch.from_numpy(mask), window).numpy(),
        np.asarray(jatt.causal_mask(jnp.asarray(mask), window)),
    )
    sm = slot_mask(3, 16, 9, (0, 2, 6))
    jctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(9, jnp.int32), window)
    tctx = att.decode_attn_ctx(torch.from_numpy(sm), torch.tensor(9, dtype=torch.int32), window)
    np.testing.assert_array_equal(tctx.slot_mask.numpy(), np.asarray(jctx.slot_mask))
    np.testing.assert_array_equal(tctx.mask.numpy(), np.asarray(jctx.mask))
    np.testing.assert_array_equal(
        att.prefill_attn_ctx(torch.from_numpy(mask), window).mask.numpy(),
        np.asarray(jatt.prefill_attn_ctx(jnp.asarray(mask), window).mask),
    )


@pytest.mark.parametrize("gqa", [False, True])
def test_attend_prefill_front_door_matches_lia_tpu(rng, gqa):
    B, S, N, D = 2, 16, 4, 8
    Nkv = 2 if gqa else N
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    k = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    mask = left_pad_mask(B, S, (0, 7))
    ref = jatt.attend_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jatt.prefill_attn_ctx(jnp.asarray(mask)))
    out = att.attend_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             att.prefill_attn_ctx(torch.from_numpy(mask)))
    valid = mask[:, :, None, None]
    np.testing.assert_allclose(f32(out) * valid, f32(ref) * valid, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("gqa", [False, True])
def test_attend_decode_fresh_front_door_matches_lia_tpu(rng, kv, gqa):
    """lia_tpu's front door on the CPU writes the fresh token into a copy of the
    plane and attends (its golden path); the port's merges it in the kernel's
    plain version. INT8: lia_tpu's fresh k/v arrive quantized, the port's
    unquantized (its int8 kernel makes the round trip)."""
    x = _decode_inputs(rng, gqa)
    past = 19
    sm = slot_mask(2, 32, past, (0, 5))
    jctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(past, jnp.int32))
    tctx = att.decode_attn_ctx(torch.from_numpy(sm), torch.tensor(past, dtype=torch.int32))
    jq = jnp.asarray(x["q"])
    tq = torch.from_numpy(x["q"])
    if kv == "int8":
        jk, jv = j_quantize_kv(jnp.asarray(x["k"])), j_quantize_kv(jnp.asarray(x["v"]))
        jkf, jvf = j_quantize_kv(jnp.asarray(x["kf"])), j_quantize_kv(jnp.asarray(x["vf"]))

        def conv(qkv):
            return QuantizedKV(torch.from_numpy(np.array(qkv.q)), torch.from_numpy(np.array(qkv.s)))

        tk, tv = conv(jk), conv(jv)
        tkf, tvf = torch.from_numpy(x["kf"]), torch.from_numpy(x["vf"])
    else:
        jk, jv, jkf, jvf = (jnp.asarray(x[n]) for n in ("k", "v", "kf", "vf"))
        tk, tv, tkf, tvf = (torch.from_numpy(x[n]) for n in ("k", "v", "kf", "vf"))
    ref = jatt.attend_decode_fresh(jq, jkf, jvf, jk, jv, jnp.asarray(2, jnp.int32), jctx)
    out = att.attend_decode_fresh(tq, tkf, tvf, tk, tv, 2, tctx)
    np.testing.assert_allclose(f32(out), f32(ref), rtol=2e-5, atol=2e-5)


def test_front_doors_reject_alibi_bias(rng):
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 2, 4, 8)
    ctx = att.prefill_attn_ctx(torch.ones(1, 4, dtype=torch.bool), bias=torch.zeros(1, 2, 4))
    with pytest.raises(NotImplementedError):
        att.attend_prefill(q, k, k, ctx)


def test_plain_path_counts_no_launch(rng):
    """The counters count kernel launches only; CPU tensors take the plain versions."""
    ca.reset_launch_counts()
    x = _decode_inputs(rng, False)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    sm = torch.from_numpy(slot_mask(2, 32, 21, (0, 0)))
    ca.decode_attention_fresh(t["q"], t["kf"], t["vf"], t["k"], t["v"], 0, sm, 21)
    q = torch.from_numpy(rng.standard_normal((2, 16, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    ca.flash_attention_prefill(q, k, k, torch.ones(2, 16, dtype=torch.bool))
    ca.decode_attention(t["q"], t["k"][0], t["v"][0], sm, 21)
    ca.decode_attention_stacked(t["q"], t["k"], t["v"], 1, sm, 21)
    assert ca.launch_counts() == {
        "flash_attention_prefill": 0, "decode_attention_fresh": 0, "decode_attention_fresh_int8": 0,
        "decode_attention": 0, "decode_attention_stacked": 0,
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_fresh_round_trip_matches_lia_tpu(rng, dtype):
    """The port's int8 decode takes the fresh token through quantize_kv and
    dequantize_kv to q's type; lia_tpu does the same before its kernel."""
    from lia_tpu_torch.ops.quant import dequantize_kv, quantize_kv

    jx, tx = both(rng.standard_normal((2, 4, 1, 16)).astype(np.float32), dtype)
    ref = j_dequantize_kv(j_quantize_kv(jx), jx.dtype)
    out = dequantize_kv(quantize_kv(tx), tx.dtype)
    np.testing.assert_array_equal(f32(out), f32(ref))


# ---------------------------------------------------------------------------
# decode_attention (write-then-attend over one plane) and its stacked entry
# ---------------------------------------------------------------------------

DECODE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("length,pads", [(5, (0, 0)), (9, (2, 4)), (16, (0, 3))])
def test_decode_plain_matches_pallas(rng, length, pads, gqa, dtype):
    """The cases of lia_tpu's decode kernel test: lengths, left pads, GQA; the
    plane already holds the token, and ``length`` counts it."""
    B, S_max, N, D = 2, 16, 4, 16
    Nkv = 2 if gqa else N
    q = rng.standard_normal((B, 1, N, D)).astype(np.float32)
    k = rng.standard_normal((B, Nkv, S_max, D)).astype(np.float32)
    v = rng.standard_normal((B, Nkv, S_max, D)).astype(np.float32)
    sm = slot_mask(B, S_max, length, pads)
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    ref = pa.decode_attention(jq, jk, jv, jnp.asarray(sm), jnp.asarray(length, jnp.int32), block_k=8, interpret=True)
    out = ca.decode_attention(tq, tk, tv, torch.from_numpy(sm), torch.tensor(length, dtype=torch.int32))
    assert out.dtype == tq.dtype and out.shape == (B, 1, N, D)
    tol = DECODE_TOL[dtype]
    np.testing.assert_allclose(f32(out), f32(ref), rtol=tol, atol=tol)


def test_decode_plain_ignores_stale_slots(rng):
    """Slots past ``length`` never leak, even where the slot mask is stale."""
    B, S_max, N, D = 1, 16, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, 1, N, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, N, S_max, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, N, S_max, D)).astype(np.float32))
    mask_all = torch.ones(B, S_max, dtype=torch.bool)
    a = ca.decode_attention(q, k, v, mask_all, 6)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 8:], v2[:, :, 8:] = 99.0, -99.0
    b = ca.decode_attention(q, k2, v2, mask_all, 6)
    ref = pa.decode_attention(jnp.asarray(q.numpy()), jnp.asarray(k2.numpy()), jnp.asarray(v2.numpy()),
                              jnp.asarray(mask_all.numpy()), jnp.asarray(6, jnp.int32), block_k=8, interpret=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(f32(b), f32(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["prefetch", "dma"])
def test_decode_stacked_plain_matches_pallas(rng, variant):
    """Both of lia_tpu's stacked entry points (the scalar-prefetch and the
    manual-DMA form, the same math) against the port's one stacked wrapper."""
    L, B, Nkv, S, D, G = 3, 2, 4, 32, 16, 2
    N = Nkv * G
    q = rng.standard_normal((B, 1, N, D)).astype(np.float32)
    k = rng.standard_normal((L, B, Nkv, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Nkv, S, D)).astype(np.float32)
    sm = slot_mask(B, S, 21, (0, 6))
    fn = pa.decode_attention_stacked if variant == "prefetch" else pa.decode_attention_stacked_dma
    ref = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(1, jnp.int32), jnp.asarray(sm),
             jnp.asarray(21, jnp.int32), block_k=8, interpret=True)
    out = ca.decode_attention_stacked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1,
                                      torch.from_numpy(sm), torch.tensor(21, dtype=torch.int32))
    np.testing.assert_allclose(f32(out), f32(ref), rtol=1e-5, atol=1e-5)
    plane = ca.decode_attention(torch.from_numpy(q), torch.from_numpy(k[1]), torch.from_numpy(v[1]),
                                torch.from_numpy(sm), 21)
    torch.testing.assert_close(out, plane, rtol=0, atol=0)


def test_decode_plain_window_matches_pallas(rng):
    """A sliding window reaches the kernel through the slot mask: the past-only
    context drops the old slots (both packages agree), the token's slot joins
    it, and the kernel over length + 1 sees exactly the last W positions."""
    B, S_max, N, D, W, length = 2, 32, 4, 16, 8, 20
    q = rng.standard_normal((B, 1, N, D)).astype(np.float32)
    k = rng.standard_normal((B, N, S_max, D)).astype(np.float32)
    v = rng.standard_normal((B, N, S_max, D)).astype(np.float32)
    sm = slot_mask(B, S_max, length, (0, 3))
    jctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(length, jnp.int32), W)
    tctx = att.decode_attn_ctx(torch.from_numpy(sm), torch.tensor(length, dtype=torch.int32), W)
    np.testing.assert_array_equal(tctx.slot_mask.numpy(), np.asarray(jctx.slot_mask))
    j_inc = jctx.slot_mask.at[:, length].set(True)
    t_inc = tctx.slot_mask.clone()
    t_inc[:, length] = True
    ref = pa.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_inc,
                              jnp.asarray(length + 1, jnp.int32), block_k=8, interpret=True)
    out = ca.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_inc, length + 1)
    np.testing.assert_allclose(f32(out), f32(ref), rtol=1e-5, atol=1e-5)
    keep = np.zeros((B, 1, S_max), bool)
    keep[:, :, length - W + 1 : length + 1] = True
    golden = att.attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(keep))
    np.testing.assert_allclose(f32(out), f32(golden), rtol=1e-5, atol=1e-5)


def test_decode_plain_takes_per_row_lengths(rng):
    x = _decode_inputs(rng, True)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    sm = torch.from_numpy(slot_mask(2, 32, 22, (0, 4)))
    per_row = ca.decode_attention(t["q"], t["k"][0], t["v"][0], sm, torch.tensor([22, 22], dtype=torch.int32))
    scalar = ca.decode_attention(t["q"], t["k"][0], t["v"][0], sm, 22)
    torch.testing.assert_close(per_row, scalar, rtol=0, atol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("gqa", [False, True])
def test_attend_decode_front_door_matches_lia_tpu(rng, kv, gqa):
    """``attend_decode`` (kernel plain version) and ``attend_decode_host`` (the
    host tier's golden model) against lia_tpu's ``attend_decode``, whose CPU
    path is its golden model; INT8 planes are dequantized first on all sides."""
    x = _decode_inputs(rng, gqa)
    length = 20
    sm = slot_mask(2, 32, length, (0, 5))
    jctx = jatt.decode_attn_ctx(jnp.asarray(sm), jnp.asarray(length, jnp.int32))
    tctx = att.decode_attn_ctx(torch.from_numpy(sm), torch.tensor(length, dtype=torch.int32))
    if kv == "int8":
        jk, jv = j_quantize_kv(jnp.asarray(x["k"][1])), j_quantize_kv(jnp.asarray(x["v"][1]))
        tk, tv = (QuantizedKV(torch.from_numpy(np.array(a.q)), torch.from_numpy(np.array(a.s))) for a in (jk, jv))
    else:
        jk, jv = jnp.asarray(x["k"][1]), jnp.asarray(x["v"][1])
        tk, tv = torch.from_numpy(x["k"][1]), torch.from_numpy(x["v"][1])
    ref = jatt.attend_decode(jnp.asarray(x["q"]), jk, jv, jctx)
    tq = torch.from_numpy(x["q"])
    for out in (att.attend_decode(tq, tk, tv, tctx), att.attend_decode_host(tq, tk, tv, tctx)):
        np.testing.assert_allclose(f32(out), f32(ref), rtol=2e-5, atol=2e-5)


def test_host_prefill_attention_matches_lia_tpu(rng):
    B, S, N, Nkv, D = 2, 16, 4, 2, 8
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    k = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Nkv, S, D)).astype(np.float32)
    mask = left_pad_mask(B, S, (0, 7))
    ref = jatt.attend_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jatt.prefill_attn_ctx(jnp.asarray(mask)))
    out = att.attend_prefill_host(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  att.prefill_attn_ctx(torch.from_numpy(mask)))
    valid = mask[:, :, None, None]
    np.testing.assert_allclose(f32(out) * valid, f32(ref) * valid, rtol=2e-5, atol=2e-5)


def test_decode_front_doors_reject_alibi_bias():
    q = torch.zeros(1, 1, 2, 8)
    k = torch.zeros(1, 2, 4, 8)
    ctx = att.decode_attn_ctx(torch.ones(1, 4, dtype=torch.bool), torch.tensor(4), bias=torch.zeros(1, 2, 4))
    for fn in (att.attend_decode, att.attend_decode_host):
        with pytest.raises(NotImplementedError):
            fn(q, k, k, ctx)
