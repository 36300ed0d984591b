"""CUDA attention kernels: wrappers, plain PyTorch versions and launch counters
(the counterpart of ``lia_tpu/ops/pallas_attention.py``).

Each wrapper takes the kernel's plain version for a tensor on the CPU, and
launches the kernel (``csrc/*.cu``, built by :mod:`lia_tpu_torch.ops._build`)
for a CUDA tensor, raising on anything the kernel does not take: a CUDA tensor
never falls back to the plain version. Each plain version repeats its kernel's
arithmetic (where products round, the exp2 units, the masking), so the CPU
tests hold it against the Pallas kernel and the card holds the kernel against
it. Each wrapper counts its launches in ``<wrapper>.launches``.

Validity is a contiguous range per sequence, as in the TPU kernels: ``[start, S)``
for a left-padded prompt and ``[start, length)`` over a cache, with
``start = length - popcount(mask)``. The kernels count it on the device and read
``length`` from device memory, so a decode step never syncs with the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from lia_tpu_torch.ops.quant import dequantize_kv, quantize_kv

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL_DIMS = (64, 128)  # head dims the kernels are instantiated for
KERNEL_GROUPS = (1, 2, 4, 8)  # GQA group sizes the decode kernels are instantiated for


def _sscale(scale: Optional[float], D: int) -> float:
    """Softmax scale in exp2 units, as the TPU kernels fold it."""
    return (scale if scale is not None else D**-0.5) * LOG2E


def _contiguous_starts(mask: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    return length - mask.to(torch.int32).sum(dim=1)


def _lengths(length: Union[int, torch.Tensor], device) -> torch.Tensor:
    """``length`` (int, 0-dim or [B]) as an int32 tensor on ``device``; a kernel
    reads element ``b * stride(0)``, so a 0-dim length serves every row."""
    return torch.as_tensor(length, device=device).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def flash_attention_prefill_plain(q, k, v, input_mask, scale=None, window=None):
    """Causal attention over a left-padded prompt, with the kernel's precision:
    dots of input-type values summed in fp32, the scale applied after the dot
    in exp2 units, probabilities rounded to V's type before P.V.
    q [B, S, N, D]; k/v [B, N_kv, S, D]; input_mask [B, S] bool → [B, S, N, D].
    Fully masked (pad) query rows are finite but meaningless, as in the kernel."""
    B, S, N, D = q.shape
    Nkv = k.shape[1]
    G = N // Nkv
    qf = q.float().reshape(B, S, Nkv, G, D)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, k.float()) * _sscale(scale, D)
    pos = torch.arange(S, device=q.device)
    starts = _contiguous_starts(input_mask, torch.tensor(S, device=q.device))
    masked = (pos[None, :] > pos[:, None])[None] | (pos[None, None, :] < starts[:, None, None])
    if window is not None:
        masked = masked | (pos[None, :] <= pos[:, None] - window)[None]
    s = torch.where(masked[:, None, None], torch.full_like(s, NEG_INF), s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, N, D).to(q.dtype)


def _cache_allow(slot_mask, length, S_max, device):
    lengths = _lengths(length, device).expand(slot_mask.shape[0])
    starts = _contiguous_starts(slot_mask, lengths)
    pos = torch.arange(S_max, device=device)[None, :]
    return (pos < lengths[:, None]) & (pos >= starts[:, None])  # [B, S_max]


def decode_attention_plain(q, k_cache, v_cache, slot_mask, length, scale=None):
    """One query per sequence over one layer plane's [start, length), all in
    fp32; the plane already holds this step's token and ``length`` counts it.
    q [B, 1, N, D]; k/v [B, N_kv, S_max, D]; slot_mask [B, S_max]; length int,
    0-dim or [B]."""
    B, _, N, D = q.shape
    _, Nkv, S_max, _ = k_cache.shape
    G = N // Nkv
    qs = q.float().reshape(B, Nkv, G, D) * _sscale(scale, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, k_cache.float())
    allow = _cache_allow(slot_mask, length, S_max, q.device)
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allow[:, None, None], torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) / l.clamp(min=1e-30)
    return out.reshape(B, 1, N, D).to(q.dtype)


def decode_attention_stacked_plain(q, k_cache, v_cache, layer_idx, slot_mask, length, scale=None):
    """:func:`decode_attention_plain` over layer ``layer_idx`` of the stacked
    cache [L, B, N_kv, S_max, D]."""
    return decode_attention_plain(q, k_cache[layer_idx], v_cache[layer_idx], slot_mask, length, scale)


def decode_attention_fresh_plain(
    q, k_fresh, v_fresh, k_cache, v_cache, layer_idx, slot_mask, length, scale=None
):
    """One query per sequence over cache[layer_idx][start, length) ∪ {fresh token},
    all in fp32. q [B, 1, N, D]; fresh k/v [B, N_kv, 1, D];
    cache [L, B, N_kv, S_max, D]; slot_mask [B, S_max]; length int, 0-dim or [B]."""
    B, _, N, D = q.shape
    _, _, Nkv, S_max, _ = k_cache.shape
    G = N // Nkv
    qs = q.float().reshape(B, Nkv, G, D) * _sscale(scale, D)
    kc = torch.cat([k_cache[layer_idx].float(), k_fresh.float()], dim=2)  # [B, Nkv, S+1, D]
    vc = torch.cat([v_cache[layer_idx].float(), v_fresh.float()], dim=2)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, kc)
    allow = _cache_allow(slot_mask, length, S_max, q.device)
    allow = torch.cat([allow, torch.ones_like(allow[:, :1])], dim=1)
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, vc) / l.clamp(min=1e-30)
    return out.reshape(B, 1, N, D).to(q.dtype)


def decode_attention_fresh_int8_plain(
    q, k_fresh, v_fresh, kq, ks, vq, vs, layer_idx, slot_mask, length, scale=None
):
    """:func:`decode_attention_fresh_plain` over an INT8 cache with per-token
    scales: scores are dots of q's values with the codes, times ``ks * scale``;
    probabilities times ``vs`` round to q's type before they meet the value
    codes. The fresh k/v arrive unquantized and take their int8 round trip
    (quantize, dequantize to q's type) first, so attention sees what later
    steps read back from the cache; they merge in fp32."""
    k_fresh = dequantize_kv(quantize_kv(k_fresh), q.dtype)
    v_fresh = dequantize_kv(quantize_kv(v_fresh), q.dtype)
    B, _, N, D = q.shape
    _, _, Nkv, S_max, _ = kq.shape
    G = N // Nkv
    sscale = _sscale(scale, D)
    qt = q.float().reshape(B, Nkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qt, kq[layer_idx].float())
    s = s * (ks[layer_idx] * sscale)[:, :, None, :]
    allow = _cache_allow(slot_mask, length, S_max, q.device)
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    sf = torch.einsum("bhgd,bhd->bhg", qt * sscale, k_fresh.float()[:, :, 0])[..., None]
    m = torch.maximum(s.amax(dim=-1, keepdim=True), sf)
    p = torch.exp2(s - m)
    pf = torch.exp2(sf - m)
    l = p.sum(dim=-1, keepdim=True) + pf
    pw = (p * vs[layer_idx][:, :, None, :]).to(q.dtype).float()
    acc = torch.einsum("bhgk,bhkd->bhgd", pw, vq[layer_idx].float())
    acc = acc + pf * v_fresh.float()[:, :, 0][:, :, None, :]
    out = acc / l.clamp(min=1e-30)
    return out.reshape(B, 1, N, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
# The decode wrappers run once per layer per step, and the eager decode loop is
# bound by host time, so the checks below are written to be cheap: no message
# is formatted unless a check fails.


def _stream(*tensors) -> int:
    """Raw handle of the current stream of the current CUDA device; every tensor
    must be contiguous and on that device."""
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(
                f"kernel inputs must be contiguous tensors on cuda:{dev}, got one on "
                f"{t.device} (contiguous={t.is_contiguous()})"
            )
    return torch._C._cuda_getCurrentRawStream(dev)


def _float_kind(*tensors) -> int:
    """1 for bf16, 0 for fp32; raises on a mix or another type."""
    dt = tensors[0].dtype
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise TypeError(f"the kernel takes bfloat16 or float32, got {dt}")
    for t in tensors:
        if t.dtype is not dt:
            raise TypeError(f"dtype mismatch: {[t.dtype for t in tensors]}")
    return int(dt is torch.bfloat16)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")


def _layer_ptr(t: torch.Tensor, layer_idx: int) -> int:
    if type(layer_idx) is not int or not 0 <= layer_idx < t.shape[0]:
        raise ValueError(f"layer_idx must be a Python int in [0, {t.shape[0]}), got {layer_idx!r}")
    return t.data_ptr() + layer_idx * t.stride(0) * t.element_size()


def flash_attention_prefill(q, k, v, input_mask, scale=None, window=None):
    """Causal GQA flash attention over a left-padded prompt → [B, S, N, D]."""
    if q.device.type == "cpu":
        return flash_attention_prefill_plain(q, k, v, input_mask, scale, window)
    from lia_tpu_torch.ops import _build

    B, S, N, D = q.shape
    Nkv = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    stream = _stream(q, k, v, input_mask)
    if q.dtype is not torch.bfloat16 or k.dtype is not torch.bfloat16 or v.dtype is not torch.bfloat16:
        raise TypeError(f"the prefill kernel takes bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q/k/v must be 16-byte aligned (the kernel loads 16-byte vectors)")
    if k.shape != (B, Nkv, S, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, N_kv, S, D] = {(B, Nkv, S, D)}, got {tuple(k.shape)}, {tuple(v.shape)}")
    if input_mask.shape != (B, S) or input_mask.dtype is not torch.bool:
        raise ValueError("input_mask must be [B, S] bool")
    if D not in KERNEL_DIMS or N % Nkv or N // Nkv > 64:
        raise ValueError(f"unsupported head shape N={N}, N_kv={Nkv}, D={D}")
    out = torch.empty_like(q)
    rc = _build.library("flash_prefill").lia_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), input_mask.data_ptr(), out.data_ptr(),
        B, S, N, Nkv, D, _sscale(scale, D), int(window or 0), stream,
    )
    _raise_on(rc, "flash_attention_prefill")
    flash_attention_prefill.launches += 1
    return out


def _plane_checks(q, plane_shape, slot_mask, lengths):
    """q [B, 1, N, D] against one cache plane's shape [B, N_kv, S_max, D]."""
    B, one, N, D = q.shape
    Bc, Nkv, S_max, Dc = plane_shape
    if one != 1 or Bc != B or Dc != D:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache plane {tuple(plane_shape)}")
    if slot_mask.shape != (B, S_max) or slot_mask.dtype is not torch.bool:
        raise ValueError("slot_mask must be [B, S_max] bool")
    if lengths.ndim and lengths.shape != (B,):
        raise ValueError("length must be a scalar or [B]")
    if D not in KERNEL_DIMS or N % Nkv or N // Nkv not in KERNEL_GROUPS:
        raise ValueError(f"unsupported head shape N={N}, N_kv={Nkv}, D={D}")


def _decode_checks(q, k_fresh, v_fresh, cache, slot_mask, lengths):
    """q and the fresh k/v against a stacked cache [L, B, N_kv, S_max, D]."""
    if cache.dim() != 5:
        raise ValueError(f"the cache must be [L, B, N_kv, S_max, D], got {tuple(cache.shape)}")
    _plane_checks(q, cache.shape[1:], slot_mask, lengths)
    B, _, _, D = q.shape
    if k_fresh.shape != (B, cache.shape[2], 1, D) or v_fresh.shape != k_fresh.shape:
        raise ValueError("fresh k/v must be [B, N_kv, 1, D]")


def _decode(q, kc_ptr, vc_ptr, plane_shape, k_cache, v_cache, slot_mask, length, scale):
    """Launch ``lia_decode`` over one plane of ``plane_shape`` [B, N_kv, S_max,
    D] at kc_ptr/vc_ptr (inside k_cache/v_cache)."""
    from lia_tpu_torch.ops import _build

    B, _, N, D = q.shape
    _, Nkv, S_max, _ = plane_shape
    q = q.contiguous()
    lengths = _lengths(length, q.device)
    stream = _stream(q, k_cache, v_cache, slot_mask, lengths)
    is_bf16 = _float_kind(q, k_cache, v_cache)
    _plane_checks(q, plane_shape, slot_mask, lengths)
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v caches differ in shape")
    out = torch.empty_like(q)
    rc = _build.library("decode").lia_decode(
        q.data_ptr(), kc_ptr, vc_ptr, slot_mask.data_ptr(), lengths.data_ptr(),
        1 if lengths.ndim else 0, out.data_ptr(), B, N, Nkv, S_max, D, _sscale(scale, D), is_bf16, stream,
    )
    return rc, out


def decode_attention(q, k_cache, v_cache, slot_mask, length, scale=None):
    """Decode attention over one layer plane [B, N_kv, S_max, D] that already
    holds this step's token; ``length`` (0-dim or [B]) includes it."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, slot_mask, length, scale)
    rc, out = _decode(q, k_cache.data_ptr(), v_cache.data_ptr(), k_cache.shape, k_cache, v_cache,
                      slot_mask, length, scale)
    _raise_on(rc, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention_stacked(q, k_cache, v_cache, layer_idx, slot_mask, length, scale=None):
    """:func:`decode_attention` over layer ``layer_idx`` of the stacked cache
    [L, B, N_kv, S_max, D], read in place (the kernel starts at the layer's
    offset). Backs both of the reference's stacked entry points
    (``decode_attention_stacked`` and ``decode_attention_stacked_dma``)."""
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, k_cache, v_cache, layer_idx, slot_mask, length, scale)
    if k_cache.dim() != 5:
        raise ValueError(f"the cache must be [L, B, N_kv, S_max, D], got {tuple(k_cache.shape)}")
    rc, out = _decode(q, _layer_ptr(k_cache, layer_idx), _layer_ptr(v_cache, layer_idx), k_cache.shape[1:],
                      k_cache, v_cache, slot_mask, length, scale)
    _raise_on(rc, "decode_attention_stacked")
    decode_attention_stacked.launches += 1
    return out


def decode_attention_fresh(
    q, k_fresh, v_fresh, k_cache, v_cache, layer_idx, slot_mask, length, scale=None
):
    """Decode attention over layer ``layer_idx``'s cache plane + the fresh token."""
    if q.device.type == "cpu":
        return decode_attention_fresh_plain(
            q, k_fresh, v_fresh, k_cache, v_cache, layer_idx, slot_mask, length, scale
        )
    from lia_tpu_torch.ops import _build

    B, _, N, D = q.shape
    _, _, Nkv, S_max, _ = k_cache.shape
    q, k_fresh, v_fresh = q.contiguous(), k_fresh.contiguous(), v_fresh.contiguous()
    lengths = _lengths(length, q.device)
    stream = _stream(q, k_fresh, v_fresh, k_cache, v_cache, slot_mask, lengths)
    is_bf16 = _float_kind(q, k_fresh, v_fresh, k_cache, v_cache)
    _decode_checks(q, k_fresh, v_fresh, k_cache, slot_mask, lengths)
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v caches differ in shape")
    out = torch.empty_like(q)
    rc = _build.library("decode_fresh").lia_decode_fresh(
        q.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr(),
        _layer_ptr(k_cache, layer_idx), _layer_ptr(v_cache, layer_idx),
        slot_mask.data_ptr(), lengths.data_ptr(), 1 if lengths.ndim else 0, out.data_ptr(),
        B, N, Nkv, S_max, D, _sscale(scale, D), is_bf16, stream,
    )
    _raise_on(rc, "decode_attention_fresh")
    decode_attention_fresh.launches += 1
    return out


def decode_attention_fresh_int8(
    q, k_fresh, v_fresh, kq, ks, vq, vs, layer_idx, slot_mask, length, scale=None
):
    """Fresh-merge decode attention over an INT8 stacked cache (codes [L, B, N_kv,
    S_max, D] int8, scales [L, B, N_kv, S_max] f32). The fresh k/v come
    unquantized, in q's type; the kernel takes them through their int8 round
    trip itself."""
    if q.device.type == "cpu":
        return decode_attention_fresh_int8_plain(
            q, k_fresh, v_fresh, kq, ks, vq, vs, layer_idx, slot_mask, length, scale
        )
    from lia_tpu_torch.ops import _build

    B, _, N, D = q.shape
    _, _, Nkv, S_max, _ = kq.shape
    q, k_fresh, v_fresh = q.contiguous(), k_fresh.contiguous(), v_fresh.contiguous()
    lengths = _lengths(length, q.device)
    stream = _stream(q, k_fresh, v_fresh, kq, ks, vq, vs, slot_mask, lengths)
    is_bf16 = _float_kind(q, k_fresh, v_fresh)
    _decode_checks(q, k_fresh, v_fresh, kq, slot_mask, lengths)
    if kq.dtype is not torch.int8 or vq.dtype is not torch.int8 or vq.shape != kq.shape:
        raise ValueError("kq/vq must be int8 [L, B, N_kv, S_max, D]")
    if (ks.dtype is not torch.float32 or vs.dtype is not torch.float32
            or ks.shape != kq.shape[:-1] or vs.shape != ks.shape):
        raise ValueError("ks/vs must be float32 [L, B, N_kv, S_max]")
    out = torch.empty_like(q)
    rc = _build.library("decode_fresh_int8").lia_decode_fresh_int8(
        q.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr(),
        _layer_ptr(kq, layer_idx), _layer_ptr(ks, layer_idx),
        _layer_ptr(vq, layer_idx), _layer_ptr(vs, layer_idx),
        slot_mask.data_ptr(), lengths.data_ptr(), 1 if lengths.ndim else 0, out.data_ptr(),
        B, N, Nkv, S_max, D, _sscale(scale, D), is_bf16, stream,
    )
    _raise_on(rc, "decode_attention_fresh_int8")
    decode_attention_fresh_int8.launches += 1
    return out


KERNELS = (
    flash_attention_prefill, decode_attention_fresh, decode_attention_fresh_int8,
    decode_attention, decode_attention_stacked,
)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
