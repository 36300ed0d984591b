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
for a left-padded prompt, ``[start, base + t]`` for chunk row t over a cache
plane and ``[start, length)`` for decode over one, with ``start`` the end of the
range minus ``popcount(mask)``; ``[0, length)`` over a paged pool, whose pages
the kernel finds through the block table; over the grouped beam cache, the
group's prompt slots ``[pstart_g, plen)`` and then the beam's tail slots ``[0,
tlen)``, with ``pstart_g = plen - popcount(prompt_mask[g])``. The kernels count it on the device and
read ``length``, ``base`` and the block table from device memory, so a decode
step or an admission never syncs with the host.

ALiBi: every wrapper and plain version takes ``slopes`` (fp32 [N], one a query
head; None without ALiBi). A kernel adds ``slope * (key_pos - query_pos) *
log2(e)`` in fp32 to each score after the scaled dot product, with both
positions taken from the layout it walks (a slot's place in its valid range,
a tail slot's index after the prompt, a paged key's logical index, the fresh
token or chunk row after the keys): no [B, N, S] bias is built or read, and
the fresh token's own term is 0. Softmax is invariant to a per-query
constant, so this is the reference's key-only ``slope * key_pos``
(``alibi_slot_bias`` and its kin) shifted by ``slope * query_pos``; it keeps
every biased score at or below its dot product, so no running max sees the
bias's thousands. A plain version adds the reference's own bias
(:func:`lia_tpu_torch.ops.attention.alibi_bias` over the slots' ranks).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from lia_tpu_torch.ops.quant import dequantize_kv, quantize_kv

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL_DIMS = (64, 80, 96, 112, 128, 256)  # head dims the kernels take: 80, 96 and 112 run the 128-wide
# bodies over zero-padded dims (csrc/*.cuh: DP), rows still D apart in memory
KERNEL_MAX_GROUP = 128  # largest GQA group G = N / N_kv the attention kernels take (any G from 1 up:
# each splits a kv head's queries into chunks; checked on an H100 at G = 1, 2, 3, 4, 8, 16, 71 and 128)
FLASH_ROWS = 64  # query rows of one flash tile: 64 / G positions x G heads, or past G = 64 flat (position,
# head) rows t * G + g
FLASH_BK = 64  # keys of one flash K/V tile
FLASH_MAX_PARTS = 16
PAGED_WARPS = 4  # consumer warps of a paged block (csrc/paged_attn.cuh: NWC)
PAGED_MAX_TABLE = 256  # block-table entries one paged block stages (csrc/paged_attn.cuh: MAXP)
PAGED_MAX_PARTS = 8
INT8_QUERIES = 8  # queries one int8 decode block holds (csrc/decode_int8_attn.cuh: NQ)
INT8_MAX_PARTS = 8
INT8_PART_KEYS = 1024  # keys of a unit's longest walk a part takes at least: splits of walks
# up to 1152 keys lost or tied on an H100 (chip_smoke.py's forced-split rows)
BEAM_QUERIES = 16  # queries one bf16 beam block holds (csrc/beam_attn.cuh: NQ); 8 at D = 256 (beam_queries)
PLANE_MAX_GROUP = 1  # bf16 plane decode (B2, B7/B8) up to this group runs the plane body
# (csrc/plane_attn.cuh), past it the bf16 beam body at one beam a block (csrc/decode.cu): in one call on
# an H100 at b16, 272 keys (chip_smoke.py's plane_checks rows, each body forced, when the plane body was
# built up to 8 heads; PERF.md §6), B2 / B7 ms, plane against beam: G = 2 0.01764 / 0.01758 against
# 0.01668 / 0.01680, G = 4 0.01254 / 0.01229 against 0.01112 / 0.01119, G = 4 at D 256 0.01572 /
# 0.01512 against 0.01361 / 0.01290, G = 8 0.01924 / 0.01634 against 0.01113 / 0.00980; at G = 1
# plane_checks times the beam body beside the plane body's route every run
PLANE_WARPS = 4  # consumer warps of a plane block (csrc/plane_attn.cuh: NWC)
PLANE_BLOCKS_AN_SM = 4  # plane blocks an SM holds (the kernel's __launch_bounds__: BLOCKS_AN_SM)
PLANE_STAGE_KEYS = 4  # keys each lane group of a plane block takes from a ring stage (KT_STAGE)
PLANE_MAX_STAGES = 16
PLANE_MAX_PARTS = 8
PLANE_PART_KEYS = 64  # slots of the plane a plane part takes at least
SM_SMEM = 228 * 1024  # shared memory of an H100 SM, and the most one block takes
BLOCK_SMEM = 227 * 1024
BEAM_MAX_PARTS = 8
BEAM_PART_KEYS = 64  # keys of a group's longest walk a bf16 beam part takes at least (a ring stage):
# on an H100 a split lost at one block an SM (4 x 4 beams, 32 heads: 128 blocks) and won at
# Llama-3-8B's 32 blocks over 256 and 1024 prompt slots (chip_smoke.py's forced-split rows)


def beam_queries(D: int) -> int:
    """Queries one bf16 beam block holds at head dim D (csrc/beam_attn.cuh:
    qn): one n8 column tile at D = 256, so its O^T fragments fit the
    registers."""
    return 8 if D > 128 else BEAM_QUERIES


def _sscale(scale: Optional[float], D: int) -> float:
    """Softmax scale in exp2 units, as the TPU kernels fold it."""
    return (scale if scale is not None else D**-0.5) * LOG2E


def _contiguous_starts(mask: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    return length - mask.to(torch.int32).sum(dim=1)


def _lengths(length: Union[int, torch.Tensor], device) -> torch.Tensor:
    """``length`` (int, 0-dim or [B]) as an int32 tensor on ``device``; a kernel
    reads element ``b * stride(0)``, so a 0-dim length serves every row. An
    int32 tensor already there comes back as it is, without the conversion
    calls (a few µs of a decode wrapper's host time)."""
    if type(length) is torch.Tensor and length.dtype is torch.int32 and length.device == device:
        return length
    return torch.as_tensor(length, device=device).to(torch.int32)


def _alibi_exp2(slopes, key_pos: torch.Tensor, Nkv: int) -> torch.Tensor:
    """The reference's ALiBi bias over logical key positions [B, S] in exp2
    units, [B, N_kv, G, S]; 0 without slopes."""
    if slopes is None:
        return torch.zeros((), device=key_pos.device)
    from lia_tpu_torch.ops.attention import alibi_bias

    bias = alibi_bias(slopes.to(key_pos.device), key_pos) * LOG2E
    return bias.reshape(bias.shape[0], Nkv, -1, bias.shape[2])


def _ranks(allow: torch.Tensor) -> torch.Tensor:
    """Each allowed slot's rank among the allowed slots of its row [B, S]
    (the reference's ``alibi_slot_bias`` positions)."""
    from lia_tpu_torch.ops.attention import slot_positions

    return slot_positions(allow)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def flash_attention_cached_plain(q, k_cache, v_cache, base, slot_mask, scale=None, window=None, slopes=None):
    """Chunk-over-cache causal attention with the kernel's precision: dots of
    input-type values summed in fp32, the scale applied after the dot in exp2
    units, probabilities rounded to V's type before P.V. q [B, C, N, D]; k/v
    [B, N_kv, S_max, D] already holding the chunk; base int, 0-dim or [B];
    slot_mask [B, S_max] bool → [B, C, N, D]. Chunk row t sits at slot
    base_b + t and attends [start_b, base_b + t] (with ``window``, only keys
    > base_b + t - window), start_b = base_b + C - popcount(slot_mask[b]).
    Fully masked (pad) rows are finite but meaningless, as in the kernel.
    With ``slopes``, the scores take the reference's ALiBi bias at each
    slot's rank among the valid slots (``alibi_slot_bias``; for a prompt,
    ``alibi_prefill_bias``)."""
    B, C, N, D = q.shape
    _, Nkv, S_max, _ = k_cache.shape
    G = N // Nkv
    bases = _lengths(base, q.device).expand(B)
    starts = bases + C - slot_mask.to(torch.int32).sum(dim=1)
    qf = q.float().reshape(B, C, Nkv, G, D)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, k_cache.float()) * _sscale(scale, D)
    if slopes is not None:
        s = s + _alibi_exp2(slopes, _ranks(slot_mask), Nkv)[:, :, :, None, :]
    qpos = (bases[:, None] + torch.arange(C, device=q.device))[:, :, None]  # [B, C, 1]
    kpos = torch.arange(S_max, device=q.device)[None, None, :]
    masked = (kpos > qpos) | (kpos < starts[:, None, None])
    if window is not None:
        masked = masked | (kpos <= qpos - window)
    s = torch.where(masked[:, None, None], torch.full_like(s, NEG_INF), s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_cache.dtype).float(), v_cache.float())
    out = acc / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, N, D).to(q.dtype)


def flash_attention_prefill_plain(q, k, v, input_mask, scale=None, window=None, slopes=None):
    """Causal attention over a left-padded prompt: :func:`flash_attention_cached_plain`
    with base 0 over the prompt's own plane (the kernel's precision).
    q [B, S, N, D]; k/v [B, N_kv, S, D]; input_mask [B, S] bool → [B, S, N, D]."""
    return flash_attention_cached_plain(q, k, v, 0, input_mask, scale, window, slopes)


def flash_tile_rows(C: int, G: int, device=None):
    """First and last chunk position of the flash tile that holds each (chunk
    row t, head g), [C, G] each: up to G = 64 a tile holds 64 // G whole
    positions; past it the 64 flat rows f = t * G + g from 64 * (f // 64), so
    a position's heads straddle two tiles."""
    if G <= FLASH_ROWS:
        per = FLASH_ROWS // G
        t = torch.arange(C, device=device)[:, None].expand(C, G)
        return t // per * per, torch.clamp(t // per * per + per, max=C) - 1
    f = torch.arange(C * G, device=device).reshape(C, G)
    f0 = f // FLASH_ROWS * FLASH_ROWS
    return f0 // G, (torch.clamp(f0 + FLASH_ROWS, max=C * G) - 1) // G


def flash_partials_plain(q, k_cache, v_cache, base, slot_mask, parts, scale=None, window=None):
    """The flash kernels' split walk in plain torch: each 64-row tile of flat
    (chunk row, head) rows t * G + g walks the 64-key tiles [j_lo, j_hi) that
    are not fully masked for any of its rows (:func:`flash_tile_rows`), and
    part p of ``parts`` takes tiles [j_lo + n p / parts, j_lo + n (p + 1) /
    parts), n = j_hi - j_lo. Inside a part's tiles a masked key scores -1e30,
    as in the kernel. Arguments as :func:`flash_attention_cached_plain`;
    returns the fp32 partials (o unnormalised [parts, B, C, N, D], m and l
    [parts, B, C, N]) the kernel writes to its workspace; a part with no
    tiles has m = -inf, l = 0, o = 0."""
    B, C, N, D = q.shape
    _, Nkv, S_max, _ = k_cache.shape
    G = N // Nkv
    dev = q.device
    bases = _lengths(base, dev).expand(B).long()
    starts = bases + C - slot_mask.to(torch.int64).sum(dim=1)
    t = torch.arange(C, device=dev)
    pos0, last = flash_tile_rows(C, G, dev)  # [C, G]
    j_lo = (starts.clamp(min=0) // FLASH_BK)[:, None, None].expand(B, C, G)
    if window is not None:
        j_lo = torch.maximum(j_lo, (bases[:, None, None] + pos0 - window + 1).clamp(min=0) // FLASH_BK)
    j_hi = torch.clamp((bases[:, None, None] + last) // FLASH_BK + 1, max=-(-S_max // FLASH_BK))
    n = (j_hi - j_lo).clamp(min=0)  # [B, C, G]
    qf = q.float().reshape(B, C, Nkv, G, D)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, k_cache.float()) * _sscale(scale, D)
    qpos = (bases[:, None] + t)[:, :, None]  # [B, C, 1]
    kpos = torch.arange(S_max, device=dev)[None, None, :]
    masked = (kpos > qpos) | (kpos < starts[:, None, None])
    if window is not None:
        masked = masked | (kpos <= qpos - window)
    s = torch.where(masked[:, None, None], torch.full_like(s, NEG_INF), s)
    jk = kpos[..., None, :] // FLASH_BK  # [1, 1, 1, S]
    o, m, l = [], [], []
    for p in range(parts):
        lo, hi = j_lo + n * p // parts, j_lo + n * (p + 1) // parts  # [B, C, G]
        inside = ((jk >= lo[..., None]) & (jk < hi[..., None])).permute(0, 2, 1, 3)[:, None]  # [B, 1, G, C, S]
        mp = torch.where(inside, s, torch.full_like(s, -float("inf"))).amax(dim=-1, keepdim=True)
        pr = torch.where(inside, torch.exp2(s - mp), torch.zeros_like(s))
        acc = torch.einsum("bhgqk,bhkd->bhgqd", pr.to(v_cache.dtype).float(), v_cache.float())
        o.append(acc.permute(0, 3, 1, 2, 4).reshape(B, C, N, D))
        m.append(mp[..., 0].permute(0, 3, 1, 2).reshape(B, C, N))
        l.append(pr.sum(dim=-1).permute(0, 3, 1, 2).reshape(B, C, N))
    return torch.stack(o), torch.stack(m), torch.stack(l)


def flash_merge_plain(o, m, l):
    """The merge of the flash kernels' split, in plain torch: out = sum_i 2^(m_i
    - m) o_i / max(sum_i 2^(m_i - m) l_i, 1e-30), m the largest m_i, parts with
    m_i = -inf left out. o [parts, ..., D]; m, l [parts, ...] → [..., D]."""
    empty = m == -float("inf")
    w = torch.where(empty, torch.zeros_like(m), torch.exp2(m - m.amax(dim=0)))
    acc = (w[..., None] * torch.where(empty[..., None], torch.zeros_like(o), o)).sum(dim=0)
    return acc / (w * l).sum(dim=0).clamp(min=1e-30)[..., None]


def _cache_allow(slot_mask, length, S_max, device):
    lengths = _lengths(length, device).expand(slot_mask.shape[0])
    starts = _contiguous_starts(slot_mask, lengths)
    pos = torch.arange(S_max, device=device)[None, :]
    return (pos < lengths[:, None]) & (pos >= starts[:, None])  # [B, S_max]


def decode_attention_plain(q, k_cache, v_cache, slot_mask, length, scale=None, slopes=None):
    """One query per sequence over one layer plane's [start, length), all in
    fp32; the plane already holds this step's token and ``length`` counts it.
    q [B, 1, N, D]; k/v [B, N_kv, S_max, D]; slot_mask [B, S_max]; length int,
    0-dim or [B]. With ``slopes``, the reference's ALiBi bias at each valid
    slot's rank."""
    B, _, N, D = q.shape
    _, Nkv, S_max, _ = k_cache.shape
    G = N // Nkv
    qs = q.float().reshape(B, Nkv, G, D) * _sscale(scale, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, k_cache.float())
    allow = _cache_allow(slot_mask, length, S_max, q.device)
    if slopes is not None:
        s = s + _alibi_exp2(slopes, _ranks(allow), Nkv)
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allow[:, None, None], torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) / l.clamp(min=1e-30)
    return out.reshape(B, 1, N, D).to(q.dtype)


def decode_attention_stacked_plain(q, k_cache, v_cache, layer_idx, slot_mask, length, scale=None, slopes=None):
    """:func:`decode_attention_plain` over layer ``layer_idx`` of the stacked
    cache [L, B, N_kv, S_max, D]."""
    return decode_attention_plain(q, k_cache[layer_idx], v_cache[layer_idx], slot_mask, length, scale, slopes)


def _fresh_merge_plain(q, k_fresh, v_fresh, k, v, allow, scale, slopes=None, key_pos=None):
    """One query per sequence over the keys of k/v [B, N_kv, S, D] that
    ``allow`` [B, S] marks, then the fresh token [B, N_kv, 1, D], all in fp32;
    with ``slopes``, the ALiBi bias at ``key_pos`` [B, S + 1] (the fresh
    token's last)."""
    B, _, N, D = q.shape
    Nkv = k.shape[1]
    G = N // Nkv
    qs = q.float().reshape(B, Nkv, G, D) * _sscale(scale, D)
    kc = torch.cat([k.float(), k_fresh.float()], dim=2)  # [B, Nkv, S+1, D]
    vc = torch.cat([v.float(), v_fresh.float()], dim=2)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, kc)
    if slopes is not None:
        s = s + _alibi_exp2(slopes, key_pos, Nkv)
    allow = torch.cat([allow, torch.ones_like(allow[:, :1])], dim=1)
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, vc) / l.clamp(min=1e-30)
    return out.reshape(B, 1, N, D).to(q.dtype)


def _int8_merge_plain(q, k_fresh, v_fresh, kq, ks, vq, vs, allow, scale, slopes=None, key_pos=None):
    """One query per sequence over the int8 keys (codes [B, N_kv, S, D], scales
    [B, N_kv, S]) that ``allow`` [B, S] marks, then the fresh token (values in
    q's type): scores are dots of q's values with the codes, times ``ks *
    scale``; probabilities times ``vs`` round to q's type before they meet the
    value codes, taken against the keys' own max as the kernels' online
    softmax (and the Pallas kernels') takes them before the fresh token is
    seen; the fresh token then merges in fp32, rescaling the keys' sums.
    With ``slopes``, the ALiBi bias at ``key_pos`` [B, S + 1] (the fresh
    token's last)."""
    B, _, N, D = q.shape
    Nkv = kq.shape[1]
    G = N // Nkv
    sscale = _sscale(scale, D)
    qt = q.float().reshape(B, Nkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qt, kq.float())
    s = s * (ks * sscale)[:, :, None, :]
    sf = torch.einsum("bhgd,bhd->bhg", qt * sscale, k_fresh.float()[:, :, 0])[..., None]
    if slopes is not None:
        bias = _alibi_exp2(slopes, key_pos, Nkv)
        s, sf = s + bias[..., :-1], sf + bias[..., -1:]
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    mk = s.amax(dim=-1, keepdim=True)  # the keys' max (NEG_INF for a row without keys)
    m = torch.maximum(mk, sf)
    p = torch.where(allow[:, None, None], torch.exp2(s - mk), torch.zeros_like(s))
    alpha, pf = torch.exp2(mk - m), torch.exp2(sf - m)
    l = p.sum(dim=-1, keepdim=True) * alpha + pf
    pw = (p * vs[:, :, None, :]).to(q.dtype).float()
    acc = torch.einsum("bhgk,bhkd->bhgd", pw, vq.float()) * alpha
    acc = acc + pf * v_fresh.float()[:, :, 0][:, :, None, :]
    out = acc / l.clamp(min=1e-30)
    return out.reshape(B, 1, N, D).to(q.dtype)


def _fresh_positions(allow: torch.Tensor) -> torch.Tensor:
    """Logical positions [B, S + 1] of a plane's valid slots (their ranks) and
    of the fresh token after them (the reference's ``alibi_slot_bias`` with
    the fresh slot pre-filled)."""
    return torch.cat([_ranks(allow), allow.to(torch.int32).sum(dim=1, keepdim=True)], dim=1)


def decode_attention_fresh_plain(
    q, k_fresh, v_fresh, k_cache, v_cache, layer_idx, slot_mask, length, scale=None, slopes=None
):
    """One query per sequence over cache[layer_idx][start, length) ∪ {fresh token},
    all in fp32. q [B, 1, N, D]; fresh k/v [B, N_kv, 1, D];
    cache [L, B, N_kv, S_max, D]; slot_mask [B, S_max]; length int, 0-dim or [B]."""
    allow = _cache_allow(slot_mask, length, k_cache.shape[3], q.device)
    key_pos = _fresh_positions(allow) if slopes is not None else None
    return _fresh_merge_plain(q, k_fresh, v_fresh, k_cache[layer_idx], v_cache[layer_idx], allow, scale, slopes,
                              key_pos)


def decode_attention_fresh_int8_plain(
    q, k_fresh, v_fresh, kq, ks, vq, vs, layer_idx, slot_mask, length, scale=None, slopes=None
):
    """:func:`decode_attention_fresh_plain` over an INT8 cache with per-token
    scales (the arithmetic of :func:`_int8_merge_plain`). The fresh k/v arrive
    unquantized and take their int8 round trip (quantize, dequantize to q's
    type) first, so attention sees what later steps read back from the cache."""
    k_fresh = dequantize_kv(quantize_kv(k_fresh), q.dtype)
    v_fresh = dequantize_kv(quantize_kv(v_fresh), q.dtype)
    allow = _cache_allow(slot_mask, length, kq.shape[3], q.device)
    key_pos = _fresh_positions(allow) if slopes is not None else None
    return _int8_merge_plain(q, k_fresh, v_fresh, kq[layer_idx], ks[layer_idx], vq[layer_idx], vs[layer_idx],
                             allow, scale, slopes, key_pos)


def _check_beams(B: int, B0: int, nb: int) -> None:
    if nb < 1 or B != B0 * nb:
        raise ValueError(f"{B} beam rows are not {B0} groups of nb = {nb} beams (nb must divide the batch)")


def _beam_allow(prompt_mask, prompt_len, tail_len, nb: int, T_max: int, device):
    """Validity [B0 * nb, S_p + T_max] of a beam's keys: its group's prompt
    slots [pstart_g, plen), pstart_g = plen - popcount(prompt_mask[g]), then
    its tail slots [0, tlen)."""
    B0, S_p = prompt_mask.shape
    plen = _lengths(prompt_len, device).clamp(0, S_p)
    tlen = _lengths(tail_len, device).clamp(0, T_max)
    pstart = (plen - prompt_mask.to(torch.int32).sum(dim=1)).clamp(min=0)
    pos = torch.arange(S_p, device=device)[None, :]
    allow_p = ((pos >= pstart[:, None]) & (pos < plen)).repeat_interleave(nb, dim=0)
    allow_t = (torch.arange(T_max, device=device) < tlen)[None, :].expand(B0 * nb, T_max)
    return torch.cat([allow_p, allow_t], dim=1)


def _beam_positions(allow: torch.Tensor, S_p: int, T_max: int) -> torch.Tensor:
    """Logical positions [B, S_p + T_max + 1] over a beam's [prompt | tail |
    fresh] layout (:func:`_beam_allow`'s): a valid prompt slot's rank, tail
    slot t at real_len + t, the fresh token at real_len + tlen (the
    reference's ``_alibi_beam_bias``)."""
    real = allow[:, :S_p].to(torch.int32).sum(dim=1, keepdim=True)
    tail = real + torch.arange(T_max, dtype=torch.int32, device=allow.device)[None, :]
    fresh = real + allow[:, S_p:].to(torch.int32).sum(dim=1, keepdim=True)
    return torch.cat([_ranks(allow[:, :S_p]).to(torch.int32), tail, fresh], dim=1)


def decode_beam_attention_plain(
    q, k_fresh, v_fresh, kp, vp, kt, vt, layer_idx, prompt_mask, prompt_len, tail_len, nb, scale=None, slopes=None
):
    """Grouped-beam decode attention, all in fp32: beam b's query [B, 1, N, D]
    over layer ``layer_idx`` of its group's prompt plane (kp/vp [L, B0, N_kv,
    S_p, D], group b // nb, slots [pstart_g, plen)), then its own tail
    (kt/vt [L, B, N_kv, T_max, D], slots [0, tlen)), then the fresh token
    [B, N_kv, 1, D]. prompt_mask [B0, S_p] bool; prompt_len and tail_len
    scalars. B = B0 * nb."""
    _check_beams(q.shape[0], kp.shape[1], nb)
    allow = _beam_allow(prompt_mask, prompt_len, tail_len, nb, kt.shape[3], q.device)
    k = torch.cat([kp[layer_idx].repeat_interleave(nb, dim=0), kt[layer_idx]], dim=2)
    v = torch.cat([vp[layer_idx].repeat_interleave(nb, dim=0), vt[layer_idx]], dim=2)
    key_pos = _beam_positions(allow, kp.shape[3], kt.shape[3]) if slopes is not None else None
    return _fresh_merge_plain(q, k_fresh, v_fresh, k, v, allow, scale, slopes, key_pos)


def decode_beam_attention_int8_plain(
    q, k_fresh, v_fresh, kpq, kps, vpq, vps, ktq, kts, vtq, vts, layer_idx, prompt_mask, prompt_len, tail_len,
    nb, scale=None, slopes=None,
):
    """:func:`decode_beam_attention_plain` over INT8 prompt and tail planes
    (codes [L, ·, N_kv, S, D], per-token scales [L, ·, N_kv, S]) with the
    arithmetic of :func:`_int8_merge_plain`; the fresh k/v arrive already
    dequantized to q's type."""
    _check_beams(q.shape[0], kpq.shape[1], nb)
    allow = _beam_allow(prompt_mask, prompt_len, tail_len, nb, ktq.shape[3], q.device)

    def keys(prompt, tail):
        return torch.cat([prompt[layer_idx].repeat_interleave(nb, dim=0), tail[layer_idx]], dim=2)

    key_pos = _beam_positions(allow, kpq.shape[3], ktq.shape[3]) if slopes is not None else None
    return _int8_merge_plain(q, k_fresh, v_fresh, keys(kpq, ktq), keys(kps, kts), keys(vpq, vtq),
                             keys(vps, vts), allow, scale, slopes, key_pos)


def paged_decode_attention_plain(
    q, k_pool, v_pool, layer_idx, block_table, lengths, k_fresh=None, v_fresh=None, scale=None, slopes=None
):
    """C queries per sequence over layer ``layer_idx`` of a paged pool [L, nb,
    N_kv, bs, D], all in fp32: keys [0, length_b) of the pages
    ``block_table[b]`` in order, then (with the fresh chunk [B, N_kv, C, D])
    chunk row c merges fresh keys 0..c. q [B, C, N, D]; block_table int [B, P];
    lengths int, 0-dim or [B]. A row with nothing to attend gives 0. With
    ``slopes``, the ALiBi bias at each key's logical index (a page key's
    place in the row, fresh key c at length_b + c), as the reference's
    ``attend_chunk_paged``."""
    B, C, N, D = q.shape
    _, _, Nkv, bs, _ = k_pool.shape
    P = block_table.shape[1]
    G = N // Nkv
    S = P * bs

    def gather(pool):  # the pages of each sequence in order: [B, N_kv, P*bs, D]
        pages = pool[layer_idx][block_table.long()]  # [B, P, N_kv, bs, D]
        return pages.permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, D).float()

    k, v = gather(k_pool), gather(v_pool)
    lens = _lengths(lengths, q.device).expand(B)
    allow = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, :].expand(B, C, S)
    if k_fresh is not None:
        k = torch.cat([k, k_fresh.float()], dim=2)
        v = torch.cat([v, v_fresh.float()], dim=2)
        tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=q.device))
        allow = torch.cat([allow, tri.expand(B, C, C)], dim=2)
    qs = q.float().reshape(B, C, Nkv, G, D) * _sscale(scale, D)
    s = torch.einsum("bchgd,bhkd->bhgck", qs, k)
    if slopes is not None:
        key_pos = torch.arange(S, device=q.device)[None, :].expand(B, S)
        if k_fresh is not None:
            key_pos = torch.cat([key_pos, lens[:, None] + torch.arange(C, device=q.device)[None, :]], dim=1)
        s = s + _alibi_exp2(slopes, key_pos, Nkv)[:, :, :, None, :]
    s = torch.where(allow[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allow[:, None, None], torch.exp2(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgck,bhkd->bhgcd", p, v) / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, N, D).to(q.dtype)


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


def _slopes_ptr(slopes: Optional[torch.Tensor], N: int, q: torch.Tensor) -> Optional[int]:
    """The address of the ALiBi slopes (fp32 [N], contiguous, on q's device)
    the kernel reads, or None without them."""
    if slopes is None:
        return None
    if (slopes.dtype is not torch.float32 or slopes.shape != (N,) or not slopes.is_contiguous()
            or slopes.get_device() != q.get_device()):
        raise ValueError(f"slopes must be contiguous float32 [N = {N}] on {q.device}, got {slopes.dtype} "
                         f"{tuple(slopes.shape)} on {slopes.device}")
    return slopes.data_ptr()


def _layer_ptr(t: torch.Tensor, layer_idx: int) -> int:
    if type(layer_idx) is not int or not 0 <= layer_idx < t.shape[0]:
        raise ValueError(f"layer_idx must be a Python int in [0, {t.shape[0]}), got {layer_idx!r}")
    return t.data_ptr() + layer_idx * t.stride(0) * t.element_size()


def _flash_checks(q, k, v, kv_mask, bases):
    """q [B, C, N, D] against a bf16 plane [B, N_kv, S_kv, D] and its mask."""
    B, C, N, D = q.shape
    Nkv, S_kv = k.shape[1], k.shape[2]
    if q.dtype is not torch.bfloat16 or k.dtype is not torch.bfloat16 or v.dtype is not torch.bfloat16:
        raise TypeError(f"the flash kernels take bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q/k/v must be 16-byte aligned (the kernel loads 16-byte vectors)")
    if k.shape != (B, Nkv, S_kv, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, N_kv, S, D] = {(B, Nkv, S_kv, D)}, got {tuple(k.shape)}, {tuple(v.shape)}")
    if kv_mask.shape != (B, S_kv) or kv_mask.dtype is not torch.bool:
        raise ValueError(f"the mask must be [B, S] = {(B, S_kv)} bool")
    if bases is not None and bases.ndim and bases.shape != (B,):
        raise ValueError("base must be a scalar or [B]")
    _check_heads(N, Nkv, D)


def _check_heads(N: int, Nkv: int, D: int) -> None:
    """The head shapes every attention kernel takes: D in KERNEL_DIMS and any
    group G = N / N_kv from 1 to KERNEL_MAX_GROUP."""
    if D not in KERNEL_DIMS or Nkv < 1 or N % Nkv or not 1 <= N // Nkv <= KERNEL_MAX_GROUP:
        raise ValueError(f"unsupported head shape N={N}, N_kv={Nkv}, D={D}")


def _flash_tiles(B: int, C: int, N: int, Nkv: int) -> int:
    """(row tile, kv head, batch row) tiles of a flash launch: each row tile
    holds 64 / G chunk positions of the G query heads of one kv head, or past
    G = 64, 64 of the C * G flat (position, head) rows."""
    G = N // Nkv
    rows = -(-C // (FLASH_ROWS // G)) if G <= FLASH_ROWS else -(-C * G // FLASH_ROWS)
    return rows * Nkv * B


def flash_split_parts(B: int, C: int, N: int, Nkv: int, S_kv: int, sms: int) -> int:
    """Parts into which the flash kernels split each tile's key walk: as many as
    keep the (row tile, kv head, batch row) tiles times the parts within the
    card's ``sms`` SMs, one block to an SM, so 1 from half the SMs up; each
    part keeps at least two of the plane's ``S_kv / 64`` K/V tiles, at most 16.
    (Measured on the H100: a split pays for its merge only there.)"""
    return max(1, min(sms // _flash_tiles(B, C, N, Nkv), -(-S_kv // FLASH_BK) // 2, FLASH_MAX_PARTS))


def flash_warpgroups(B: int, C: int, N: int, Nkv: int, parts: int, sms: int, D: int = 128) -> int:
    """Consumer warpgroups of a flash block: 2, splitting each block's walk
    between them, where the grid (tiles times parts) is at most one block an
    SM; else 1, and two blocks share an SM. At D = 256 always 1 (its O
    accumulator takes a warpgroup's registers at one block an SM)."""
    return 2 if D <= 128 and _flash_tiles(B, C, N, Nkv) * parts <= sms else 1


_SMS = {}


def _sms(dev: int) -> int:
    """SMs of CUDA device ``dev``, read once."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _flash_grid(q, Nkv: int, S_kv: int):
    """(parts, warpgroups, workspace) of a flash launch over ``q`` [B, C, N, D]:
    the workspace holds the fp32 partials (o [parts, B*C*N, D], m and l
    [parts, B*C*N]) when parts > 1."""
    B, C, N, D = q.shape
    sms = _sms(q.get_device())
    parts = flash_split_parts(B, C, N, Nkv, S_kv, sms)
    ws = torch.empty(parts * B * C * N * (D + 2), dtype=torch.float32, device=q.device) if parts > 1 else None
    return parts, flash_warpgroups(B, C, N, Nkv, parts, sms, D), ws


def paged_query_chunks(G: int, C: int) -> int:
    """Blocks that share one (kv head, row)'s G * C queries in the paged
    kernel: each of its four consumer warps holds one query where they are at
    most four, else four queries, so a block takes up to 16."""
    per_warp = 1 if G * C <= PAGED_WARPS else 4
    return -(-G * C // (PAGED_WARPS * per_warp))


def paged_split_parts(B: int, C: int, N: int, Nkv: int, P: int, sms: int) -> int:
    """Parts into which the paged kernel splits each row's pages: as many as
    keep its (kv head, row, query chunk) blocks times the parts within four
    an SM (the registers hold four), at most PAGED_MAX_PARTS and the table's
    P pages, and at least enough that a part stages at most PAGED_MAX_TABLE
    table entries."""
    blocks = Nkv * B * paged_query_chunks(N // Nkv, C)
    parts = max(1, min(4 * sms // blocks, PAGED_MAX_PARTS, P))
    return max(parts, -(-P // PAGED_MAX_TABLE))


def int8_beams_a_block(nb: int, G: int) -> int:
    """Beams of a group whose queries one int8 beam block holds: all nb where
    their nb * G queries fit INT8_QUERIES, else as many as fit (the group's
    prompt is then read once for each block of its beams); 1 where one beam's
    G queries do not fit, which then go to blocks in runs of INT8_QUERIES
    (:func:`query_runs`)."""
    return max(1, min(nb, INT8_QUERIES // G))


def query_runs(nb: int, G: int, bpc: int, nq: int) -> int:
    """Blocks that share a unit's nb * G flat queries (beam, head) in runs of
    min(bpc * G, nq): bpc whole beams a block where they fit the block's ``nq``
    queries, else runs of ``nq`` heads that may straddle two beams (the last
    run ragged: Falcon-7B's G = 71 is nine runs of at most 8 a plane row).
    The decode kernels take a unit's queries so (csrc/decode_int8_attn.cuh,
    csrc/beam_attn.cuh)."""
    return -(-nb * G // min(bpc * G, nq))


def int8_split_parts(blocks: int, keys: int, sms: int) -> int:
    """Parts into which the int8 decode kernels (B3, B10) split each unit's
    keys: as many as keep the ``blocks`` (one a kv head and plane row, or kv
    head, beam group and beam chunk) times the parts within four an SM (the
    registers hold four), at most INT8_MAX_PARTS, and with each part at least
    INT8_PART_KEYS of ``keys``, the longest walk the shapes allow (a plane's
    slots; a prompt's slots plus a tail's): a split pays for its merge
    launch and each part's fixed start only over long walks. The host never
    reads a length, so a wide slab of short rows splits too: the device then
    cuts each row's few keys into parts. chip_smoke.py times the host's
    choice beside the split forced the other way at 272 keys, over ~1000
    (B3 at G = 1 and 4, B10 over a 1024-slot prompt) and over ~2000 (B3 at
    G = 4)."""
    return max(1, min(4 * sms // blocks, INT8_MAX_PARTS, keys // INT8_PART_KEYS))


def int8_decode_parts(B: int, N: int, Nkv: int, S_max: int, sms: int) -> int:
    """B3's parts: its blocks are one a (kv head, row, run of at most
    INT8_QUERIES of the G heads), the walk at most the plane's S_max slots."""
    return int8_split_parts(Nkv * B * query_runs(1, N // Nkv, 1, INT8_QUERIES), S_max, sms)


def int8_beam_plan(B: int, nb: int, N: int, Nkv: int, S_p: int, T_max: int, sms: int) -> Tuple[int, int]:
    """B10's (beams a block, parts): its blocks are one a (kv head, group,
    run of queries: :func:`query_runs`), the walk at most the prompt's S_p
    slots and a tail's T_max."""
    G = N // Nkv
    bpc = int8_beams_a_block(nb, G)
    return bpc, int8_split_parts(Nkv * (B // nb) * query_runs(nb, G, bpc, INT8_QUERIES), S_p + T_max, sms)


@functools.lru_cache(maxsize=None)
def beam_plan(B: int, nb: int, N: int, Nkv: int, S_p: int, T_max: int, sms: int,
              D: int = 128) -> Tuple[int, int]:
    """B9's (beams a block, parts) for bf16 calls, cached by shape. A block
    holds the queries of all nb beams of a group where their nb * G fit
    :func:`beam_queries` (16, or 8 at D = 256), else as many whole beams as
    fit (the group's prompt is then read once for each block of its beams),
    and one (bpc = 1) where a beam's G queries do not fit, which go to blocks
    in runs of that many. Its
    blocks are one a (kv head, group, run of queries: :func:`query_runs`);
    where they leave SMs idle, each group's keys split
    into as many parts as keep the blocks within one an SM (a block's copies
    take about all of an SM's share of the memory's rate), at most
    BEAM_MAX_PARTS, each at least BEAM_PART_KEYS of the longest walk the
    shapes allow (the prompt's S_p slots and a tail's T_max): a split pays for
    its merge launch and each part's fixed start only over long walks.
    chip_smoke.py times the host's choice beside the split forced the other
    way."""
    G, nq = N // Nkv, beam_queries(D)
    bpc = max(1, min(nb, nq // G))
    blocks = Nkv * (B // nb) * query_runs(nb, G, bpc, nq)
    return bpc, max(1, min(sms // blocks, BEAM_MAX_PARTS, (S_p + T_max) // BEAM_PART_KEYS))


_split_workspaces = {}


def _split_workspace(dev: int, stream: int, floats: int) -> torch.Tensor:
    """The decode kernels' split partials, fp32 (B2, B3, B7/B8, B9 and B10;
    every one written before it is read: no zeroing). An eager call takes its (device,
    stream)'s workspace, grown when a call needs more: the launches of one
    stream run in turn and never hold it at once. A call captured into a CUDA graph takes one of its own, which
    the graph holds, so a replay shares nothing with eager calls or other
    graphs."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(floats, dtype=torch.float32, device=f"cuda:{dev}")
    ws = _split_workspaces.get((dev, stream))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=f"cuda:{dev}")
        _split_workspaces[dev, stream] = ws
    return ws


def flash_attention_prefill(q, k, v, input_mask, scale=None, window=None, slopes=None):
    """Causal GQA flash attention over a left-padded prompt → [B, S, N, D]
    (with ``slopes``, ALiBi)."""
    if q.device.type == "cpu":
        return flash_attention_prefill_plain(q, k, v, input_mask, scale, window, slopes)
    from lia_tpu_torch.ops import _build

    B, S, N, D = q.shape
    Nkv = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    stream = _stream(q, k, v, input_mask)
    if k.shape[2] != S:
        raise ValueError(f"k/v must hold the prompt's {S} positions, got {tuple(k.shape)}")
    _flash_checks(q, k, v, input_mask, None)
    out = torch.empty_like(q)
    parts, nw, ws = _flash_grid(q, Nkv, S)
    rc = _build.library("flash_prefill").lia_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), input_mask.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, parts, nw, B, S, N, Nkv, D, _sscale(scale, D),
        int(window or 0), _slopes_ptr(slopes, N, q), stream,
    )
    _raise_on(rc, "flash_attention_prefill")
    flash_attention_prefill.launches += 1
    flash_attention_prefill.split_launches += int(parts > 1)
    return out


def flash_attention_cached(q, k_cache, v_cache, base, slot_mask, scale=None, window=None, slopes=None):
    """Chunk-over-cache causal attention: the chunk's queries [B, C, N, D] over
    the cache plane [B, N_kv, S_max, D] that already holds the chunk at
    [base_b, base_b + C) → [B, C, N, D]. ``base`` (int, 0-dim or [B]) and the
    slot mask are read on the device; with ``slopes``, ALiBi."""
    if q.device.type == "cpu":
        return flash_attention_cached_plain(q, k_cache, v_cache, base, slot_mask, scale, window, slopes)
    from lia_tpu_torch.ops import _build

    B, C, N, D = q.shape
    Nkv, S_max = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    bases = _lengths(base, q.device)
    stream = _stream(q, k_cache, v_cache, slot_mask, bases)
    _flash_checks(q, k_cache, v_cache, slot_mask, bases)
    out = torch.empty_like(q)
    parts, nw, ws = _flash_grid(q, Nkv, S_max)
    rc = _build.library("flash_cached").lia_flash_cached(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), slot_mask.data_ptr(), bases.data_ptr(),
        1 if bases.ndim else 0, out.data_ptr(), ws.data_ptr() if ws is not None else None, parts, nw, B, C, S_max,
        N, Nkv, D, _sscale(scale, D), int(window or 0), _slopes_ptr(slopes, N, q), stream,
    )
    _raise_on(rc, "flash_attention_cached")
    flash_attention_cached.launches += 1
    flash_attention_cached.split_launches += int(parts > 1)
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
    _check_heads(N, Nkv, D)


def _decode_checks(q, k_fresh, v_fresh, cache, slot_mask, lengths):
    """q and the fresh k/v against a stacked cache [L, B, N_kv, S_max, D]."""
    if cache.dim() != 5:
        raise ValueError(f"the cache must be [L, B, N_kv, S_max, D], got {tuple(cache.shape)}")
    _plane_checks(q, cache.shape[1:], slot_mask, lengths)
    B, _, _, D = q.shape
    if k_fresh.shape != (B, cache.shape[2], 1, D) or v_fresh.shape != k_fresh.shape:
        raise ValueError("fresh k/v must be [B, N_kv, 1, D]")


def plane_lanes(D: int) -> int:
    """Lanes of a plane block's warp that read one key row at head dim D (16
    bytes each): 8 at D = 64, 16 at 80, 96 and 128 (those past D / 8 idle),
    32 at 256."""
    return 8 if D == 64 else 32 if D == 256 else 16


def plane_unit(D: int) -> int:
    """Keys of a plane ring stage: PLANE_STAGE_KEYS for each lane group (a key
    row's lanes) of the block's consumer warps (64 at D = 64, 32 at 80-128,
    16 at 256)."""
    return PLANE_STAGE_KEYS * PLANE_WARPS * (32 // plane_lanes(D))


def plane_stages(D: int, blocks: int, sms: int) -> int:
    """Stages of a plane block's ring for a launch of ``blocks`` blocks on
    ``sms`` SMs: as many as fit when the blocks an SM (at most
    PLANE_BLOCKS_AN_SM) share its shared memory, from 2 to
    PLANE_MAX_STAGES."""
    per_sm = min(PLANE_BLOCKS_AN_SM, max(1, -(-blocks // sms)))
    room = min(SM_SMEM // per_sm - 1024, BLOCK_SMEM) - 16 * PLANE_MAX_STAGES
    return max(2, min(PLANE_MAX_STAGES, room // (2 * plane_unit(D) * D * 2)))


def plane_split_parts(B: int, Nkv: int, S_max: int, sms: int) -> int:
    """Parts into which the plane body splits each row's keys: as many as keep
    its (kv head, row) blocks times the parts within one an SM (a block's
    ring takes about an SM's share of the memory's rate), at most
    PLANE_MAX_PARTS, each at least PLANE_PART_KEYS of the plane's S_max
    slots: a split pays for its merge launch and each part's fixed start only
    where the blocks leave SMs idle."""
    return max(1, min(sms // (B * Nkv), PLANE_MAX_PARTS, S_max // PLANE_PART_KEYS))


class PlanePlan(NamedTuple):
    """How a plane decode call (B2, B7/B8) runs: ``body`` "plane"
    (csrc/plane_attn.cuh: bf16 up to PLANE_MAX_GROUP), "beam" (the bf16 beam
    body past it) or "warp" (decode_attn.cuh: fp32); its keys in ``parts``
    parts (a merge launch when above 1); the plane body's ring ``stages``
    (0 elsewhere); the beam body's beams a block ``bpc`` (1 elsewhere)."""

    body: str
    parts: int
    stages: int
    bpc: int


@functools.lru_cache(maxsize=None)
def plane_plan(B: int, N: int, Nkv: int, S_max: int, bf16: bool, sms: int, D: int = 128,
               parts: Optional[int] = None) -> PlanePlan:
    """The :class:`PlanePlan` of a plane decode call, cached by shape: bf16
    up to G = PLANE_MAX_GROUP on the plane body split by
    :func:`plane_split_parts`, past it on the bf16 beam body as a group of
    one beam with :func:`beam_plan`'s beams a block and, where the blocks
    fill at most a quarter of the SMs, its split; fp32 on the warp body,
    which never splits. ``parts`` forces a bf16 call's split (tests and
    chip_smoke.py)."""
    G = N // Nkv
    if not bf16:
        return PlanePlan("warp", 1, 0, 1)
    if G > PLANE_MAX_GROUP:
        bpc, host = beam_plan(B, 1, N, Nkv, S_max, 0, sms, D)
        blocks = Nkv * B * query_runs(1, G, bpc, beam_queries(D))
        # beam_plan's split only where the blocks leave three quarters of the SMs
        # idle: at 64 blocks (D = 256, G = 4) over 272-key rows its 2 parts lost
        # to 1 on an H100 (chip_smoke.py's plane_checks rows), while B9's own 64
        # blocks (two beams a block, Llama-3-8B's heads at D = 256) won with them
        # (chip_ab.py's decode group); at 32 blocks its 4 parts won (B9's rows)
        return PlanePlan("beam", parts or (host if 4 * blocks <= sms else 1), 0, bpc)
    parts = parts or plane_split_parts(B, Nkv, S_max, sms)
    return PlanePlan("plane", parts, plane_stages(D, B * Nkv * parts, sms), 1)


def _plane_call(name, q, fresh, kc_ptr, vc_ptr, plane_shape, slot_mask, lengths, scale, stream, is_bf16, slopes):
    """Launch library ``name``'s plane decode entry (``decode``: no fresh token,
    ``decode_fresh``: ``fresh`` the fresh k/v) over one plane of
    ``plane_shape`` [B, N_kv, S_max, D] at kc_ptr/vc_ptr, by
    :func:`plane_plan`, after the caller's checks (``slopes``: ALiBi's, or
    None); returns (rc, out, parts)."""
    B, _, N, D = q.shape
    _, Nkv, S_max, _ = plane_shape
    dev = q.get_device()
    sms = _sms(dev)
    plan = plane_plan(B, N, Nkv, S_max, bool(is_bf16), sms, D)
    if is_bf16:
        _aligned16(q.data_ptr(), kc_ptr, vc_ptr, *(t.data_ptr() for t in fresh))
    ws = _split_workspace(dev, stream, plan.parts * B * N * (D + 2)) if plan.parts > 1 else None
    out = torch.empty_like(q)
    entry, groups = _PLANE_ENTRIES.get(name) or _plane_entries(name)
    head = (q.data_ptr(), *(t.data_ptr() for t in fresh), kc_ptr, vc_ptr, slot_mask.data_ptr(), lengths.data_ptr(),
            1 if lengths.ndim else 0, out.data_ptr(), ws.data_ptr() if ws is not None else None, plan.parts)
    sl = _slopes_ptr(slopes, N, q)
    if plan.body == "beam":
        rc = groups(*head, plan.bpc, B, N, Nkv, S_max, D, sms, _sscale(scale, D), sl, stream)
    else:
        rc = entry(*head, plan.stages, B, N, Nkv, S_max, D, _sscale(scale, D), is_bf16, sl, stream)
    return rc, out, plan.parts


_PLANE_ENTRIES = {}


def _plane_entries(name):
    """Library ``name``'s plane entry and its beam-body entry, looked up once
    (the decode wrappers' host time is the eager loop's)."""
    from lia_tpu_torch.ops import _build

    lib = _build.library(name)
    _PLANE_ENTRIES[name] = (getattr(lib, f"lia_{name}"), getattr(lib, f"lia_{name}_groups"))
    return _PLANE_ENTRIES[name]


def _decode(q, kc_ptr, vc_ptr, plane_shape, k_cache, v_cache, slot_mask, length, scale, slopes):
    """Launch B7/B8 (library ``decode``) over one plane of ``plane_shape``
    [B, N_kv, S_max, D] at kc_ptr/vc_ptr (inside k_cache/v_cache); returns
    (rc, out, parts)."""
    q = q.contiguous()
    lengths = _lengths(length, q.device)
    stream = _stream(q, k_cache, v_cache, slot_mask, lengths)
    is_bf16 = _float_kind(q, k_cache, v_cache)
    _plane_checks(q, plane_shape, slot_mask, lengths)
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v caches differ in shape")
    return _plane_call("decode", q, (), kc_ptr, vc_ptr, plane_shape, slot_mask, lengths, scale, stream, is_bf16,
                       slopes)


def decode_attention(q, k_cache, v_cache, slot_mask, length, scale=None, slopes=None):
    """Decode attention over one layer plane [B, N_kv, S_max, D] that already
    holds this step's token; ``length`` (0-dim or [B]) includes it. A bf16
    call runs the plane body up to G = PLANE_MAX_GROUP and the bf16 beam body
    past it (:func:`plane_plan`); either may split each row's keys and merge
    them in a second launch (``split_launches`` counts those calls)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, slot_mask, length, scale, slopes)
    rc, out, parts = _decode(q, k_cache.data_ptr(), v_cache.data_ptr(), k_cache.shape, k_cache, v_cache,
                             slot_mask, length, scale, slopes)
    _raise_on(rc, "decode_attention")
    decode_attention.launches += 1
    decode_attention.split_launches += int(parts > 1)
    return out


def decode_attention_stacked(q, k_cache, v_cache, layer_idx, slot_mask, length, scale=None, slopes=None):
    """:func:`decode_attention` over layer ``layer_idx`` of the stacked cache
    [L, B, N_kv, S_max, D], read in place (the kernel starts at the layer's
    offset). Backs both of the reference's stacked entry points
    (``decode_attention_stacked`` and ``decode_attention_stacked_dma``)."""
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, k_cache, v_cache, layer_idx, slot_mask, length, scale, slopes)
    if k_cache.dim() != 5:
        raise ValueError(f"the cache must be [L, B, N_kv, S_max, D], got {tuple(k_cache.shape)}")
    rc, out, parts = _decode(q, _layer_ptr(k_cache, layer_idx), _layer_ptr(v_cache, layer_idx), k_cache.shape[1:],
                             k_cache, v_cache, slot_mask, length, scale, slopes)
    _raise_on(rc, "decode_attention_stacked")
    decode_attention_stacked.launches += 1
    decode_attention_stacked.split_launches += int(parts > 1)
    return out


def decode_attention_fresh(
    q, k_fresh, v_fresh, k_cache, v_cache, layer_idx, slot_mask, length, scale=None, slopes=None
):
    """Decode attention over layer ``layer_idx``'s cache plane + the fresh
    token. A bf16 call runs the plane body up to G = PLANE_MAX_GROUP and the
    bf16 beam body past it (:func:`plane_plan`); either may split each row's
    keys and merge them with the fresh token in a second launch
    (``split_launches`` counts those calls)."""
    if q.device.type == "cpu":
        return decode_attention_fresh_plain(
            q, k_fresh, v_fresh, k_cache, v_cache, layer_idx, slot_mask, length, scale, slopes
        )
    q, k_fresh, v_fresh = q.contiguous(), k_fresh.contiguous(), v_fresh.contiguous()
    lengths = _lengths(length, q.device)
    stream = _stream(q, k_fresh, v_fresh, k_cache, v_cache, slot_mask, lengths)
    is_bf16 = _float_kind(q, k_fresh, v_fresh, k_cache, v_cache)
    _decode_checks(q, k_fresh, v_fresh, k_cache, slot_mask, lengths)
    if v_cache.shape != k_cache.shape:
        raise ValueError("k/v caches differ in shape")
    rc, out, parts = _plane_call("decode_fresh", q, (k_fresh, v_fresh), _layer_ptr(k_cache, layer_idx),
                                 _layer_ptr(v_cache, layer_idx), k_cache.shape[1:], slot_mask, lengths, scale,
                                 stream, is_bf16, slopes)
    _raise_on(rc, "decode_attention_fresh")
    decode_attention_fresh.launches += 1
    decode_attention_fresh.split_launches += int(parts > 1)
    return out


def decode_attention_fresh_int8(
    q, k_fresh, v_fresh, kq, ks, vq, vs, layer_idx, slot_mask, length, scale=None, slopes=None
):
    """Fresh-merge decode attention over an INT8 stacked cache (codes [L, B, N_kv,
    S_max, D] int8, scales [L, B, N_kv, S_max] f32). The fresh k/v come
    unquantized, in q's type; the kernel takes them through their int8 round
    trip itself. Where the (kv head, row) blocks fill the card poorly, each
    row's keys split into :func:`int8_split_parts` parts and a second launch
    merges them (``split_launches`` counts those calls)."""
    if q.device.type == "cpu":
        return decode_attention_fresh_int8_plain(
            q, k_fresh, v_fresh, kq, ks, vq, vs, layer_idx, slot_mask, length, scale, slopes
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
    vecs = q.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr()
    planes = [_layer_ptr(t, layer_idx) for t in (kq, ks, vq, vs)]
    _aligned16(*vecs, planes[0], planes[2])
    dev = q.get_device()
    sms = _sms(dev)
    parts = int8_decode_parts(B, N, Nkv, S_max, sms)
    ws = _split_workspace(dev, stream, parts * B * N * (D + 2)) if parts > 1 else None
    out = torch.empty_like(q)
    rc = _build.library("decode_fresh_int8").lia_decode_fresh_int8(
        *vecs, *planes, slot_mask.data_ptr(), lengths.data_ptr(), 1 if lengths.ndim else 0, out.data_ptr(),
        ws.data_ptr() if ws is not None else None, parts, B, N, Nkv, S_max, D, sms, _sscale(scale, D), is_bf16,
        _slopes_ptr(slopes, N, q), stream,
    )
    _raise_on(rc, "decode_attention_fresh_int8")
    decode_attention_fresh_int8.launches += 1
    decode_attention_fresh_int8.split_launches += int(parts > 1)
    return out


def _aligned16(*ptrs: int) -> None:
    """The int8 and bf16 beam decode kernels copy cache rows and load q and the
    fresh k/v in 16-byte words: ``ptrs`` are the addresses they get (a cache's
    at its layer)."""
    acc = 0
    for p in ptrs:
        acc |= p
    if acc % 16:
        raise ValueError("q, the fresh k/v and the caches (the int8 ones' codes) must be 16-byte aligned")


def _beam_checks(q, k_fresh, v_fresh, prompt_shape, tail_shape, prompt_mask, lens, nb):
    """q [B, 1, N, D] and the fresh k/v against a stacked prompt cache [L, B0,
    N_kv, S_p, D] and tail [L, B, N_kv, T_max, D]."""
    B, one, N, D = q.shape
    L, B0, Nkv, S_p, Dp = prompt_shape
    _check_beams(B, B0, nb)
    if one != 1 or Dp != D or len(tail_shape) != 5 or tuple(tail_shape) != (L, B, Nkv, tail_shape[3], D):
        raise ValueError(f"q {tuple(q.shape)}, prompt {tuple(prompt_shape)} and tail {tuple(tail_shape)} do not match")
    if prompt_mask.shape != (B0, S_p) or prompt_mask.dtype is not torch.bool:
        raise ValueError("prompt_mask must be [B0, S_p] bool")
    if k_fresh.shape != (B, Nkv, 1, D) or v_fresh.shape != k_fresh.shape:
        raise ValueError("fresh k/v must be [B, N_kv, 1, D]")
    if any(t.ndim for t in lens):
        raise ValueError("prompt_len and tail_len must be scalars")
    _check_heads(N, Nkv, D)


def decode_beam_attention(
    q, k_fresh, v_fresh, kp, vp, kt, vt, layer_idx, prompt_mask, prompt_len, tail_len, nb, scale=None, slopes=None
):
    """Grouped-beam decode attention (B = B0 * nb beams): beam b's query over
    layer ``layer_idx`` of its group's prompt plane, its own tail and the fresh
    token. The stacked caches are read in place at the layer's offset;
    ``prompt_len``, ``tail_len`` and the prompt mask are read on the device.
    A bf16 block holds the queries of :func:`beam_plan`'s beams of a group, so
    a group's prompt is read once for them; where those blocks fill the card
    poorly, each group's keys split into parts and a second launch merges
    them (``split_launches`` counts those calls). An fp32 call takes the warp
    body, one block a (beam, kv head)."""
    if q.device.type == "cpu":
        return decode_beam_attention_plain(
            q, k_fresh, v_fresh, kp, vp, kt, vt, layer_idx, prompt_mask, prompt_len, tail_len, nb, scale, slopes
        )
    from lia_tpu_torch.ops import _build

    B, _, N, D = q.shape
    q, k_fresh, v_fresh = q.contiguous(), k_fresh.contiguous(), v_fresh.contiguous()
    plen, tlen = _lengths(prompt_len, q.device), _lengths(tail_len, q.device)
    stream = _stream(q, k_fresh, v_fresh, kp, vp, kt, vt, prompt_mask, plen, tlen)
    is_bf16 = _float_kind(q, k_fresh, v_fresh, kp, vp, kt, vt)
    if kp.dim() != 5 or vp.shape != kp.shape or vt.shape != kt.shape:
        raise ValueError(f"prompt and tail caches must be [L, ·, N_kv, S, D] pairs, got {tuple(kp.shape)}, "
                         f"{tuple(vp.shape)}, {tuple(kt.shape)}, {tuple(vt.shape)}")
    _beam_checks(q, k_fresh, v_fresh, kp.shape, kt.shape, prompt_mask, (plen, tlen), nb)
    Nkv, S_p, T_max = kp.shape[2], kp.shape[3], kt.shape[3]
    ptrs = (q.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr(), _layer_ptr(kp, layer_idx),
            _layer_ptr(vp, layer_idx), _layer_ptr(kt, layer_idx), _layer_ptr(vt, layer_idx))
    dev = q.get_device()
    sms = _sms(dev)
    bpc, parts = 1, 1  # fp32: the warp body, which never splits
    if is_bf16:
        _aligned16(*ptrs)
        bpc, parts = beam_plan(B, nb, N, Nkv, S_p, T_max, sms, D)
    ws = _split_workspace(dev, stream, parts * B * N * (D + 2)) if parts > 1 else None
    out = torch.empty_like(q)
    rc = _build.library("beam_decode").lia_beam_decode(
        *ptrs, prompt_mask.data_ptr(), plen.data_ptr(), tlen.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, parts, bpc, B, nb, N, Nkv, S_p, T_max, D, sms,
        _sscale(scale, D), is_bf16, _slopes_ptr(slopes, N, q), stream,
    )
    _raise_on(rc, "decode_beam_attention")
    decode_beam_attention.launches += 1
    decode_beam_attention.split_launches += int(parts > 1)
    return out


def decode_beam_attention_int8(
    q, k_fresh, v_fresh, kpq, kps, vpq, vps, ktq, kts, vtq, vts, layer_idx, prompt_mask, prompt_len, tail_len,
    nb, scale=None, slopes=None,
):
    """Grouped-beam decode attention over INT8 prompt and tail caches (codes
    int8 [L, ·, N_kv, S, D], scales f32 [L, ·, N_kv, S]). The fresh k/v come
    already dequantized, in q's type. One block holds the queries of
    :func:`int8_beams_a_block` beams of a group, so a group's prompt is read
    once for them; where those blocks fill the card poorly, each group's keys
    split into :func:`int8_split_parts` parts and a second launch merges them
    (``split_launches`` counts those calls)."""
    if q.device.type == "cpu":
        return decode_beam_attention_int8_plain(
            q, k_fresh, v_fresh, kpq, kps, vpq, vps, ktq, kts, vtq, vts, layer_idx, prompt_mask, prompt_len,
            tail_len, nb, scale, slopes,
        )
    from lia_tpu_torch.ops import _build

    B, _, N, D = q.shape
    q, k_fresh, v_fresh = q.contiguous(), k_fresh.contiguous(), v_fresh.contiguous()
    plen, tlen = _lengths(prompt_len, q.device), _lengths(tail_len, q.device)
    stream = _stream(q, k_fresh, v_fresh, kpq, kps, vpq, vps, ktq, kts, vtq, vts, prompt_mask, plen, tlen)
    is_bf16 = _float_kind(q, k_fresh, v_fresh)
    for codes, sc in ((kpq, kps), (vpq, vps), (ktq, kts), (vtq, vts)):
        if codes.dtype is not torch.int8 or sc.dtype is not torch.float32 or sc.shape != codes.shape[:-1]:
            raise ValueError("codes must be int8 [L, ·, N_kv, S, D] and scales float32 [L, ·, N_kv, S]")
    if kpq.dim() != 5 or vpq.shape != kpq.shape or vtq.shape != ktq.shape:
        raise ValueError("prompt and tail caches must be [L, ·, N_kv, S, D] pairs")
    _beam_checks(q, k_fresh, v_fresh, kpq.shape, ktq.shape, prompt_mask, (plen, tlen), nb)
    vecs = q.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr()
    planes = [_layer_ptr(t, layer_idx) for t in (kpq, kps, vpq, vps, ktq, kts, vtq, vts)]
    _aligned16(*vecs, *planes[::2])
    Nkv, S_p, T_max = kpq.shape[2], kpq.shape[3], ktq.shape[3]
    dev = q.get_device()
    sms = _sms(dev)
    bpc, parts = int8_beam_plan(B, nb, N, Nkv, S_p, T_max, sms)
    ws = _split_workspace(dev, stream, parts * B * N * (D + 2)) if parts > 1 else None
    out = torch.empty_like(q)
    rc = _build.library("beam_decode_int8").lia_beam_decode_int8(
        *vecs, *planes, prompt_mask.data_ptr(), plen.data_ptr(), tlen.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, parts, bpc,
        B, nb, N, Nkv, S_p, T_max, D, sms, _sscale(scale, D), is_bf16, _slopes_ptr(slopes, N, q), stream,
    )
    _raise_on(rc, "decode_beam_attention_int8")
    decode_beam_attention_int8.launches += 1
    decode_beam_attention_int8.split_launches += int(parts > 1)
    return out


def paged_decode_attention(
    q, k_pool, v_pool, layer_idx, block_table, lengths, k_fresh=None, v_fresh=None, scale=None, slopes=None
):
    """C queries per sequence [B, C, N, D] over layer ``layer_idx`` of a paged
    pool [L, nb, N_kv, bs, D], read in place through the block table (int32
    [B, P]) with per-row ``lengths`` (int32 [B], or one for all); with the
    fresh chunk [B, N_kv, C, D], chunk row c merges fresh keys 0..c. The table
    and lengths are read on the device. Where the (kv head, row) blocks fill
    the card poorly the kernel splits each row's pages into
    :func:`paged_split_parts` parts and a second launch merges them
    (``split_launches`` counts those calls); scratch comes from the allocator,
    so the call can be captured in a CUDA graph."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, layer_idx, block_table, lengths, k_fresh, v_fresh, scale, slopes
        )
    from lia_tpu_torch.ops import _build

    B, C, N, D = q.shape
    if k_pool.dim() != 5:
        raise ValueError(f"the pool must be [L, nb, N_kv, bs, D], got {tuple(k_pool.shape)}")
    _, _, Nkv, bs, Dp = k_pool.shape
    P = block_table.shape[1] if block_table.dim() == 2 else 0
    q = q.contiguous()
    lengths = _lengths(lengths, q.device)
    fresh = () if k_fresh is None else (k_fresh.contiguous(), v_fresh.contiguous())
    stream = _stream(q, k_pool, v_pool, block_table, lengths, *fresh)
    is_bf16 = _float_kind(q, k_pool, v_pool, *fresh)
    if Dp != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match the pools {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if block_table.shape != (B, P) or block_table.dtype is not torch.int32:
        raise ValueError("block_table must be int32 [B, P]")
    if lengths.ndim and lengths.shape != (B,):
        raise ValueError("lengths must be a scalar or [B]")
    if fresh and (fresh[0].shape != (B, Nkv, C, D) or fresh[1].shape != fresh[0].shape):
        raise ValueError("fresh k/v must be [B, N_kv, C, D]")
    _check_heads(N, Nkv, D)
    kf_ptr, vf_ptr = (fresh[0].data_ptr(), fresh[1].data_ptr()) if fresh else (None, None)
    out = torch.empty_like(q)
    parts = paged_split_parts(B, C, N, Nkv, P, _sms(q.get_device()))
    ws = torch.empty(parts * B * C * N * (D + 2), dtype=torch.float32, device=q.device) if parts > 1 else None
    rc = _build.library("paged_decode").lia_paged_decode(
        q.data_ptr(), kf_ptr, vf_ptr, _layer_ptr(k_pool, layer_idx), _layer_ptr(v_pool, layer_idx), block_table.data_ptr(),
        lengths.data_ptr(), 1 if lengths.ndim else 0, out.data_ptr(), ws.data_ptr() if ws is not None else None, parts,
        B, C, N, Nkv, P, bs, D, _sscale(scale, D), is_bf16, int(bool(fresh)), _slopes_ptr(slopes, N, q), stream,
    )
    _raise_on(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    paged_decode_attention.split_launches += int(parts > 1)
    return out


KERNELS = (
    flash_attention_prefill, decode_attention_fresh, decode_attention_fresh_int8,
    decode_attention, decode_attention_stacked, flash_attention_cached, paged_decode_attention,
    decode_beam_attention, decode_beam_attention_int8,
)
SPLIT_KERNELS = (flash_attention_prefill, flash_attention_cached, paged_decode_attention,
                 decode_attention_fresh_int8, decode_beam_attention, decode_beam_attention_int8,
                 decode_attention_fresh, decode_attention, decode_attention_stacked)


def reset_launch_counts() -> None:
    """Zeroes every wrapper's ``launches`` and the splitting wrappers'
    ``split_launches`` (the calls that split their walks, parts > 1)."""
    for fn in KERNELS:
        fn.launches = 0
    for fn in SPLIT_KERNELS:
        fn.split_launches = 0


reset_launch_counts()


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def split_counts() -> dict:
    """The splitting wrappers' calls so far that split their walks (parts > 1)."""
    return {fn.__name__: fn.split_launches for fn in SPLIT_KERNELS}
