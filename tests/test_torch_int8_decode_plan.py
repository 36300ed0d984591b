"""The int8 decode kernels' decomposition (B3 ``decode_attention_fresh_int8``
and B10 ``decode_beam_attention_int8``, ``csrc/decode_int8_attn.cuh``), on the
CPU.

One block takes each (kv head, plane row) of B3, or each (kv head, beam
group) of B10 with the queries of all of the group's beams (up to
``INT8_QUERIES``; more go to further blocks); where those blocks fill the card
poorly, the unit's keys split into ``parts``, cut on the device from its own
lengths, and a second launch merges the parts' fp32 (o, m, l) partials with
the fresh token. A block walks its keys as 16-key tiles (the plane's or
prompt's range, then each beam's tail range), four tiles a ring stage, one
tile a consumer warp; the producer copies each run of a stage's consecutive
tiles of one range with 16-byte copies of the codes and 4-byte copies of the
scales.

Here the wrappers' choice of beams a block and parts is checked at OPT-6.7B's
and Llama-3-8B's heads on 132 SMs; a plain model of the parts' key ranges
(``plane_ranges``, ``beam_ranges``) and of the stages' tiles and copies
(``stage_runs``) is shown to put every valid key in exactly one part, tile
slot and copy (lengths 0, start = length, starts off a multiple of 4, a
window, the prompt/tail boundary inside a part and inside a stage); and the
split in plain torch (``plane_partials``, ``beam_partials``) merged as the
kernel merges (``merge_plain``) is held against the plain versions and
against lia_tpu's Pallas kernels in interpret mode: fp32 within 1e-5; bf16
inputs within 2e-2 (outputs of O(1) round once to bf16, 2^-8 relative, and
the sums run in another order). The Pallas side is computed once per module.
"""

import zlib

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.ops import pallas_attention as pa
from lia_tpu.ops.quant import dequantize_kv as j_dequantize_kv
from lia_tpu.ops.quant import quantize_kv as j_quantize_kv

from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.quant import dequantize_kv, quantize_kv

SMS = 132  # an H100 SXM
TILE, SLOTS = 16, 4  # keys of a consumer warp's tile, tiles of a ring stage (csrc/decode_int8_attn.cuh)


# ---------------------------------------------------------------------------
# the wrappers' plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,Nkv,S_max,parts", [
    (16, 32, 32, 384, 1),  # the kernels line's case: OPT-6.7B b16, 512 blocks
    (16, 32, 32, 1024, 1),  # serve-slab-int8kv's step: 16 slots of 1024
    (16, 32, 8, 384, 1),  # Llama-3-8B's G = 4: 128 blocks, walks too short to split
    (16, 32, 8, 1152, 1),  # the same over ~1000-token rows (a split lost there on the card)
    (1, 32, 32, 2048, 2),  # one sequence: 32 blocks, 2 parts of 1024 of the 2048 slots
    (1, 32, 8, 8192, 8),  # ... capped at 8 parts
    (2, 8, 8, 64, 1),  # a plane of one stage: no split
])
def test_plane_parts(B, N, Nkv, S_max, parts):
    assert ca.int8_decode_parts(B, N, Nkv, S_max, SMS) == parts


@pytest.mark.parametrize("B0,nb,N,Nkv,S_p,T_max,bpc,parts", [
    (4, 4, 32, 32, 256, 128, 4, 1),  # beam-nb4-int8kv at OPT-6.7B: 128 (kv head, group) blocks, no split
    (4, 4, 32, 32, 1024, 128, 4, 1),  # ... over a 1024-slot prompt (a split tied there on the card)
    (4, 4, 32, 8, 256, 128, 2, 1),  # Llama-3-8B: 16 queries a group, in two blocks of 2 beams
    (4, 4, 32, 8, 2048, 128, 2, 2),  # ... over a 2048-slot prompt
    (16, 4, 32, 32, 1024, 128, 4, 1),  # 16 groups: 512 blocks
    (2, 8, 8, 1, 2048, 128, 1, 2),  # G = 8: one beam a block
    (3, 3, 4, 2, 16, 8, 3, 1),  # a prompt and tail of one stage
])
def test_beam_plan(B0, nb, N, Nkv, S_p, T_max, bpc, parts):
    assert ca.int8_beam_plan(B0 * nb, nb, N, Nkv, S_p, T_max, SMS) == (bpc, parts)


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("blocks,keys", [(1, 1), (7, 64), (32, 384), (128, 1152), (128, 4096), (512, 384), (4096, 2048)])
def test_split_parts_bounds(blocks, keys, sms):
    """At least one part, at most INT8_MAX_PARTS, each at least
    INT8_PART_KEYS of the longest walk, and more than one only while the
    blocks stay within four an SM."""
    parts = ca.int8_split_parts(blocks, keys, sms)
    assert 1 <= parts <= ca.INT8_MAX_PARTS and parts <= max(1, keys // ca.INT8_PART_KEYS)
    assert parts == 1 or blocks * parts <= 4 * sms


@pytest.mark.parametrize("nb,G,bpc", [(1, 1, 1), (4, 1, 4), (8, 1, 8), (16, 1, 8), (4, 2, 4), (4, 4, 2),
                                      (3, 8, 1), (5, 2, 4)])
def test_beams_a_block(nb, G, bpc):
    """A block holds at most INT8_QUERIES queries, in whole beams."""
    assert ca.int8_beams_a_block(nb, G) == bpc


# ---------------------------------------------------------------------------
# a plain model of the parts' key ranges and the stages' scale runs
# ---------------------------------------------------------------------------


def plane_ranges(lengths, starts, parts: int) -> torch.Tensor:
    """Keys [lo, hi) of part p of each plane row, as the kernel cuts them from
    the row's [start, length): the range's n keys in even pieces, lo = start
    + n * p // parts. lengths, starts int [B] → int64 [B, parts, 2]."""
    lengths, starts = torch.as_tensor(lengths).long(), torch.as_tensor(starts).long()
    n = lengths - starts
    edges = starts[:, None] + n[:, None] * torch.arange(parts + 1)[None, :] // parts
    return torch.stack([edges[:, :-1], edges[:, 1:]], dim=-1)


def beam_ranges(plen: int, pstart: int, tlen: int, nbc: int, parts: int):
    """Part p's prompt keys [lo, hi) and tail keys [t_lo, t_hi) (the same for
    each of the block's nbc beams), as the kernel cuts a group's walk: units
    where a prompt key counts 1 and a tail key nbc, in even pieces; tail key t
    (unit pn + t * nbc) belongs to the part whose units hold its first."""
    pn = plen - pstart
    units = pn + nbc * tlen
    out = []
    for p in range(parts):
        u0, u1 = units * p // parts, units * (p + 1) // parts
        t_lo = 0 if u0 <= pn else min(-(-(u0 - pn) // nbc), tlen)
        t_hi = 0 if u1 <= pn else min(-(-(u1 - pn) // nbc), tlen)
        out.append(((pstart + min(u0, pn), pstart + min(u1, pn)), (t_lo, t_hi)))
    return out


def stage_runs(ranges):
    """The kernel's walk over ``ranges`` ([lo, hi) each: the plane's or
    prompt's range, then each beam's tail range) as stages of SLOTS tiles of
    TILE keys, and each stage's copies: a run of consecutive slots of one
    range, (first slot, range, first key, keys). Tiles follow the ranges in
    order, each range cut from its lo."""
    tiles = [(g, k0, min(TILE, hi - k0)) for g, (lo, hi) in enumerate(ranges) for k0 in range(lo, hi, TILE)]
    out = []
    for s0 in range(0, len(tiles), SLOTS):
        runs = []
        for w, (g, k0, n) in enumerate(tiles[s0:s0 + SLOTS]):
            if runs and runs[-1][1] == g:
                runs[-1][3] += n
            else:
                runs.append([w, g, k0, n])
        out.append([tuple(r) for r in runs])
    return out


def _copied_keys(ranges):
    """Each copied key, by range, with the slot position its codes and scale
    land at: (range, key) -> (stage, slot * TILE + row)."""
    seen = {}
    for st, runs in enumerate(stage_runs(ranges)):
        for w, g, k0, n in runs:
            for k in range(k0, k0 + n):
                assert (g, k) not in seen  # no key copied twice
                seen[g, k] = (st, w * TILE + k - k0)
    return seen


# (length, start) of plane rows: empty, start = length, a start off a multiple
# of 4, a window of 8, rows over several stages, a full row
PLANE_ROWS = [(0, 0), (19, 19), (37, 3), (45, 37), (200, 5), (333, 0), (387, 2)]


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7, 8])
def test_plane_ranges_cover_each_key_once(parts):
    """Every valid key [start, length) of every row in exactly one part, and
    copied exactly once, in order, each stage's runs filling its slots from 0
    and a tile's keys at its slot's rows (a consumer warp reads slot w's rows
    0 .. 15); the parts' sizes within one of each other."""
    lengths, starts = [n for n, _ in PLANE_ROWS], [s0 for _, s0 in PLANE_ROWS]
    ranges = plane_ranges(lengths, starts, parts)
    for b, (n, s0) in enumerate(zip(lengths, starts)):
        keys = []
        for lo, hi in ranges[b].tolist():
            copied = _copied_keys([(lo, hi)])
            assert sorted(k for _, k in copied) == list(range(lo, hi))
            for runs in stage_runs([(lo, hi)]):
                slots = [x for w, _, _, n_ in runs for x in range(w, w + -(-n_ // TILE))]
                assert slots == list(range(len(slots))) and len(slots) <= SLOTS
            for k in range(lo, hi):  # key k: tile (k - lo) // 16, row (k - lo) % 16
                t = (k - lo) // TILE
                assert copied[0, k] == (t // SLOTS, (t % SLOTS) * TILE + (k - lo) % TILE)
            keys.extend(range(lo, hi))
        assert keys == list(range(s0, n))
        sizes = (ranges[b, :, 1] - ranges[b, :, 0]).tolist()
        assert max(sizes) - min(sizes) <= 1


# (plen, pstart, tlen, beams a block): the boundary inside a part, a group with
# no prompt key, no tail, long prompts over several stages, 8 beams
BEAM_GROUPS = [(12, 2, 3, 3), (16, 16, 0, 3), (16, 16, 5, 2), (21, 5, 8, 2), (256, 100, 16, 4), (1024, 0, 128, 4),
               (64, 3, 100, 8)]


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("plen,pstart,tlen,nbc", BEAM_GROUPS)
def test_beam_ranges_cover_each_key_once(plen, pstart, tlen, nbc, parts):
    """Every prompt key [pstart, plen) in exactly one part, every tail key
    [0, tlen) in exactly one part (read there for each beam), and each part's
    units (prompt keys + nbc x tail keys) within nbc of an even share."""
    rs = beam_ranges(plen, pstart, tlen, nbc, parts)
    prompt, tail = [], []
    for (lo, hi), (t_lo, t_hi) in rs:
        walk = [(lo, hi)] + [(t_lo, t_hi)] * nbc  # the prompt's range, then each beam's tail
        copied = _copied_keys(walk)
        assert len(copied) == (hi - lo) + nbc * (t_hi - t_lo)
        prompt.extend(k for g, k in sorted(copied) if g == 0)
        tail.extend(k for g, k in sorted(copied) if g == 1)
    assert prompt == list(range(pstart, plen)) and tail == list(range(tlen))
    share = (plen - pstart + nbc * tlen) / parts
    for (lo, hi), (t_lo, t_hi) in rs:
        assert abs((hi - lo) + nbc * (t_hi - t_lo) - share) < nbc + 1


def test_beam_boundary_falls_inside_a_part_and_a_stage():
    """The cases the kernel must walk across ranges: one part holds the last
    prompt keys and the first tail keys, and one stage holds the prompt's
    last tile and each beam's tail tile (four runs in one stage)."""
    rs = beam_ranges(12, 2, 3, 3, 2)
    assert any(hi > lo and t_hi > t_lo for (lo, hi), (t_lo, t_hi) in rs)
    (lo, hi), (t_lo, t_hi) = beam_ranges(12, 2, 3, 3, 1)[0]
    assert stage_runs([(lo, hi)] + [(t_lo, t_hi)] * 3) == [[(0, 0, 2, 10), (1, 1, 0, 3), (2, 2, 0, 3), (3, 3, 0, 3)]]


# ---------------------------------------------------------------------------
# the split in plain torch, merged as the kernel merges
# ---------------------------------------------------------------------------


def _part_softmax(s, allow, vs, vq, dtype):
    """One part's unnormalised (o, m, l) over the keys ``allow`` marks: scores
    s [..., K] already scaled; an empty part has m = -1e30, l = 0, o = 0."""
    sp = torch.where(allow, s, torch.full_like(s, ca.NEG_INF))
    m = sp.amax(dim=-1)
    e = torch.where(allow, torch.exp2(sp - m[..., None]), torch.zeros_like(sp))
    pw = (e * vs).to(dtype).float()
    return torch.einsum("bhgk,bhkd->bhgd", pw, vq.float()), m, e.sum(dim=-1)


def plane_partials(q, kq, ks, vq, vs, layer, slot_mask, length, parts, scale=None):
    """B3's split walk in plain torch: part p of each row attends its keys
    (:func:`plane_ranges`) with the int8 arithmetic of
    ``_int8_merge_plain`` and returns (o [parts, B, N, D], m and l [parts, B,
    N]) as the kernel writes them to its workspace."""
    B, _, N, D = q.shape
    Nkv, S = kq.shape[2], kq.shape[3]
    G = N // Nkv
    lengths = ca._lengths(length, q.device).expand(B).clamp(0, S)
    starts = (lengths - slot_mask.to(torch.int32).sum(dim=1)).clamp(min=0)
    ranges = plane_ranges(lengths, starts, parts)
    qt = q.float().reshape(B, Nkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qt, kq[layer].float()) * (ks[layer] * ca._sscale(scale, D))[:, :, None, :]
    key = torch.arange(S)
    outs = []
    for p in range(parts):
        allow = ((key[None, :] >= ranges[:, p, :1]) & (key[None, :] < ranges[:, p, 1:]))[:, None, None, :]
        o, m, l = _part_softmax(s, allow, vs[layer][:, :, None, :], vq[layer], q.dtype)
        outs.append((o.reshape(B, N, D), m.reshape(B, N), l.reshape(B, N)))
    return tuple(torch.stack(x) for x in zip(*outs))


def beam_partials(q, kpq, kps, vpq, vps, ktq, kts, vtq, vts, layer, prompt_mask, plen, tlen, nb, parts, scale=None):
    """B10's split walk in plain torch: each beam's view [group prompt | own
    tail]; part p attends its group's prompt keys and its own tail keys of
    :func:`beam_ranges` (all nb beams in one block)."""
    B, _, N, D = q.shape
    Nkv, S_p, T = kpq.shape[2], kpq.shape[3], ktq.shape[3]
    G = N // Nkv
    plen, tlen = min(max(int(plen), 0), S_p), min(max(int(tlen), 0), T)
    pstarts = [max(plen - int(c), 0) for c in prompt_mask.to(torch.int32).sum(dim=1)]

    def keys(prompt, tail):
        return torch.cat([prompt[layer].repeat_interleave(nb, dim=0), tail[layer]], dim=2)

    kc, ksc, vc, vsc = keys(kpq, ktq), keys(kps, kts), keys(vpq, vtq), keys(vps, vts)
    qt = q.float().reshape(B, Nkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qt, kc.float()) * (ksc * ca._sscale(scale, D))[:, :, None, :]
    key = torch.arange(S_p + T)
    outs = []
    for p in range(parts):
        allow = torch.zeros(B, S_p + T, dtype=torch.bool)
        for b in range(B):
            (lo, hi), (t_lo, t_hi) = beam_ranges(plen, pstarts[b // nb], tlen, nb, parts)[p]
            allow[b] = ((key >= lo) & (key < hi)) | ((key >= S_p + t_lo) & (key < S_p + t_hi))
        o, m, l = _part_softmax(s, allow[:, None, None, :], vsc[:, :, None, :], vc, q.dtype)
        outs.append((o.reshape(B, N, D), m.reshape(B, N), l.reshape(B, N)))
    return tuple(torch.stack(x) for x in zip(*outs))


def merge_plain(o, m, l, q, kf, vf, scale=None):
    """The merge (merge_kernel, or the block itself with one part): the fresh
    token's score (q * scale . k_fresh in fp32), every part rescaled to the
    common maximum, the fresh token last; out = o / max(l, 1e-30) in q's type.
    kf/vf [B, N_kv, 1, D] as attention sees them (dequantized)."""
    B, _, N, D = q.shape
    G = N // kf.shape[1]
    kfx, vfx = (x.float()[:, :, 0].repeat_interleave(G, dim=1) for x in (kf, vf))  # [B, N, D]
    sf = ((q.float()[:, 0] * ca._sscale(scale, D)) * kfx).sum(dim=-1)
    M = torch.maximum(sf, m.amax(dim=0))
    a = torch.exp2(m - M[None])
    pf = torch.exp2(sf - M)
    L = (l * a).sum(dim=0) + pf
    O = (o * a[..., None]).sum(dim=0) + pf[..., None] * vfx
    return (O / L.clamp(min=1e-30)[..., None]).reshape(B, 1, N, D).to(q.dtype)


# (name, L, B, Nkv, G, D, S_max, rows (length, start)): empty rows, start =
# length, starts off 4, a window, GQA and G = 8
PLANE_CASES = [
    ("mha", 2, 4, 2, 1, 16, 40, ((0, 0), (19, 19), (37, 3), (40, 0))),
    ("gqa window", 1, 3, 2, 4, 16, 48, ((45, 37), (30, 5), (1, 0))),
    ("G=8", 2, 2, 1, 8, 32, 32, ((25, 2), (32, 0))),
]
# (name, L, B0, nb, Nkv, G, D, S_p, T_max, plen, group starts, tlen)
BEAM_CASES = [
    ("beams", 2, 3, 3, 2, 1, 16, 16, 8, 12, (2, 0, 11), 3),
    ("gqa", 1, 2, 2, 2, 2, 16, 24, 8, 21, (5, 0), 8),
    ("empty group, no tail", 1, 2, 3, 1, 2, 16, 16, 8, 16, (3, 16), 0),
]


SHORT_ROWS = ("mha", "beams", "empty group, no tail")  # a row with fewer keys (units) than 8


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _plane_inputs(case):
    name, L, B, Nkv, G, D, S, rows = case
    rng = _rng(name)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = np.zeros((B, S), bool)
    for b, (n, s0) in enumerate(rows):
        mask[b, s0:n] = True
    return dict(q=f(B, 1, Nkv * G, D), kf=f(B, Nkv, 1, D), vf=f(B, Nkv, 1, D), k=f(L, B, Nkv, S, D),
                v=f(L, B, Nkv, S, D), mask=mask, lengths=np.asarray([n for n, _ in rows], np.int32))


def _beam_inputs(case):
    name, L, B0, nb, Nkv, G, D, S_p, T, plen, pstarts, tlen = case
    rng = _rng(name)
    B = B0 * nb
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pm = np.zeros((B0, S_p), bool)
    for g, p in enumerate(pstarts):
        pm[g, p:plen] = True
    return dict(q=f(B, 1, Nkv * G, D), kf=f(B, Nkv, 1, D), vf=f(B, Nkv, 1, D), kp=f(L, B0, Nkv, S_p, D),
                vp=f(L, B0, Nkv, S_p, D), kt=f(L, B, Nkv, T, D), vt=f(L, B, Nkv, T, D), pm=pm)


def _q(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.fixture(scope="module")
def pallas_refs():
    """lia_tpu's B3 and B10 (interpret mode) of every case, in fp32 and on bf16
    inputs, once. B3's Pallas kernel takes the fresh token after its int8
    round trip; the port's makes it itself."""
    refs = {}
    for jdt in (jnp.float32, jnp.bfloat16):
        for case in PLANE_CASES:
            x = _plane_inputs(case)
            jk, jv = j_quantize_kv(jnp.asarray(x["k"])), j_quantize_kv(jnp.asarray(x["v"]))
            q = jnp.asarray(x["q"], jdt)
            kf, vf = (j_dequantize_kv(j_quantize_kv(jnp.asarray(x[n], jdt)), jdt) for n in ("kf", "vf"))
            out = pa.decode_attention_fresh_int8(q, kf, vf, jk.q, jk.s, jv.q, jv.s, jnp.asarray(case[1] - 1, jnp.int32),
                                                 jnp.asarray(x["mask"]), jnp.asarray(x["lengths"]), block_k=8,
                                                 interpret=True)
            refs[case[0], jdt == jnp.bfloat16] = np.asarray(out.astype(jnp.float32))
        for case in BEAM_CASES:
            name, L, B0, nb, Nkv, G, D, S_p, T, plen, pstarts, tlen = case
            x = _beam_inputs(case)
            planes = [quantize_kv(torch.from_numpy(x[n])) for n in ("kp", "vp", "kt", "vt")]
            jplanes = [jnp.asarray(a.numpy()) for p in planes for a in p]
            # the beam kernels take the fresh k/v already dequantized to q's type
            kf, vf = (jnp.asarray(x[n], jdt) for n in ("kf", "vf"))
            out = pa.decode_beam_attention_int8(
                jnp.asarray(x["q"], jdt), kf, vf, *jplanes, jnp.asarray(L - 1, jnp.int32),
                jnp.asarray([min(p, plen) for p in pstarts], jnp.int32), jnp.asarray(plen, jnp.int32),
                jnp.asarray(tlen, jnp.int32), nb, block_k=8, interpret=True)
            refs[name, jdt == jnp.bfloat16] = np.asarray(out.astype(jnp.float32))
    return refs


def _plane_split(case, parts, dtype=torch.float32):
    x = _plane_inputs(case)
    q, kf, vf = (_q(x[n], dtype) for n in ("q", "kf", "vf"))
    kc, vc = quantize_kv(torch.from_numpy(x["k"])), quantize_kv(torch.from_numpy(x["v"]))
    mask, lengths = torch.from_numpy(x["mask"]), torch.from_numpy(x["lengths"])
    layer = case[1] - 1
    o, m, l = plane_partials(q, kc.q, kc.s, vc.q, vc.s, layer, mask, lengths, parts)
    kfd, vfd = (dequantize_kv(quantize_kv(t), dtype) for t in (kf, vf))
    out = merge_plain(o, m, l, q, kfd, vfd)
    ref = ca.decode_attention_fresh_int8_plain(q, kf, vf, kc.q, kc.s, vc.q, vc.s, layer, mask, lengths)
    return out, ref, m


def _beam_split(case, parts, dtype=torch.float32):
    name, L, B0, nb, Nkv, G, D, S_p, T, plen, pstarts, tlen = case
    x = _beam_inputs(case)
    q, kf, vf = (_q(x[n], dtype) for n in ("q", "kf", "vf"))
    planes = [a for n in ("kp", "vp", "kt", "vt") for a in quantize_kv(torch.from_numpy(x[n]))]
    pm = torch.from_numpy(x["pm"])
    o, m, l = beam_partials(q, *planes, L - 1, pm, plen, tlen, nb, parts)
    out = merge_plain(o, m, l, q, kf, vf)
    ref = ca.decode_beam_attention_int8_plain(q, kf, vf, *planes, L - 1, pm, torch.tensor(plen, dtype=torch.int32),
                                              torch.tensor(tlen, dtype=torch.int32), nb)
    return out, ref, m


@pytest.mark.parametrize("parts", [1, 2, 3, 8])
@pytest.mark.parametrize("case", PLANE_CASES + BEAM_CASES, ids=[c[0] for c in PLANE_CASES + BEAM_CASES])
def test_split_merge_matches_plain(case, parts):
    """fp32: the merged split equals the plain version; where a row has fewer
    keys (units) than parts, some parts are empty and merge as nothing."""
    out, ref, m = (_plane_split if case in PLANE_CASES else _beam_split)(case, parts)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    if parts == 8 and case[0] in SHORT_ROWS:
        assert bool((m == ca.NEG_INF).any())


def test_empty_row_gives_the_fresh_value():
    """Rows 0 (length 0) and 1 (start = length) of the first case attend to
    the fresh token alone: its value after the round trip, in every part
    count."""
    case = PLANE_CASES[0]
    x = _plane_inputs(case)
    vf = dequantize_kv(quantize_kv(torch.from_numpy(x["vf"])), torch.float32)
    for parts in (1, 3):
        out, _, _ = _plane_split(case, parts)
        for b in (0, 1):
            np.testing.assert_allclose(out[b, 0].numpy(), vf[b, :, 0].repeat_interleave(1, dim=0).numpy(),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("case", PLANE_CASES + BEAM_CASES, ids=[c[0] for c in PLANE_CASES + BEAM_CASES])
def test_split_merge_matches_pallas(pallas_refs, case, parts):
    out, _, _ = (_plane_split if case in PLANE_CASES else _beam_split)(case, parts)
    np.testing.assert_allclose(out.numpy(), pallas_refs[case[0], False], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("case", PLANE_CASES + BEAM_CASES, ids=[c[0] for c in PLANE_CASES + BEAM_CASES])
def test_split_merge_matches_pallas_bf16(pallas_refs, case, parts):
    """bf16 inputs: p * vs rounds to bf16 before P.V on both sides, the output
    once at the end; the sums run in another order. 2e-2 on outputs of O(1)."""
    out, _, _ = (_plane_split if case in PLANE_CASES else _beam_split)(case, parts, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas_refs[case[0], True], rtol=2e-2, atol=2e-2)
