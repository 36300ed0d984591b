"""B9's bf16 body (``decode_beam_attention``, ``csrc/beam_attn.cuh``): its
decomposition and arithmetic, on the CPU.

One block takes each (kv head, beam group, chunk of beams) with up to
``BEAM_QUERIES`` queries (the chunk's beams x G heads); where those blocks fill
the card poorly, a group's keys split into ``parts``, cut on the device from
its own lengths (a prompt key counts 1 unit, a tail key one for each of the
block's beams), and a second launch merges the parts' fp32 (o, m, l) partials
with the fresh token. A block walks its keys as 16-key tiles (the prompt's
range, then each beam's tail range), four tiles a ring stage, one tile a
consumer warp; the producer copies each run of a stage's consecutive tiles of
one range in 16-byte chunks, chunk c of a row placed at c ^ (row & 7); the
consumers read K through ldmatrix and V through ldmatrix.trans.

Here the wrapper's plan (``beam_plan``) is checked at OPT-6.7B's and
Llama-3-8B's heads on 132 SMs and at 12, 16 and 32 queries a group; a plain
model of the tiles, copies and fragment reads is shown to put every valid
key in exactly one part, stage and tile slot, where the consumers' reads find
it, with no bank conflict (group pads 0/7/31/100, tlen = 0, pstart = plen,
the prompt/tail boundary inside a stage); and the kernel's arithmetic in
plain torch (the probabilities split into a bf16 hi and lo piece before P.V,
the parts merged with the fresh token last) is held against the plain version
and against lia_tpu's Pallas kernel in interpret mode: fp32 within 1e-5, bf16
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

from lia_tpu_torch.ops import cuda_attention as ca

SMS = 132  # an H100 SXM
TILE, SLOTS = 16, 4  # keys of a consumer warp's tile, tiles of a ring stage (csrc/beam_attn.cuh)


# ---------------------------------------------------------------------------
# the wrapper's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B0,nb,N,Nkv,S_p,T_max,plan", [
    (4, 4, 32, 32, 256, 32, (4, 1)),  # beam-nb4 at OPT-6.7B: 4 queries a block, 128 blocks, no split
    (4, 4, 32, 8, 256, 32, (4, 4)),  # Llama-3-8B's heads: a group's 16 queries in one block, 32 blocks, 4 parts
    (4, 4, 32, 32, 1024, 32, (4, 1)),  # a 1024-slot prompt: 128 blocks already hold an SM each
    (4, 4, 32, 8, 1024, 32, (4, 4)),  # ... at Llama's heads: 4 parts keep 128 blocks within one an SM
    (4, 12, 32, 32, 256, 32, (12, 1)),  # 12 queries a group (G = 1): one block
    (4, 3, 32, 8, 256, 32, (3, 4)),  # 12 queries a group (G = 4): one block, 32 blocks
    (4, 16, 32, 32, 256, 32, (16, 1)),  # 16 queries a group (G = 1): one block
    (4, 8, 32, 8, 256, 32, (4, 2)),  # 32 queries a group (G = 4): two blocks of 4 beams, 64 blocks
    (4, 4, 32, 4, 256, 32, (2, 4)),  # 32 queries a group (G = 8): two blocks of 2 beams, 32 blocks
    (4, 4, 32, 8, 32, 32, (4, 1)),  # a walk of one stage: no split
    (1, 2, 8, 1, 8192, 32, (2, 8)),  # one group of one kv head: capped at 8 parts
])
def test_beam_plan(B0, nb, N, Nkv, S_p, T_max, plan):
    assert ca.beam_plan(B0 * nb, nb, N, Nkv, S_p, T_max, SMS) == plan


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("B0,nb,N,Nkv,S_p", [(4, 4, 32, 32, 256), (1, 1, 8, 8, 64), (2, 8, 64, 8, 4096)])
def test_beam_plan_bounds(B0, nb, N, Nkv, S_p, sms):
    """At most BEAM_QUERIES queries a block, in whole beams; at least one
    part, at most BEAM_MAX_PARTS, each at least BEAM_PART_KEYS of the longest
    walk, and more than one only while the blocks stay within one an SM."""
    bpc, parts = ca.beam_plan(B0 * nb, nb, N, Nkv, S_p, 32, sms)
    G = N // Nkv
    assert 1 <= bpc <= nb and (bpc * G <= ca.BEAM_QUERIES or bpc == 1)
    assert 1 <= parts <= ca.BEAM_MAX_PARTS and parts <= max(1, (S_p + 32) // ca.BEAM_PART_KEYS)
    blocks = Nkv * B0 * -(-nb // bpc)
    assert parts == 1 or blocks * parts <= sms


# ---------------------------------------------------------------------------
# a plain model of the walk: ranges, stages, copies and fragment reads
# ---------------------------------------------------------------------------


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


def walk(ranges):
    """The block's tiles over ``ranges`` (the prompt's, then each beam's
    tail), each range cut from its lo: (range, first key, keys), grouped
    SLOTS tiles a stage."""
    tiles = [(g, k0, min(TILE, hi - k0)) for g, (lo, hi) in enumerate(ranges) for k0 in range(lo, hi, TILE)]
    return [tiles[s:s + SLOTS] for s in range(0, len(tiles), SLOTS)]


def stage_copies(stage, D: int):
    """The producer's copies of one stage: each run of consecutive slots of
    one range in 16-byte chunks, chunk i of the run (row i // (D / 8), chunk
    i % (D / 8)) landing at 16-byte slot row * D / 8 + (chunk ^ (row & 7)) of
    the stage's K (and V) half, the row counted from slot w's first. Returns
    {smem slot: (range, key, chunk)}."""
    ch = D // 8
    runs = []
    for w, (g, k0, n) in enumerate(stage):
        if runs and runs[-1][1] == g:
            runs[-1][3] += n
        else:
            runs.append([w, g, k0, n])
    placed = {}
    for w, g, k0, n in runs:
        for i in range(n * ch):
            row, c = w * TILE + i // ch, i % ch
            at = row * ch + (c ^ (row & 7))
            assert at not in placed  # no two copies on one slot
            placed[at] = (g, k0 + i // ch, c)
    return placed


def fragment_reads(w: int, D: int, trans: bool):
    """The 16-byte slots consumer warp w's ldmatrix.x4 calls read, by call
    (K: k16 chunk kk; V: 16-dim tile m) and matrix (lanes 8 mi .. 8 mi + 7):
    K's matrix mi holds keys 8 (mi & 1) + li at chunk 2 kk + mi // 2; V's
    (transposed on load) keys 8 (mi // 2) + li at chunk 2 m + (mi & 1).
    Returns [(call, mi, [(tile row, logical chunk, slot)] * 8)]."""
    ch = D // 8
    out = []
    for call in range(D // 16):
        for mi in range(4):
            reads = []
            for li in range(8):
                key = 8 * (mi >> 1) + li if trans else 8 * (mi & 1) + li
                c = 2 * call + (mi & 1 if trans else mi >> 1)
                row = w * TILE + key
                reads.append((key, c, row * ch + ((c ^ li))))
            out.append((call, mi, reads))
    return out


# (plen, group pads as prompt starts, tlen, beams a block): the check shapes'
# pads, no tail, a group with no prompt key (pstart = plen), a tail of 32
WALKS = [(256, (0, 7, 31, 100), 16, 4), (256, (0, 7, 31, 100), 0, 4), (40, (40, 3), 16, 4), (61, (13,), 32, 2),
         (1024, (100,), 16, 16)]


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("plen,pstarts,tlen,nbc", WALKS)
def test_walk_copies_each_key_once_where_the_fragments_read_it(plen, pstarts, tlen, nbc, parts):
    """At D 64 and 128: every valid prompt key of each group and tail key of
    each beam in exactly one part, stage and tile slot; each key's K and V
    chunks sit where the consumer warp of its slot reads them, each ldmatrix
    phase on 8 distinct bank groups (16-byte slot % 8), and no read of a
    valid row finds another key's chunk."""
    for D, pstart in ((D, p) for D in (64, 128) for p in pstarts):
        prompt, tail = [], []
        for (lo, hi), (t_lo, t_hi) in beam_ranges(plen, pstart, tlen, nbc, parts):
            ranges = [(lo, hi)] + [(t_lo, t_hi)] * nbc
            for stage in walk(ranges):
                placed = stage_copies(stage, D)
                assert len(placed) == sum(n for _, _, n in stage) * (D // 8)
                for w, (g, k0, n) in enumerate(stage):
                    (prompt if g == 0 else tail).extend((g, k) for k in range(k0, k0 + n))
                    for trans in (False, True):
                        for _, _, reads in fragment_reads(w, D, trans):
                            assert len({slot % 8 for _, _, slot in reads}) == 8  # no bank conflict
                            for key, c, slot in reads:
                                if key < n:  # a valid row: its own chunk
                                    assert placed[slot] == (g, k0 + key, c)
        assert [k for _, k in prompt] == list(range(pstart, plen))
        assert sorted(tail) == [(g, t) for g in range(1, nbc + 1) for t in range(tlen)]


def test_boundary_falls_inside_a_stage():
    """The prompt's last tile and each beam's one tail tile share a stage:
    four runs in one stage, each of one range."""
    (lo, hi), (t_lo, t_hi) = beam_ranges(12, 2, 3, 3, 1)[0]
    stages = walk([(lo, hi)] + [(t_lo, t_hi)] * 3)
    assert stages == [[(0, 2, 10), (1, 0, 3), (2, 0, 3), (3, 0, 3)]]
    assert len(stage_copies(stages[0], 64)) == (10 + 9) * 8


# ---------------------------------------------------------------------------
# the kernel's arithmetic in plain torch
# ---------------------------------------------------------------------------


def split_hi_lo(p: torch.Tensor):
    """fp32 probabilities as a bf16 hi and lo piece (as floats): hi = bf16(p),
    lo = bf16(p - hi)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def test_hi_lo_split_keeps_fp32_probabilities():
    """hi + lo meets p within 2^-17 relative; bf16(p) alone errs up to 2^-9."""
    p = (torch.rand(100000, generator=torch.Generator().manual_seed(0)) ** 4).clamp(min=1e-20)
    hi, lo = split_hi_lo(p)
    rel = ((hi + lo - p).abs() / p).max().item()
    assert rel <= 2.0**-17 and ((hi - p).abs() / p).max().item() > 2.0**-12


def beam_partials(q, kp, vp, kt, vt, layer, prompt_mask, plen, tlen, nb, bpc, parts, scale=None):
    """B9's bf16 walk in plain torch: the block of beam b (group b // nb,
    chunk (b % nb) // bpc) attends, in part p, its group's prompt keys and
    its own tail keys of :func:`beam_ranges`; scores are dots of q's and K's
    values in fp32 times scale * log2(e), probabilities fp32, and P.V takes
    them as hi + lo bf16 pieces. Returns (o [parts, B, N, D], m and l [parts,
    B, N]) as the parts write them; an empty part has m = -1e30, l = 0, o =
    0."""
    B, _, N, D = q.shape
    Nkv, S_p, T = kp.shape[2], kp.shape[3], kt.shape[3]
    G = N // Nkv
    plen, tlen = min(max(int(plen), 0), S_p), min(max(int(tlen), 0), T)
    pstarts = [max(plen - int(c), 0) for c in prompt_mask.to(torch.int32).sum(dim=1)]
    k = torch.cat([kp[layer].repeat_interleave(nb, dim=0), kt[layer]], dim=2).float()
    v = torch.cat([vp[layer].repeat_interleave(nb, dim=0), vt[layer]], dim=2).float()
    s = torch.einsum("bhgd,bhkd->bhgk", q.float().reshape(B, Nkv, G, D), k) * ca._sscale(scale, D)
    key = torch.arange(S_p + T)
    outs = []
    for p in range(parts):
        allow = torch.zeros(B, S_p + T, dtype=torch.bool)
        for b in range(B):
            chunk = (b % nb) // bpc
            nbc = min(bpc, nb - chunk * bpc)
            (lo, hi), (t_lo, t_hi) = beam_ranges(plen, pstarts[b // nb], tlen, nbc, parts)[p]
            allow[b] = ((key >= lo) & (key < hi)) | ((key >= S_p + t_lo) & (key < S_p + t_hi))
        allow = allow[:, None, None, :]
        sp = torch.where(allow, s, torch.full_like(s, ca.NEG_INF))
        m = sp.amax(dim=-1)
        e = torch.where(allow, torch.exp2(sp - m[..., None]), torch.zeros_like(sp))
        hi_p, lo_p = split_hi_lo(e)
        o = torch.einsum("bhgk,bhkd->bhgd", hi_p, v) + torch.einsum("bhgk,bhkd->bhgd", lo_p, v)
        outs.append((o.reshape(B, N, D), m.reshape(B, N), e.sum(dim=-1).reshape(B, N)))
    return tuple(torch.stack(x) for x in zip(*outs))


def merge_plain(o, m, l, q, kf, vf, scale=None):
    """The merge (the block itself with one part, merge_kernel past one): the
    fresh token's score (q * scale . k_fresh in fp32), every part rescaled to
    the common maximum, the fresh token last; out = o / max(l, 1e-30) in q's
    type."""
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


# (name, L, B0, nb, Nkv, G, D, S_p, T_max, plen, group starts, tlen): beams of
# one query, a group's 16 queries in one block, 32 queries in two blocks with
# a group of no prompt key (pstart = plen), and no tail
BEAM_CASES = [
    ("beams", 2, 3, 3, 2, 1, 16, 16, 8, 12, (2, 0, 11), 3),
    ("16 queries a block", 1, 2, 4, 2, 4, 16, 24, 8, 21, (5, 0), 8),
    ("32 queries, empty group", 1, 2, 4, 1, 8, 16, 24, 8, 20, (0, 20), 5),
    ("no tail", 1, 2, 3, 1, 2, 16, 16, 8, 16, (3, 16), 0),
]


def _inputs(case):
    name, L, B0, nb, Nkv, G, D, S_p, T, plen, pstarts, tlen = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B = B0 * nb
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pm = np.zeros((B0, S_p), bool)
    for g, p in enumerate(pstarts):
        pm[g, p:plen] = True
    return dict(q=f(B, 1, Nkv * G, D), kf=f(B, Nkv, 1, D), vf=f(B, Nkv, 1, D), kp=f(L, B0, Nkv, S_p, D),
                vp=f(L, B0, Nkv, S_p, D), kt=f(L, B, Nkv, T, D), vt=f(L, B, Nkv, T, D), pm=pm)


NAMES = ("q", "kf", "vf", "kp", "vp", "kt", "vt")


@pytest.fixture(scope="module")
def pallas_refs():
    """lia_tpu's B9 (interpret mode) of every case, in fp32 and on bf16 inputs, once."""
    refs = {}
    for jdt in (jnp.float32, jnp.bfloat16):
        for case in BEAM_CASES:
            name, L, B0, nb, Nkv, G, D, S_p, T, plen, pstarts, tlen = case
            x = _inputs(case)
            out = pa.decode_beam_attention(
                *(jnp.asarray(x[n], jdt) for n in NAMES), jnp.asarray(L - 1, jnp.int32),
                jnp.asarray([min(p, plen) for p in pstarts], jnp.int32), jnp.asarray(plen, jnp.int32),
                jnp.asarray(tlen, jnp.int32), nb, block_k=8, interpret=True)
            refs[name, jdt == jnp.bfloat16] = np.asarray(out.astype(jnp.float32))
    return refs


def _beam_split(case, parts, dtype=torch.float32):
    """The model's merged output and the plain version's, on ``dtype`` inputs."""
    name, L, B0, nb, Nkv, G, D, S_p, T, plen, pstarts, tlen = case
    x = _inputs(case)
    q, kf, vf, kp, vp, kt, vt = (torch.from_numpy(x[n]).to(dtype) for n in NAMES)
    pm = torch.from_numpy(x["pm"])
    bpc = ca.beam_plan(B0 * nb, nb, Nkv * G, Nkv, S_p, T, SMS)[0]
    o, m, l = beam_partials(q, kp, vp, kt, vt, L - 1, pm, plen, tlen, nb, bpc, parts)
    out = merge_plain(o, m, l, q, kf, vf)
    ref = ca.decode_beam_attention_plain(q, kf, vf, kp, vp, kt, vt, L - 1, pm, torch.tensor(plen, dtype=torch.int32),
                                         torch.tensor(tlen, dtype=torch.int32), nb)
    return out, ref, m


@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("case", BEAM_CASES, ids=[c[0] for c in BEAM_CASES])
def test_split_merge_matches_plain(case, parts):
    """fp32: the merged split with P in hi + lo pieces equals the plain
    version; where a block has fewer units than parts, some parts are empty
    and merge as nothing."""
    out, ref, m = _beam_split(case, parts)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    if parts == 8 and case[0] == "no tail":
        assert bool((m == ca.NEG_INF).any())


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("case", BEAM_CASES, ids=[c[0] for c in BEAM_CASES])
def test_split_merge_matches_pallas(pallas_refs, case, parts):
    out, _, _ = _beam_split(case, parts)
    np.testing.assert_allclose(out.numpy(), pallas_refs[case[0], False], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("case", BEAM_CASES, ids=[c[0] for c in BEAM_CASES])
def test_split_merge_matches_pallas_bf16(pallas_refs, case, parts):
    """bf16 inputs: both sides take q, K and V as bf16 values and sum in
    fp32, the output rounds once to bf16; 2e-2 on outputs of O(1)."""
    out, _, _ = _beam_split(case, parts, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas_refs[case[0], True], rtol=2e-2, atol=2e-2)
