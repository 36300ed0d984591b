"""The bf16 plane decode body (B2 ``decode_attention_fresh``, B7/B8
``decode_attention`` and its stacked entry, ``csrc/plane_attn.cuh``): its plan
and decomposition, on the CPU.

One block takes each (kv head, plane row, part) with the row's one query head
(``PLANE_MAX_GROUP``: from two heads a kv head the bf16 beam body runs, fp32
calls the warp body). A producer warp copies the part's keys, one contiguous run of K
and of V a ring stage, ``plane_unit(D)`` keys a stage; the consumer warps'
lane groups (``plane_lanes(D)`` lanes read one key row, 16 bytes each) take
``PLANE_STAGE_KEYS`` keys of each stage, key r of a stage to group r % groups,
each with its own online softmax; the groups merge at the end. Where the
blocks fill the card poorly the row's keys split into ``parts``, cut on the
device from the row's own [start, length), and a second launch merges the
parts' fp32 (o, m, l) with the fresh token; with one part the fresh token
opens lane group 0's softmax.

Here the plan (body, parts, ring stages, lanes a row) is checked at the timed
head shapes on 132 SMs and at its edges; a plain model of the parts' ranges
and of the stages' key slots puts every valid key in exactly one part, stage
and lane group; and the walk in plain torch (each lane group's partial, the
groups merged, the parts merged with the fresh token) is held against the
plain versions and against lia_tpu's Pallas kernels in interpret mode: fp32
within 1e-5, bf16 inputs within 2e-2 (outputs of O(1) round once to bf16,
2^-8 relative, and the sums run in another order). The Pallas side is
computed once per module.
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


def smem_bytes(D: int, stages: int) -> int:
    """A plane block's dynamic shared memory (csrc/plane_attn.cuh: smem_bytes):
    the ring's barriers (rounded to 128 bytes), then the larger of the ring (K
    and V of plane_unit(D) rows of D * 2 bytes a stage) and the warps' fp32
    partials."""
    ring = stages * 2 * ca.plane_unit(D) * D * 2
    partials = ca.PLANE_WARPS * (D + 2) * 4
    return -(-16 * stages // 128) * 128 + max(ring, partials)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,Nkv,S_max,D,plan", [
    (16, 32, 32, 320, 128, ("plane", 1, 3)),  # OPT-6.7B: 512 blocks, four an SM, 3 stages of 16 KB
    (16, 32, 32, 384, 80, ("plane", 1, 5)),  # OPT-2.7B: exact 160-byte rows, 10 KB stages
    (16, 64, 64, 384, 96, ("plane", 1, 4)),  # GPT-NeoX-20B: 1024 blocks, two waves of four an SM
    (16, 16, 16, 384, 256, ("plane", 1, 7)),  # GPT-J-6B: 256 blocks, two an SM
    (16, 32, 16, 384, 128, ("beam", 1, 0)),  # G = 2: the bf16 beam body, 256 blocks
    (16, 32, 8, 320, 128, ("beam", 1, 0)),  # Llama-3-8B (G = 4): 128 blocks
    (16, 16, 4, 384, 256, ("beam", 1, 0)),  # D = 256, G = 4: 64 blocks, beam_plan's 2 parts refused
    (16, 32, 2, 384, 128, ("beam", 4, 0)),  # ChatGLM3-6B (G = 16): 32 blocks, beam_plan's 4 parts
    (1, 32, 32, 2048, 128, ("plane", 4, 14)),  # one sequence: 32 blocks, 4 parts, one block an SM
    (1, 2, 2, 4096, 64, ("plane", 8, 14)),  # two kv heads over a long plane: 8 parts
    (2, 4, 4, 64, 128, ("plane", 1, 14)),  # a plane of one part's worth of slots: no split
])
def test_plane_plan(B, N, Nkv, S_max, D, plan):
    p = ca.plane_plan(B, N, Nkv, S_max, True, SMS, D)
    assert (p.body, p.parts, p.stages) == plan
    if p.body == "plane":
        assert smem_bytes(D, p.stages) <= ca.BLOCK_SMEM
        # the blocks an SM share its shared memory (1 KB a block reserved)
        per_sm = min(ca.PLANE_BLOCKS_AN_SM, -(-B * Nkv * p.parts // SMS))
        assert per_sm * (smem_bytes(D, p.stages) + 1024) <= ca.SM_SMEM
    else:  # beam_plan's beams a block, and its split where the blocks fill at most a quarter of the SMs
        bpc, host = ca.beam_plan(B, 1, N, Nkv, S_max, 0, SMS, D)
        blocks = Nkv * B * ca.query_runs(1, N // Nkv, bpc, ca.beam_queries(D))
        assert (p.bpc, p.parts) == (bpc, host if 4 * blocks <= SMS else 1)


def test_plane_plan_routes_by_group():
    """bf16 at one query head a kv head on the plane body, past it the bf16
    beam body (beam_plan's one-beam split), fp32 on the warp
    body; a forced part count reaches the plane and beam bodies, never the
    warp body."""
    assert ca.PLANE_MAX_GROUP == 1
    for G in range(1, 17):
        p = ca.plane_plan(4, 2 * G, 2, 256, True, SMS, 128)
        assert p.body == ("plane" if G <= ca.PLANE_MAX_GROUP else "beam")
        if p.body == "beam":
            assert (p.bpc, p.parts) == ca.beam_plan(4, 1, 2 * G, 2, 256, 0, SMS, 128)
        assert ca.plane_plan(4, 2 * G, 2, 256, False, SMS, 128) == ("warp", 1, 0, 1)
        assert ca.plane_plan(4, 2 * G, 2, 256, True, SMS, 128, parts=3).parts == 3
        assert ca.plane_plan(4, 2 * G, 2, 256, False, SMS, 128, parts=3).parts == 1


@pytest.mark.parametrize("D,lanes,unit", [(64, 8, 64), (80, 16, 32), (96, 16, 32), (128, 16, 32), (256, 32, 16)])
def test_plane_lanes_and_stages(D, lanes, unit):
    """A key row takes D / 8 lanes at the full widths (16 bytes a lane; 80 and
    96 over 128's 16 lanes, those past D / 8 idle); a stage holds 4 keys for
    each lane group of the 4 consumer warps, K and V copied at D * 2 bytes a
    row; the ring keeps at least 2 stages, and the blocks an SM holds fit its
    shared memory (1 KB a block reserved)."""
    assert (ca.plane_lanes(D), ca.plane_unit(D)) == (lanes, unit)
    assert ca.plane_unit(D) == ca.PLANE_STAGE_KEYS * ca.PLANE_WARPS * 32 // lanes
    for blocks in (1, 64, 512, 4096):
        st = ca.plane_stages(D, blocks, SMS)
        per_sm = min(ca.PLANE_BLOCKS_AN_SM, -(-blocks // SMS))
        assert 2 <= st <= ca.PLANE_MAX_STAGES
        assert per_sm * (smem_bytes(D, st) + 1024) <= ca.SM_SMEM and smem_bytes(D, st) <= ca.BLOCK_SMEM


# ---------------------------------------------------------------------------
# a plain model of the parts' ranges and the stages' key slots
# ---------------------------------------------------------------------------


def plane_ranges(lengths, starts, parts: int) -> torch.Tensor:
    """Keys [lo, hi) of part p of each row, as the kernel cuts them from the
    row's [start, length): lo = start + n * p // parts. lengths, starts int
    [B] -> int64 [B, parts, 2]."""
    lengths, starts = torch.as_tensor(lengths).long(), torch.as_tensor(starts).long()
    n = lengths - starts
    edges = starts[:, None] + n[:, None] * torch.arange(parts + 1)[None, :] // parts
    return torch.stack([edges[:, :-1], edges[:, 1:]], dim=-1)


def lane_groups(lo: int, hi: int, D: int) -> dict:
    """Each key of [lo, hi) as the kernel reads it: key -> (stage, lane group,
    step). Stage i holds keys lo + i * U .. of the run (U = plane_unit(D));
    its row r goes to lane group r % groups at step r // groups (groups =
    plane_unit(D) / PLANE_STAGE_KEYS)."""
    U = ca.plane_unit(D)
    groups = U // ca.PLANE_STAGE_KEYS
    return {t: ((t - lo) // U, ((t - lo) % U) % groups, ((t - lo) % U) // groups) for t in range(lo, hi)}


# (length, start) of plane rows: empty, start = length, one key, a start off a
# stage, a window of 8, rows over several stages, a full row
PLANE_ROWS = [(0, 0), (19, 19), (20, 19), (45, 37), (200, 5), (333, 0), (387, 2)]


@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_plane_ranges_cover_each_key_once(parts):
    """Every valid key [start, length) of every row in exactly one part, read
    once by one lane group at one of its PLANE_STAGE_KEYS steps of one stage
    (each stage's rows a contiguous run of the plane: one bulk copy of K and
    one of V); the parts' sizes within one of each other, a part past the
    keys empty."""
    lengths, starts = [n for n, _ in PLANE_ROWS], [s0 for _, s0 in PLANE_ROWS]
    ranges = plane_ranges(lengths, starts, parts)
    for D in (64, 80, 256):
        for b, (n, s0) in enumerate(zip(lengths, starts)):
            keys = []
            for lo, hi in ranges[b].tolist():
                slots = lane_groups(lo, hi, D)
                assert len(set(slots.values())) == len(slots)
                assert all(step < ca.PLANE_STAGE_KEYS for _, _, step in slots.values())
                stages = {}
                for t, (st, _, _) in slots.items():
                    stages.setdefault(st, []).append(t)
                assert all(ks == list(range(ks[0], ks[0] + len(ks))) for ks in stages.values())
                assert all(len(ks) <= ca.plane_unit(D) for ks in stages.values())
                keys.extend(range(lo, hi))
            assert keys == list(range(s0, n))
            sizes = (ranges[b, :, 1] - ranges[b, :, 0]).tolist()
            assert max(sizes) - min(sizes) <= 1


# ---------------------------------------------------------------------------
# the walk in plain torch: lane groups, their merge, the parts' merge
# ---------------------------------------------------------------------------


def _softmax_partial(s, allow, v):
    """Unnormalised (o, m, l) over the keys ``allow`` marks, scores s [..., K]
    already scaled, in exp2 units; nothing allowed: m = -1e30, l = 0, o = 0."""
    sp = torch.where(allow, s, torch.full_like(s, ca.NEG_INF))
    m = sp.amax(dim=-1)
    e = torch.where(allow, torch.exp2(sp - m[..., None]), torch.zeros_like(sp))
    return torch.einsum("bhgk,bhkd->bhgd", e, v), m, e.sum(dim=-1)


def _merge(parts, fresh=None):
    """(o, m, l) partials stacked on dim 0 rescaled to their common maximum and
    summed; then ``fresh`` (score [B, Nkv, G], value [B, Nkv, 1, D]) last."""
    o, m, l = parts
    M = m.amax(dim=0)
    if fresh is not None:
        M = torch.maximum(M, fresh[0])
    a = torch.exp2(m - M[None])
    O, L = (o * a[..., None]).sum(dim=0), (l * a).sum(dim=0)
    if fresh is not None:
        pf = torch.exp2(fresh[0] - M)
        O, L = O + pf[..., None] * fresh[1], L + pf
    return O, M, L


def plane_walk(q, k, v, kf, vf, slot_mask, length, parts, scale=None):
    """The kernel's arithmetic in plain torch over one plane k/v [B, N_kv, S,
    D] (kf None: B7/B8, the plane holds the token): each part's keys
    (:func:`plane_ranges`) split over the lane groups as the stages hand them
    out (:func:`lane_groups`), each group's fp32 partial, the groups merged;
    with one part the fresh token opens group 0's softmax, with several the
    parts' partials merge with it last (merge_kernel). Returns q's type."""
    B, _, N, D = q.shape
    Nkv, S = k.shape[1], k.shape[2]
    G = N // Nkv
    lengths = ca._lengths(length, q.device).expand(B).clamp(0, S)
    starts = (lengths - slot_mask.to(torch.int32).sum(dim=1)).clamp(min=0)
    ranges = plane_ranges(lengths, starts, parts)
    qs = q.float().reshape(B, Nkv, G, D) * ca._sscale(scale, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, k.float())
    groups = ca.plane_unit(D) // ca.PLANE_STAGE_KEYS
    fresh = None
    if kf is not None:
        fresh = (torch.einsum("bhgd,bhd->bhg", qs, kf.float()[:, :, 0]), vf.float())
    part_out = []
    for p in range(parts):
        grp = torch.full((B, S), -1)
        for b in range(B):
            lo, hi = ranges[b, p].tolist()
            for t, (_, g, _) in lane_groups(lo, hi, D).items():
                grp[b, t] = g
        gp = [_softmax_partial(s, (grp == g)[:, None, None, :], v.float()) for g in range(groups)]
        stacked = tuple(torch.stack(x) for x in zip(*gp))
        if parts == 1 and fresh is not None:  # the fresh token opens lane group 0's softmax
            o0, m0, l0 = _merge(tuple(x[:1] for x in stacked), fresh)
            stacked = (torch.cat([o0[None], stacked[0][1:]]), torch.cat([m0[None], stacked[1][1:]]),
                       torch.cat([l0[None], stacked[2][1:]]))
        part_out.append(_merge(stacked))
    o, m, l = _merge(tuple(torch.stack(x) for x in zip(*part_out)), fresh if parts > 1 else None)
    return (o / l.clamp(min=1e-30)[..., None]).reshape(B, 1, N, D).to(q.dtype)


# (name, L, B, Nkv, G, D, S_max, rows (length, start)): an empty row, start =
# length, one key, a window, rows past one stage at D = 80 and 256 (the plane
# body's one query head a kv head)
PLANE_CASES = [
    ("mha", 2, 4, 2, 1, 64, 80, ((0, 0), (19, 19), (20, 19), (80, 0))),
    ("window D=80", 1, 3, 4, 1, 80, 80, ((45, 37), (70, 5), (1, 0))),
    ("D=256", 2, 2, 3, 1, 256, 48, ((33, 2), (40, 0))),
]


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _inputs(case):
    name, L, B, Nkv, G, D, S, rows = case
    rng = _rng(name)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = np.zeros((B, S), bool)
    for b, (n, s0) in enumerate(rows):
        mask[b, s0:n] = True
    return dict(q=f(B, 1, Nkv * G, D), kf=f(B, Nkv, 1, D), vf=f(B, Nkv, 1, D), k=f(L, B, Nkv, S, D),
                v=f(L, B, Nkv, S, D), mask=mask, lengths=np.asarray([n for n, _ in rows], np.int32))


@pytest.fixture(scope="module")
def pallas_refs():
    """lia_tpu's B2 (fresh token), B7 (over the layer's plane) and B8 (the
    stacked entry) in interpret mode, fp32 and bf16, once per case; B7/B8
    over the same keys as B2 but without the fresh token."""
    refs = {}
    for jdt in (jnp.float32, jnp.bfloat16):
        for case in PLANE_CASES:
            x = _inputs(case)
            layer = case[1] - 1
            q, kf, vf, k, v = (jnp.asarray(x[n], jdt) for n in ("q", "kf", "vf", "k", "v"))
            mask, lengths = jnp.asarray(x["mask"]), jnp.asarray(x["lengths"])
            li = jnp.asarray(layer, jnp.int32)
            bf = jdt == jnp.bfloat16
            refs[case[0], "B2", bf] = np.asarray(pa.decode_attention_fresh(
                q, kf, vf, k, v, li, mask, lengths, block_k=16, interpret=True).astype(jnp.float32))
            refs[case[0], "B7", bf] = np.asarray(pa.decode_attention(
                q, k[layer], v[layer], mask, lengths, block_k=16, interpret=True).astype(jnp.float32))
            refs[case[0], "B8", bf] = np.asarray(pa.decode_attention_stacked(
                q, k, v, li, mask, lengths, block_k=16, interpret=True).astype(jnp.float32))
    return refs


def _walks(case, parts, dtype=torch.float32):
    """(walk, plain) of B2 and B7 on the case's inputs in ``dtype``."""
    x = _inputs(case)
    q, kf, vf, k, v = (torch.from_numpy(x[n]).to(dtype) for n in ("q", "kf", "vf", "k", "v"))
    mask, lengths = torch.from_numpy(x["mask"]), torch.from_numpy(x["lengths"])
    layer = case[1] - 1
    return {
        "B2": (plane_walk(q, k[layer], v[layer], kf, vf, mask, lengths, parts),
               ca.decode_attention_fresh_plain(q, kf, vf, k, v, layer, mask, lengths)),
        "B7": (plane_walk(q, k[layer], v[layer], None, None, mask, lengths, parts),
               ca.decode_attention_plain(q, k[layer], v[layer], mask, lengths)),
    }


@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("case", PLANE_CASES, ids=[c[0] for c in PLANE_CASES])
def test_walk_matches_plain(case, parts):
    """fp32: the walk (lane groups, parts, merges) equals the plain versions;
    a row without keys gives the fresh value (B2) or 0 (B7)."""
    for name, (out, ref) in _walks(case, parts).items():
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    if case[0] == "mha":
        x = _inputs(case)
        walks = _walks(case, parts)
        for b in (0, 1):
            assert (walks["B7"][0][b] == 0).all()
            np.testing.assert_allclose(walks["B2"][0][b, 0].numpy(), x["vf"][b, :, 0], rtol=1e-6, atol=1e-6)


def _keyed(case) -> np.ndarray:
    """The case's rows that hold a key. B7/B8's plane always holds the step's
    token; over a row without one the Pallas kernels average its masked block
    (p = exp2(-1e30 + 1e30) = 1), where the port and its plain version give 0
    (test_walk_matches_plain)."""
    return np.asarray([n > s0 for n, s0 in case[7]])


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("case", PLANE_CASES, ids=[c[0] for c in PLANE_CASES])
def test_walk_matches_pallas(pallas_refs, case, parts):
    walks, keyed = _walks(case, parts), _keyed(case)
    np.testing.assert_allclose(walks["B2"][0].numpy(), pallas_refs[case[0], "B2", False], rtol=1e-5, atol=1e-5)
    for name in ("B7", "B8"):
        np.testing.assert_allclose(walks["B7"][0].numpy()[keyed], pallas_refs[case[0], name, False][keyed],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", PLANE_CASES, ids=[c[0] for c in PLANE_CASES])
def test_walk_matches_pallas_bf16(pallas_refs, case):
    """bf16 inputs, the split forced to 2 parts: fp32 sums on both sides, the
    output rounded once; 2e-2 on outputs of O(1)."""
    walks, keyed = _walks(case, 2, torch.bfloat16), _keyed(case)
    assert walks["B2"][0].dtype == walks["B7"][0].dtype == torch.bfloat16
    np.testing.assert_allclose(walks["B2"][0].float().numpy(), pallas_refs[case[0], "B2", True], rtol=2e-2,
                               atol=2e-2)
    for name in ("B7", "B8"):
        np.testing.assert_allclose(walks["B7"][0].float().numpy()[keyed], pallas_refs[case[0], name, True][keyed],
                                   rtol=2e-2, atol=2e-2, err_msg=name)
