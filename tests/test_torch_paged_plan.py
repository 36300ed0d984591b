"""The paged decode kernel's decomposition (B5, ``csrc/paged_attn.cuh``), on
the CPU.

The kernel gives each (kv head, row) one block, or ``parts`` blocks where
those fill the card poorly; each part walks an even range of the row's pages,
cut on the device from the row's length, and writes fp32 (o, m, l) partials
that a second launch merges with the fresh chunk. Here the wrapper's choice
of parts and query chunks is checked; a plain model of the kernel's page
ranges (``part_pages``) is shown to put every page of every row in exactly
one part (lengths 0, ending mid-page and on a page boundary); and the split
in plain torch (``partials_plain``) merged as the kernel merges
(``merge_plain``) is held against ``paged_decode_attention_plain``
and against lia_tpu's ``paged_decode_attention`` in interpret mode: fp32
within 1e-5; bf16 inputs within 2e-2 (outputs of O(1) round once to bf16,
2^-8 relative, and the sums run in another order). The Pallas side is
computed once per module.
"""

import zlib

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.ops import paged as jpg

from lia_tpu_torch.ops import cuda_attention as ca

SMS = 132  # an H100 SXM


def part_pages(lengths, bs: int, parts: int) -> torch.Tensor:
    """The pages [p0, p1) that part p of the paged kernel's split walks in each
    row, as the kernel cuts them on the device from the row's length: the
    row's ceil(length / bs) pages in ``parts`` even ranges, p0 = np * p //
    parts. lengths int [B] → int64 [B, parts, 2]; a range with p0 == p1 is
    empty."""
    np_ = (torch.as_tensor(lengths).long().clamp(min=0) + bs - 1) // bs
    p = torch.arange(parts + 1)
    edges = np_[:, None] * p[None, :] // parts  # [B, parts + 1]
    return torch.stack([edges[:, :-1], edges[:, 1:]], dim=-1)


def partials_plain(q, k_pool, v_pool, layer_idx, block_table, lengths, parts: int, scale=None):
    """The paged kernel's split walk in plain torch, fp32: part p of each row
    attends the keys of its pages (:func:`part_pages`) below the row's
    length and returns its unnormalised (o [parts, B, C, N, D], m and l
    [parts, B, C, N]) as the kernel writes them to its workspace; an empty
    part has m = -1e30, l = 0 and o = 0. The fresh chunk is the merge's."""
    B, C, N, D = q.shape
    _, _, Nkv, bs, _ = k_pool.shape
    P = block_table.shape[1]
    G = N // Nkv
    S = P * bs
    lens = ca._lengths(lengths, q.device).expand(B).clamp(0, S)
    pages = part_pages(lens.cpu(), bs, parts).to(q.device)  # [B, parts, 2]

    def gather(pool):
        return pool[layer_idx][block_table.long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, D).float()

    k, v = gather(k_pool), gather(v_pool)
    key = torch.arange(S, device=q.device)
    page = key // bs
    qs = q.float().reshape(B, C, Nkv, G, D) * ca._sscale(scale, D)
    s = torch.einsum("bchgd,bhkd->bhgck", qs, k)  # [B, Nkv, G, C, S]
    outs, ms, ls = [], [], []
    for p in range(parts):
        allow = ((page[None, :] >= pages[:, p, :1]) & (page[None, :] < pages[:, p, 1:])
                 & (key[None, :] < lens[:, None]))  # [B, S]
        sp = torch.where(allow[:, None, None, None], s, torch.full_like(s, ca.NEG_INF))
        m = sp.amax(dim=-1, keepdim=True)
        e = torch.where(allow[:, None, None, None], torch.exp2(sp - m), torch.zeros_like(sp))
        o = torch.einsum("bhgck,bhkd->bhgcd", e, v)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, C, N, D))
        ms.append(m[..., 0].permute(0, 3, 1, 2).reshape(B, C, N))
        ls.append(e.sum(dim=-1).permute(0, 3, 1, 2).reshape(B, C, N))
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def merge_plain(o, m, l, q, k_fresh=None, v_fresh=None, scale=None):
    """The paged kernel's merge (merge_kernel, or the block itself with one
    part): the parts' partials of :func:`partials_plain` rescaled to
    their common maximum, then (with the fresh chunk [B, N_kv, C, D]) chunk
    row c's fresh keys 0..c merged last; out = o / max(l, 1e-30) in q's type."""
    B, C, N, D = q.shape
    M = m.amax(dim=0)  # [B, C, N]
    if k_fresh is not None:
        Nkv = k_fresh.shape[1]
        G = N // Nkv
        qs = q.float().reshape(B, C, Nkv, G, D) * ca._sscale(scale, D)
        sf = torch.einsum("bchgd,bhjd->bchgj", qs, k_fresh.float()).reshape(B, C, N, C)
        tri = torch.tril(torch.ones(C, C, dtype=torch.bool, device=q.device))[None, :, None, :]
        M = torch.maximum(M, torch.where(tri, sf, torch.full_like(sf, ca.NEG_INF)).amax(dim=-1))
    a = torch.exp2(m - M[None])
    L = (l * a).sum(dim=0)
    O = (o * a[..., None]).sum(dim=0)
    if k_fresh is not None:
        pf = torch.where(tri, torch.exp2(sf - M[..., None]), torch.zeros_like(sf))  # [B, C, N, C]
        L = L + pf.sum(dim=-1)
        vf = v_fresh.float().repeat_interleave(G, dim=1)  # [B, N, C, D]
        O = O + torch.einsum("bcnj,bnjd->bcnd", pf, vf)
    return (O / L.clamp(min=1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("B,C,N,Nkv,P,parts", [
    (16, 1, 32, 32, 18, 1),  # the kernels line's case: OPT-6.7B b16, 512 blocks
    (16, 1, 32, 32, 64, 1),  # serve-paged's step: 1024 slots in pages of 16
    (16, 4, 32, 32, 64, 1),  # verify at C = 4: 4 queries a (kv head, row), 512 blocks
    (16, 1, 32, 8, 18, 4),  # Llama-3-8B's G = 4: 128 blocks
    (16, 1, 32, 8, 63, 4),  # the same over ~1000-token rows
    (16, 4, 32, 8, 64, 4),  # verify at C = 4, G = 4: 16 queries, one block a (kv head, row)
    (16, 4, 64, 8, 64, 2),  # G = 8, C = 4: 32 queries in two chunks, 256 blocks
    (1, 1, 32, 32, 64, 8),  # one sequence: 32 blocks, capped at 8 parts
    (1, 1, 32, 32, 3, 3),  # ... and at the table's 3 pages
    (64, 1, 32, 32, 600, 3),  # 600 table entries: parts stage at most 256 each
])
def test_split_parts(B, C, N, Nkv, P, parts):
    assert ca.paged_split_parts(B, C, N, Nkv, P, SMS) == parts


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("B,C,G,Nkv,P", [(1, 1, 1, 1, 1), (3, 5, 2, 4, 40), (16, 1, 8, 1, 1000),
                                         (2, 1, 1, 2, 257), (8, 9, 4, 2, 64)])
def test_split_parts_bounds(B, C, G, Nkv, P, sms):
    """At least one part, a part stages at most PAGED_MAX_TABLE table entries,
    and beyond that no more parts than PAGED_MAX_PARTS, than the table's pages,
    or than bring the blocks to four an SM."""
    parts = ca.paged_split_parts(B, C, G * Nkv, Nkv, P, sms)
    blocks = Nkv * B * ca.paged_query_chunks(G, C)
    assert parts >= 1 and -(-P // parts) <= ca.PAGED_MAX_TABLE
    if parts > -(-P // ca.PAGED_MAX_TABLE):
        assert parts <= min(ca.PAGED_MAX_PARTS, P) and blocks * parts <= 4 * sms


@pytest.mark.parametrize("G,C,chunks", [(1, 1, 1), (4, 1, 1), (1, 4, 1), (2, 3, 1), (4, 4, 1), (8, 2, 1),
                                        (8, 4, 2), (8, 5, 3), (1, 17, 2)])
def test_query_chunks(G, C, chunks):
    """A block holds up to 16 of a (kv head, row)'s G * C queries."""
    assert ca.paged_query_chunks(G, C) == chunks


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_part_pages_cover_each_page_once(bs, parts):
    """Lengths 0, one key, mid-page, on a page boundary and one past it: the
    parts' ranges tile each row's ceil(length / bs) pages in order, each page
    in one part, the ranges' sizes within one of each other, and a page at or
    past the frontier in none."""
    lengths = [0, 1, bs // 2, bs, bs + 1, 3 * bs, 5 * bs - 3, 40 * bs]
    pages = part_pages(torch.tensor(lengths), bs, parts)
    assert pages.shape == (len(lengths), parts, 2)
    for b, n in enumerate(lengths):
        n_pages = -(-n // bs)
        seen = [p for lo, hi in pages[b].tolist() for p in range(lo, hi)]
        assert seen == list(range(n_pages))  # every page once, in order, none past the frontier
        sizes = (pages[b, :, 1] - pages[b, :, 0]).tolist()
        assert max(sizes) - min(sizes) <= 1


# (name, L, nb, Nkv, bs, D, G, C, P, layer, lengths): ragged rows with empty,
# mid-page and page-end lengths, GQA, a verify chunk (C = 3) and pages of 4
CASES = [
    ("decode", 2, 40, 4, 8, 16, 1, 1, 6, 1, (0, 5, 8, 16, 37)),
    ("gqa", 1, 30, 2, 8, 16, 4, 1, 5, 0, (13, 24, 40)),
    ("verify C=3", 2, 40, 2, 8, 16, 2, 3, 6, 1, (0, 20, 31, 48)),
    ("pages of 4", 1, 40, 2, 4, 16, 2, 1, 9, 0, (0, 4, 17, 33)),
    ("G=8 C=2", 1, 24, 1, 8, 32, 8, 2, 7, 0, (1, 56, 23)),
]


def _inputs(case, dtype=np.float32):
    name, L, nb, Nkv, bs, D, G, C, P, layer, lengths = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B = len(lengths)
    f = lambda *s: rng.standard_normal(s).astype(np.float32).astype(dtype)  # noqa: E731
    table = (rng.permutation(nb - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    for b, n in enumerate(lengths):  # the null page 0 past each row's frontier
        table[b, -(-n // bs):] = 0
    return dict(q=f(B, C, Nkv * G, D), kp=f(L, nb, Nkv, bs, D), vp=f(L, nb, Nkv, bs, D), kf=f(B, Nkv, C, D),
                vf=f(B, Nkv, C, D), table=table, lengths=np.asarray(lengths, np.int32), layer=layer)


@pytest.fixture(scope="module")
def pallas_refs():
    """lia_tpu's paged_decode_attention (interpret mode) of every case, with and
    without the fresh chunk, in fp32 and on bf16 inputs, once."""
    refs = {}
    for case in CASES:
        for dt, jdt in ((np.float32, jnp.float32), (np.float32, jnp.bfloat16)):
            x = _inputs(case)
            a = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 else jnp.asarray(v)
                 for k, v in x.items() if k != "layer"}
            for fresh in (False, True):
                kw = dict(k_fresh=a["kf"], v_fresh=a["vf"]) if fresh else {}
                out = jpg.paged_decode_attention(a["q"], a["kp"], a["vp"], jnp.asarray(x["layer"], jnp.int32),
                                                 a["table"], a["lengths"], interpret=True, **kw)
                refs[case[0], jdt == jnp.bfloat16, fresh] = np.asarray(out.astype(jnp.float32))
    return refs


def _split(case, parts, fresh, dtype=torch.float32):
    x = _inputs(case)
    t = {k: torch.from_numpy(v) for k, v in x.items() if k != "layer"}
    for k in ("q", "kp", "vp", "kf", "vf"):
        t[k] = t[k].to(dtype)
    o, m, l = partials_plain(t["q"], t["kp"], t["vp"], x["layer"], t["table"], t["lengths"], parts)
    fr = (t["kf"], t["vf"]) if fresh else (None, None)
    out = merge_plain(o, m, l, t["q"], *fr)
    ref = ca.paged_decode_attention_plain(t["q"], t["kp"], t["vp"], x["layer"], t["table"], t["lengths"],
                                          *(fr if fresh else ()))
    return out, ref, m


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("parts", [1, 2, 3, 8])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_merge_matches_plain(case, parts, fresh):
    out, ref, m = _split(case, parts, fresh)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    if not fresh:  # a row with no key and no fresh chunk gives 0
        for b, n in enumerate(case[-1]):
            if n == 0:
                assert (out[b] == 0).all()
    if parts == 8:  # more parts than a short row has pages: some parts are empty
        assert bool((m == ca.NEG_INF).any())


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_merge_matches_pallas(pallas_refs, case, parts, fresh):
    out, _, _ = _split(case, parts, fresh)
    np.testing.assert_allclose(out.numpy(), pallas_refs[case[0], False, fresh], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_split_merge_matches_pallas_bf16(pallas_refs, case, parts):
    """bf16 inputs: the split in fp32 rounds its output to bf16 once; the
    Pallas kernel sums in bf16-fed fp32 in another order. 2e-2 on outputs of
    O(1)."""
    out, _, _ = _split(case, parts, True, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas_refs[case[0], True, True], rtol=2e-2, atol=2e-2)
