"""The flash kernels' split of a tile's key walk into parts, on the CPU.

When a call's (row tile, kv head, batch row) tiles are fewer than the card's
SMs, the flash kernels split each tile's walk over the key tiles into parts
that write fp32 partials, and a second launch merges them. Here the host's
choice of the number of parts and of the consumer warpgroups a block is
checked, and the split in plain torch
(``flash_partials_plain``) merged as the kernel merges (``flash_merge_plain``)
is held against ``flash_attention_cached_plain`` (fp32, 1e-5) and against
lia_tpu's ``flash_attention_cached`` in interpret mode, including empty parts,
fully masked rows and a window. The Pallas side is computed once per module.
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


@pytest.mark.parametrize("B,C,N,Nkv,S_kv,parts", [
    (16, 256, 32, 32, 256, 1),  # B1 on the main path: OPT-6.7B b16 s256
    (16, 256, 32, 8, 256, 1),  # B1 at Llama-3-8B's G = 4
    (4, 256, 32, 32, 1024, 1),  # a chunk256 batch of 4 rows
    (1, 256, 32, 32, 1024, 1),  # B6's timed shape: 128 tiles, a suffix at base 768
    (1, 128, 32, 32, 1024, 2),  # 64 tiles
    (1, 48, 32, 32, 1024, 4),  # a short prefix-cache suffix: 32 tiles
    (1, 48, 32, 8, 1024, 5),  # the same at G = 4: 3 tiles a kv head
    (1, 256, 32, 32, 256, 1),  # one prompt of 256
    (2, 8, 8, 1, 4096, 16),  # two tiles: capped at 16 parts
    (1, 16, 4, 4, 64, 1),  # one key tile: nothing to split
    (1, 16, 4, 4, 192, 1),  # three key tiles: a part keeps two
])
def test_split_parts(B, C, N, Nkv, S_kv, parts):
    assert ca.flash_split_parts(B, C, N, Nkv, S_kv, SMS) == parts


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("B,C,G,Nkv,S_kv", [(1, 1, 1, 1, 64), (1, 33, 3, 2, 1000), (3, 100, 8, 4, 2048),
                                             (8, 64, 1, 8, 512), (1, 7, 64, 1, 300)])
def test_split_parts_bounds(B, C, G, Nkv, S_kv, sms):
    """Parts only below one tile per SM, at most one block per SM and 16 parts,
    each part keeping two of the plane's key tiles."""
    parts = ca.flash_split_parts(B, C, G * Nkv, Nkv, S_kv, sms)
    tiles = -(-C // (64 // G)) * Nkv * B
    assert 1 <= parts <= ca.FLASH_MAX_PARTS
    if parts > 1:
        assert tiles * parts <= sms and 2 * parts <= -(-S_kv // 64)
    if 2 * tiles > sms:
        assert parts == 1


@pytest.mark.parametrize("B,C,N,Nkv,parts,nw", [
    (16, 256, 32, 32, 1, 1),  # B1 on the main path: 2048 tiles, two blocks an SM
    (4, 256, 32, 32, 1, 1),  # a chunk256 batch of 4 rows: 512 tiles
    (1, 256, 32, 32, 1, 2),  # B6's timed shape: 128 tiles, one block an SM
    (1, 48, 32, 32, 4, 2),  # the short suffix split: 32 tiles x 4 parts
    (1, 48, 32, 32, 16, 1),  # the same with 16 parts forced: 512 blocks
    (1, 48, 32, 8, 5, 2),  # at G = 4: 24 tiles x 5 parts
])
def test_warpgroups(B, C, N, Nkv, parts, nw):
    """Two consumer warpgroups a block exactly where the grid is at most one
    block an SM."""
    assert ca.flash_warpgroups(B, C, N, Nkv, parts, SMS) == nw


def test_merge_plain_of_empty_parts_is_zero():
    o = torch.full((3, 2, 4), float("nan"))  # an empty part's o is never read
    m = torch.full((3, 2), -float("inf"))
    l = torch.zeros(3, 2)
    out = ca.flash_merge_plain(o, m, l)
    assert torch.equal(out, torch.zeros(2, 4))


def test_merge_plain_is_the_softmax_of_the_union():
    """Two parts over disjoint keys merge to attention over both."""
    g = torch.Generator().manual_seed(0)
    s, v = torch.randn(2, 5, generator=g), torch.randn(2, 5, 3, generator=g)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[:, None])
    o = torch.einsum("pk,pkd->pd", p, v)
    out = ca.flash_merge_plain(o[:, None], m[:, None], p.sum(dim=-1)[:, None])[0]
    pf = torch.exp2(s.reshape(-1) - s.max())
    ref = (pf[:, None] * v.reshape(10, 3)).sum(0) / pf.sum()
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


# (name, B, C, N, Nkv, S_max, bases, starts, window): 64-key tiles over a
# 256-slot plane, so a walk has up to 4 tiles and 6 parts leave some empty
CASES = [
    ("suffix", 1, 20, 4, 4, 256, (200,), (0,), None),
    ("gqa per-row bases", 2, 70, 8, 2, 256, (150, 20), (0, 3), None),
    ("left pads, all-pad row", 3, 40, 4, 4, 256, (0, 100, 0), (9, 0, 40), None),
    ("window", 2, 30, 8, 2, 256, (180, 60), (0, 10), 70),
    ("G=8 window inside a tile", 1, 50, 8, 1, 256, (120,), (5,), 37),
]


def _inputs(case):
    name, B, C, N, Nkv, S_max, bases, starts, window = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.standard_normal((B, C, N, 16)).astype(np.float32)
    k = rng.standard_normal((B, Nkv, S_max, 16)).astype(np.float32)
    v = rng.standard_normal((B, Nkv, S_max, 16)).astype(np.float32)
    sm = np.zeros((B, S_max), bool)
    valid = np.zeros((B, C, 1, 1), bool)  # rows at a valid slot
    for b, (base, st) in enumerate(zip(bases, starts)):
        sm[b, st : base + C] = True
        valid[b, max(st - base, 0):] = True
    return q, k, v, np.asarray(bases, np.int32), sm, window, valid


@pytest.fixture(scope="module")
def pallas_refs():
    """lia_tpu's flash_attention_cached (interpret mode) of every case, once."""
    refs = {}
    for case in CASES:
        q, k, v, bases, sm, window, _ = _inputs(case)
        refs[case[0]] = np.asarray(pa.flash_attention_cached(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bases), jnp.asarray(sm),
            block_k=64, window=window, interpret=True), np.float32)
    return refs


def _split(case, parts):
    q, k, v, bases, sm, window, valid = _inputs(case)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    tb, tsm = torch.from_numpy(bases), torch.from_numpy(sm)
    o, m, l = ca.flash_partials_plain(tq, tk, tv, tb, tsm, parts, window=window)
    out = ca.flash_merge_plain(o, m, l)
    ref = ca.flash_attention_cached_plain(tq, tk, tv, tb, tsm, window=window)
    return out, ref, m, valid


@pytest.mark.parametrize("parts", [1, 2, 3, 6])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_merge_matches_plain(case, parts):
    out, ref, m, valid = _split(case, parts)
    assert torch.isfinite(out).all()  # fully masked rows too
    np.testing.assert_allclose(out.numpy() * valid, ref.numpy() * valid, rtol=1e-5, atol=1e-5)
    if parts == 6:  # more parts than a walk has tiles: some parts are empty
        assert bool((m == -float("inf")).any())


@pytest.mark.parametrize("parts", [1, 4, 6])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_merge_matches_pallas(pallas_refs, case, parts):
    out, _, _, valid = _split(case, parts)
    np.testing.assert_allclose(out.numpy() * valid, pallas_refs[case[0]] * valid, rtol=1e-5, atol=1e-5)
