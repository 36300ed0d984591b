"""How the attention kernels cut a kv head's queries at large groups, on the CPU:
Falcon-7B's G = 71 (N 71 over one KV head) and ChatGLM3-6B's G = 16 (N 32
over 2), at the plans' edges.

- Flash tiles: past G = 64, 64 flat (position, head) rows t * G + g a tile,
  so at G = 71 a position's heads straddle two tiles (``flash_tile_rows``);
  up to 64, 64 // G whole positions a tile. The host's tile count and split
  follow, and the plain split walk cut from each tile's own positions, merged,
  equals the plain attention.
- Query runs (``query_runs``): the decode kernels' blocks of a unit's flat
  queries, and a mirror of the kernels' run arithmetic (csrc/decode_int8_attn.cuh,
  csrc/beam_attn.cuh: q0, nq, the beams a run reaches, each token's queries)
  covering every query once.
- The plans' parts and beams a block at those groups (B3, B9, B10, B5).
"""

import pytest
import torch

from lia_tpu_torch.ops import cuda_attention as ca

SMS = 132  # an H100 SXM
FALCON = (71, 1)  # (N, N_kv)
CHATGLM = (32, 2)


@pytest.mark.parametrize("C,G,t,g,first,last", [
    (256, 71, 0, 0, 0, 0),  # tile 0: position 0, heads 0..63
    (256, 71, 0, 70, 0, 1),  # head 70 of position 0 is in tile 1, with position 1's heads 0..56
    (256, 71, 1, 56, 0, 1),
    (256, 71, 1, 57, 1, 2),  # tile 2 starts at flat row 128: position 1, head 57
    (256, 71, 255, 70, 255, 255),  # the last (ragged) tile: flat rows 18112..18175
    (256, 16, 5, 3, 4, 7),  # G = 16: 4 whole positions a tile
    (3, 16, 2, 15, 0, 2),  # a chunk shorter than a tile: one tile of 48 rows
    (5, 3, 4, 2, 0, 4),  # G = 3: 21 whole positions a tile, 5 of them here
    (40, 3, 20, 2, 0, 20),  # tile 0 ends at position 20
    (40, 3, 21, 0, 21, 39),  # tile 1 from position 21
    (3, 128, 1, 0, 1, 1),  # G = 128: two tiles a position
])
def test_flash_tile_rows(C, G, t, g, first, last):
    pos0, pos_last = ca.flash_tile_rows(C, G)
    assert (pos0[t, g].item(), pos_last[t, g].item()) == (first, last)


@pytest.mark.parametrize("C,G", [(256, 1), (256, 4), (48, 8), (7, 64), (100, 2)])
def test_flash_tile_rows_where_g_divides_64(C, G):
    """Where G divides 64 a tile holds 64 / G whole positions: the mapping of
    the kernels before tiles could straddle."""
    per = 64 // G
    pos0, last = ca.flash_tile_rows(C, G)
    t = torch.arange(C)[:, None].expand(C, G)
    assert torch.equal(pos0, t // per * per)
    assert torch.equal(last, torch.clamp(t // per * per + per, max=C) - 1)


@pytest.mark.parametrize("B,C,heads,parts", [
    (16, 256, FALCON, 1),  # B1 at Falcon-7B b16 s256: 284 tiles a row
    (16, 256, CHATGLM, 1),  # ChatGLM3-6B: 64 tiles a row and kv head
    (1, 256, FALCON, 1),  # B6's chunk at base 768: 284 tiles
    (1, 48, FALCON, 2),  # a 48-row suffix: 54 tiles, two parts
    (1, 48, CHATGLM, 5),  # 12 tiles x 2 kv heads = 24
    (1, 1, FALCON, 8),  # one position: 2 tiles, each part two of the 16 key tiles
])
def test_flash_split_parts_at_large_groups(B, C, heads, parts):
    N, Nkv = heads
    assert ca.flash_split_parts(B, C, N, Nkv, 1024, SMS) == parts
    G = N // Nkv  # whole positions a tile up to 64, flat rows past it
    assert ca._flash_tiles(B, C, N, Nkv) == (-(-C // (64 // G)) if G <= 64 else -(-C * G // 64)) * Nkv * B


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("heads", [FALCON, CHATGLM, (6, 2), (128, 1)], ids=["G71", "G16", "G3", "G128"])
def test_flash_split_walk_at_large_groups(heads, window, parts):
    """The split walk with tiles that straddle positions, merged as the kernel
    merges it, equals the plain attention (fp32, 1e-5): a 24-row chunk at
    base 100 of a 200-slot plane, left pads in one row."""
    N, Nkv = heads
    gen = torch.Generator().manual_seed(N)
    B, C, S, D, base = 2, 24, 200, 16, 100
    q = torch.randn(B, C, N, D, generator=gen)
    k, v = torch.randn(B, Nkv, S, D, generator=gen), torch.randn(B, Nkv, S, D, generator=gen)
    sm = torch.zeros(B, S, dtype=torch.bool)
    sm[0, : base + C] = True
    sm[1, 40 : base + C] = True
    merged = ca.flash_merge_plain(*ca.flash_partials_plain(q, k, v, base, sm, parts, window=window))
    ref = ca.flash_attention_cached_plain(q, k, v, base, sm, window=window).float()
    torch.testing.assert_close(merged, ref, rtol=1e-5, atol=1e-5)


def kernel_runs(nb: int, G: int, bpc: int, nq_max: int):
    """The decode kernels' runs, as csrc/decode_int8_attn.cuh and
    csrc/beam_attn.cuh compute them from the block's chunk: [(q0, nq, j0,
    nbc, [(token, first, end) of each beam's queries in the run])]."""
    qpc = min(bpc * G, nq_max)
    out = []
    for chunk in range(ca.query_runs(nb, G, bpc, nq_max)):
        q0 = chunk * qpc
        nq = min(qpc, nb * G - q0)
        j0 = q0 // G
        nbc = (q0 + nq - 1) // G - j0 + 1

        def first_query(t):
            return min(max((j0 + t) * G - q0, 0), nq)

        out.append((q0, nq, j0, nbc, [(t, first_query(t), first_query(t + 1)) for t in range(nbc)]))
    return out


@pytest.mark.parametrize("nb,G,bpc,nq_max,runs", [
    (1, 71, 1, 8, 9),  # B3 at Falcon-7B: a row's 71 heads in runs of 8, the last of 7
    (1, 16, 1, 8, 2),  # B3 at ChatGLM3-6B
    (1, 4, 1, 8, 1),  # B3 at Llama-3-8B: one run of G
    (4, 71, 1, 8, 36),  # B10 at Falcon-7B, 4 beams: 284 queries, runs of 8 that straddle beams
    (4, 16, 1, 8, 8),  # B10 at ChatGLM3-6B: two runs a beam
    (4, 71, 1, 16, 18),  # B9 at Falcon-7B: runs of 16, the last of 12
    (4, 16, 1, 16, 4),  # B9 at ChatGLM3-6B: one beam a run
    (4, 4, 4, 16, 1),  # B9 at Llama-3-8B: the group's 4 beams in one block
    (3, 3, 2, 8, 2),  # B10 at G = 3: whole beams, 2 then 1
    (3, 128, 1, 16, 24),  # G = 128, the gate's edge
])
def test_query_runs_cover_every_query_once(nb, G, bpc, nq_max, runs):
    assert ca.query_runs(nb, G, bpc, nq_max) == runs
    seen = []
    for q0, nq, j0, nbc, tokens in kernel_runs(nb, G, bpc, nq_max):
        assert 1 <= nq <= nq_max and nbc <= (2 if G > nq_max else bpc)
        for t, lo, hi in tokens:  # each of the run's queries belongs to the token of its beam
            assert lo < hi
            for j in range(lo, hi):
                assert (q0 + j) // G == j0 + t
        assert tokens[0][1] == 0 and tokens[-1][2] == nq  # the tokens' queries tile the run
        assert all(a[2] == b[1] for a, b in zip(tokens, tokens[1:]))
        seen += range(q0, q0 + nq)
    assert seen == list(range(nb * G))


@pytest.mark.parametrize("B,nb,heads,S_p,T,plan", [
    (16, 4, FALCON, 256, 32, (1, 1)),  # B9: 72 blocks, one an SM already
    (16, 4, CHATGLM, 256, 32, (1, 4)),  # B9: 32 blocks, the walk split in 4
    (16, 4, FALCON, 1024, 32, (1, 1)),
])
def test_beam_plan_at_large_groups(B, nb, heads, S_p, T, plan):
    N, Nkv = heads
    assert ca.beam_plan(B, nb, N, Nkv, S_p, T, SMS) == plan


@pytest.mark.parametrize("B,nb,heads,S_p,T,plan", [
    (16, 4, FALCON, 256, 128, (1, 1)),  # B10: 144 blocks
    (16, 4, CHATGLM, 256, 128, (1, 1)),  # 64 blocks, a short walk
    (16, 4, CHATGLM, 2048, 128, (1, 2)),  # a long prompt splits
])
def test_int8_beam_plan_at_large_groups(B, nb, heads, S_p, T, plan):
    N, Nkv = heads
    assert ca.int8_beam_plan(B, nb, N, Nkv, S_p, T, SMS) == plan


@pytest.mark.parametrize("B,heads,S_max,parts", [
    (16, FALCON, 384, 1),  # B3 at Falcon-7B: 144 blocks
    (16, CHATGLM, 2048, 2),  # 64 blocks over 2048 slots
    (1, FALCON, 4096, 4),  # one row: 9 blocks, a long walk
])
def test_int8_decode_parts_at_large_groups(B, heads, S_max, parts):
    N, Nkv = heads
    assert ca.int8_decode_parts(B, N, Nkv, S_max, SMS) == parts


@pytest.mark.parametrize("G,C,chunks", [(71, 1, 5), (71, 4, 18), (16, 1, 1), (16, 4, 4), (128, 4, 32)])
def test_paged_query_chunks_at_large_groups(G, C, chunks):
    assert ca.paged_query_chunks(G, C) == chunks


def test_head_gate():
    """Any group from 1 to KERNEL_MAX_GROUP at D 64, 80, 96, 112 (MPT-30B's,
    since ALiBi's port) 128 and 256; nothing else."""
    for N, Nkv, D in ((71, 1, 64), (32, 2, 128), (128, 1, 128), (6, 2, 64), (8, 8, 128), (32, 2, 80),
                      (64, 64, 96), (16, 16, 256), (16, 4, 256), (64, 64, 112), (32, 2, 112)):
        ca._check_heads(N, Nkv, D)
    for N, Nkv, D in ((129, 1, 64), (32, 3, 128), (32, 2, 120), (32, 32, 48), (32, 0, 64)):
        with pytest.raises(ValueError, match="unsupported head shape"):
            ca._check_heads(N, Nkv, D)
