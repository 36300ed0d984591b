"""The port's paged KV cache (lia_tpu_torch.ops.paged) against lia_tpu.ops.paged
on the CPU: the pool ops bit-equal on the same numpy inputs, the
paged_decode_attention kernel's plain version against the Pallas kernel in
interpret mode, the front doors against the gather golden paths, and one paged
decode step against lia_tpu's."""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import attention as jatt
from lia_tpu.ops import paged as jpg
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops import paged as pg
from lia_tpu_torch.utils.checkpoint import params_from_jax

TOL = 2e-5  # fp32: the same math summed in another order


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cfg():
    return get_config("opt-tiny")  # 4 kv heads, D=16


def test_slot_mapping_matches_lia_tpu():
    table = np.asarray([[3, 1, 7], [0, 5, 2]], np.int32)
    pos = np.asarray([17, 2], np.int32)  # block 1 offset 1; block 0 offset 2
    ref = jpg.slot_mapping(jnp.asarray(table), jnp.asarray(pos), block_size=16)
    out = pg.slot_mapping(t(table), t(pos), 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), [1 * 16 + 1, 0 * 16 + 2])


def test_paged_matches_contiguous(cfg, rng):
    """A pool filled token by token through reshape_and_cache (bit-equal to
    lia_tpu's pool), then decode attention against the contiguous golden path."""
    B, D, H, bs, n_tok = 2, cfg.head_dim, cfg.num_kv_heads, 8, 19
    jc = jpg.init_paged_cache(j_get_config("opt-tiny"), num_blocks=16, block_size=bs, dtype=jnp.float32)
    tc = pg.init_paged_cache(cfg, num_blocks=16, block_size=bs, dtype=torch.float32)
    table = np.asarray([[2, 9, 4], [11, 0, 7]], np.int32)  # shuffled blocks per sequence
    ks = rng.standard_normal((n_tok, B, H, 1, D)).astype(np.float32)
    vs = rng.standard_normal((n_tok, B, H, 1, D)).astype(np.float32)
    for i in range(n_tok):
        jslots = jpg.slot_mapping(jnp.asarray(table), jnp.full((B,), i, jnp.int32), bs)
        jc = jpg.reshape_and_cache(jnp.asarray(ks[i]), jnp.asarray(vs[i]), jc, jslots)
        tslots = pg.slot_mapping(t(table), torch.full((B,), i, dtype=torch.int32), bs)
        assert pg.reshape_and_cache(t(ks[i]), t(vs[i]), tc, tslots) is tc  # in place
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))

    q = rng.standard_normal((B, 1, cfg.num_heads, D)).astype(np.float32)
    lengths = np.asarray([n_tok, 12], np.int32)
    out = pg.paged_attention(t(q), tc, t(table), t(lengths))
    k_flat = ks[:, :, :, 0, :].transpose(1, 2, 0, 3)  # [B, H, S, D]
    v_flat = vs[:, :, :, 0, :].transpose(1, 2, 0, 3)
    mask = (np.arange(n_tok)[None, :] < lengths[:, None])[:, None, :]
    ref = jatt.attend(jnp.asarray(q), jnp.asarray(k_flat), jnp.asarray(v_flat), jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    ref_j = jpg.paged_attention(jnp.asarray(q), jc, jnp.asarray(table), jnp.asarray(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), rtol=TOL, atol=TOL)


def test_block_reuse_isolation(cfg):
    """Two sequences sharing no blocks do not read each other's tokens."""
    bs = 4
    cache = pg.init_paged_cache(cfg, num_blocks=8, block_size=bs, dtype=torch.float32)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    B, H, D = 2, cfg.num_kv_heads, cfg.head_dim
    k0 = torch.ones(B, H, 1, D) * torch.tensor([1.0, 100.0])[:, None, None, None]
    pg.reshape_and_cache(k0, k0, cache, pg.slot_mapping(table, torch.zeros(B, dtype=torch.int32), bs))
    q = torch.ones(B, 1, cfg.num_heads, D)
    out = pg.paged_attention(q, cache, table, torch.ones(B, dtype=torch.int32))
    torch.testing.assert_close(out[0], torch.full_like(out[0], 1.0))
    torch.testing.assert_close(out[1], torch.full_like(out[1], 100.0))


def _kernel_inputs(rng, L, nb, Nkv, bs, D, B, C, G, P):
    N = Nkv * G
    return dict(
        kp=rng.standard_normal((L, nb, Nkv, bs, D)).astype(np.float32),
        vp=rng.standard_normal((L, nb, Nkv, bs, D)).astype(np.float32),
        q=rng.standard_normal((B, C, N, D)).astype(np.float32),
        kf=rng.standard_normal((B, Nkv, C, D)).astype(np.float32),
        vf=rng.standard_normal((B, Nkv, C, D)).astype(np.float32),
        table=(rng.permutation(nb - 1)[: B * P] + 1).reshape(B, P).astype(np.int32),
    )


# (L, nb, Nkv, bs, D, B, C, G, P, layer, lengths, fresh): lia_tpu's kernel tests
# (disjoint pages, ragged lengths; the fresh merge with GQA), a C=3 chunk with
# the intra-chunk causal triangle and an empty row, and empty rows without fresh
PAGED_CASES = [
    (2, 16, 4, 8, 16, 3, 1, 1, 4, 1, (29, 8, 17), False),
    (1, 8, 4, 8, 16, 2, 1, 2, 3, 0, (13, 20), True),
    (2, 16, 2, 8, 16, 3, 3, 2, 4, 1, (0, 20, 31), True),
    (1, 16, 2, 4, 16, 3, 1, 4, 5, 0, (0, 5, 17), False),
]


@pytest.mark.parametrize("L,nb,Nkv,bs,D,B,C,G,P,layer,lengths,fresh", PAGED_CASES)
def test_paged_kernel_plain_matches_pallas(rng, L, nb, Nkv, bs, D, B, C, G, P, layer, lengths, fresh):
    x = _kernel_inputs(rng, L, nb, Nkv, bs, D, B, C, G, P)
    kw = dict(k_fresh=jnp.asarray(x["kf"]), v_fresh=jnp.asarray(x["vf"])) if fresh else {}
    ref = jpg.paged_decode_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["kp"]), jnp.asarray(x["vp"]), jnp.asarray(layer, jnp.int32),
        jnp.asarray(x["table"]), jnp.asarray(lengths, jnp.int32), interpret=True, **kw,
    )
    out = ca.paged_decode_attention(
        t(x["q"]), t(x["kp"]), t(x["vp"]), layer, t(x["table"]), torch.tensor(lengths, dtype=torch.int32),
        *((t(x["kf"]), t(x["vf"])) if fresh else ()),
    )
    assert out.shape == (B, C, Nkv * G, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    if not fresh:
        for b, n in enumerate(lengths):
            if n == 0:
                assert (out[b] == 0).all()


def test_paged_front_doors_match_the_gather_golden(rng):
    """paged_attention and attend_decode_paged (the kernel's plain version on
    the CPU) against the gather-then-attend golden paths, the port's and
    lia_tpu's, over a stacked pool; attend_decode_paged also with ALiBi
    slopes (it raised, naming ROADMAP A3, before their port)."""
    x = _kernel_inputs(rng, 2, 10, 2, 8, 16, 2, 1, 2, 4)
    lengths = np.asarray([13, 30], np.int32)
    q, kp, vp, table = (t(x[n]) for n in ("q", "kp", "vp", "table"))
    kf, vf = t(x["kf"]), t(x["vf"])
    cache = pg.PagedKVCache(kp[1], vp[1])
    out = pg.paged_attention(q, cache, table, t(lengths))
    np.testing.assert_allclose(out.numpy(), pg.paged_attention_gather(q, cache, table, t(lengths)).numpy(),
                               rtol=TOL, atol=TOL)
    out = pg.attend_decode_paged(q, kf, vf, kp, vp, 1, table, t(lengths))
    gold = pg.attend_decode_paged_gather(q, kf, vf, kp, vp, 1, table, t(lengths))
    np.testing.assert_allclose(out.numpy(), gold.numpy(), rtol=TOL, atol=TOL)
    ref = jpg.attend_decode_paged(
        jnp.asarray(x["q"]), jnp.asarray(x["kf"]), jnp.asarray(x["vf"]), jnp.asarray(x["kp"]),
        jnp.asarray(x["vp"]), jnp.asarray(1, jnp.int32), jnp.asarray(x["table"]), jnp.asarray(lengths),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    # ALiBi: a key's logical index in the row, the fresh token at the length
    slopes = att.alibi_slopes(q.shape[2])
    out = pg.attend_decode_paged(q, kf, vf, kp, vp, 1, table, t(lengths), alibi_slopes=slopes)
    gold = pg.attend_decode_paged_gather(q, kf, vf, kp, vp, 1, table, t(lengths), alibi_slopes=slopes)
    np.testing.assert_allclose(out.numpy(), gold.numpy(), rtol=TOL, atol=TOL)
    ref = jpg.attend_decode_paged(
        jnp.asarray(x["q"]), jnp.asarray(x["kf"]), jnp.asarray(x["vf"]), jnp.asarray(x["kp"]),
        jnp.asarray(x["vp"]), jnp.asarray(1, jnp.int32), jnp.asarray(x["table"]), jnp.asarray(lengths),
        alibi_slopes=jatt.alibi_slopes(q.shape[2]),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_reshape_and_cache_vectorized_matches(cfg, rng):
    """The single-index_put reshape_and_cache writes the same slots as a serial
    reference, and as lia_tpu's."""
    B, H, D = 3, cfg.num_kv_heads, cfg.head_dim
    table = np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, 0]], np.int32)
    positions = np.asarray([5, 0, 7], np.int32)
    k_new = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    v_new = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    tc = pg.init_paged_cache(cfg, num_blocks=6, block_size=4, dtype=torch.float32)
    slots = pg.slot_mapping(t(table), t(positions), 4)
    pg.reshape_and_cache(t(k_new), t(v_new), tc, slots)
    ref_k = np.zeros_like(tc.k.numpy())
    for i in range(B):
        blk, off = int(slots[i]) // 4, int(slots[i]) % 4
        ref_k[blk, :, off, :] = k_new[i, :, 0, :]
    np.testing.assert_array_equal(tc.k.numpy(), ref_k)
    jc = jpg.init_paged_cache(j_get_config("opt-tiny"), num_blocks=6, block_size=4, dtype=jnp.float32)
    jc = jpg.reshape_and_cache(jnp.asarray(k_new), jnp.asarray(v_new), jc, jnp.asarray(slots.numpy()))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def test_write_prompt_paged_matches_lia_tpu(cfg, rng):
    H, D, S, length = cfg.num_kv_heads, cfg.head_dim, 12, 9
    k_seq = rng.standard_normal((H, S, D)).astype(np.float32)
    v_seq = rng.standard_normal((H, S, D)).astype(np.float32)
    row = np.asarray([2, 5, 7, 0], np.int32)
    tc = pg.write_prompt_paged(pg.init_paged_cache(cfg, 8, 4, torch.float32), t(k_seq), t(v_seq), t(row), length)
    jc = jpg.write_prompt_paged(jpg.init_paged_cache(j_get_config("opt-tiny"), 8, 4, jnp.float32),
                                jnp.asarray(k_seq), jnp.asarray(v_seq), jnp.asarray(row), length)
    for i in range(length):
        np.testing.assert_array_equal(tc.k.numpy()[row[i // 4], :, i % 4], k_seq[:, i])
    # every page but the null page (its duplicate writes land in either order)
    np.testing.assert_array_equal(tc.k.numpy()[1:], np.asarray(jc.k)[1:])
    np.testing.assert_array_equal(tc.v.numpy()[1:], np.asarray(jc.v)[1:])
    assert (tc.k.numpy()[1] == 0).all()  # positions >= length landed in page 0 only
    ks, vs = pg.gather_sequence(tc, t(row))
    jks, jvs = jpg.gather_sequence(jc, jnp.asarray(row))
    np.testing.assert_array_equal(ks.numpy()[:, :length], np.asarray(jks)[:, :length])
    np.testing.assert_array_equal(vs.numpy()[:, :length], np.asarray(jvs)[:, :length])


def test_seed_prefix_cache_roundtrip_matches_lia_tpu(rng):
    """write_prompt_all_layers then seed_prefix_cache reproduce the prefix KV
    as a contiguous one-row cache (base not block-aligned), as lia_tpu's do."""
    L, nb, H, bs, D = 3, 9, 2, 8, 16
    n, base, bucket = 29, 21, 32
    seg_k = rng.standard_normal((L, H, bucket, D)).astype(np.float32)
    seg_v = rng.standard_normal((L, H, bucket, D)).astype(np.float32)
    row = np.zeros(8, np.int32)
    row[: -(-n // bs)] = [4, 2, 7, 1]
    kp, vp = torch.zeros(L, nb, H, bs, D), torch.zeros(L, nb, H, bs, D)
    out = pg.write_prompt_all_layers(kp, vp, t(seg_k), t(seg_v), t(row), n)
    assert out[0] is kp  # in place
    jk, jv = jpg.write_prompt_all_layers(jnp.zeros((L, nb, H, bs, D)), jnp.zeros((L, nb, H, bs, D)),
                                         jnp.asarray(seg_k), jnp.asarray(seg_v), jnp.asarray(row), n)
    np.testing.assert_array_equal(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(vp.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    seed = pg.seed_prefix_cache(kp, vp, t(row), base, bucket)
    jseed = jpg.seed_prefix_cache(jk, jv, jnp.asarray(row), jnp.asarray(base, jnp.int32), bucket)
    np.testing.assert_array_equal(seed.k.numpy()[:, 0, :, :base], seg_k[:, :, :base])
    np.testing.assert_array_equal(seed.v.numpy()[:, 0, :, :base], seg_v[:, :, :base])
    np.testing.assert_array_equal(seed.k.numpy()[..., :base, :], np.asarray(jseed.k)[..., :base, :])
    assert int(seed.length) == int(jseed.length) == base and seed.k.is_contiguous()
    np.testing.assert_array_equal(seed.mask.numpy(), np.asarray(jseed.mask))


def test_write_prompt_start_skips_shared_pages(rng):
    """start > 0 leaves the pages below the boundary untouched (shared prefix
    pages are never rewritten by a request that reuses them), as in lia_tpu."""
    L, nb, H, bs, D = 2, 7, 2, 8, 16
    n, start = 27, 16
    k0 = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32)
    v0 = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32)
    seg_k = rng.standard_normal((L, H, 32, D)).astype(np.float32)
    seg_v = rng.standard_normal((L, H, 32, D)).astype(np.float32)
    row = np.zeros(8, np.int32)
    row[: -(-n // bs)] = [5, 3, 6, 2]
    kp, vp = t(k0), t(v0)
    pg.write_prompt_all_layers(kp, vp, t(seg_k), t(seg_v), t(row), n, start=start)
    jk, jv = jpg.write_prompt_all_layers(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(seg_k), jnp.asarray(seg_v),
                                         jnp.asarray(row), n, start=jnp.asarray(start, jnp.int32))
    for p in (5, 3):
        np.testing.assert_array_equal(kp.numpy()[:, p], k0[:, p])
        np.testing.assert_array_equal(vp.numpy()[:, p], v0[:, p])
    np.testing.assert_array_equal(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(vp.numpy()[:, 1:], np.asarray(jv)[:, 1:])


def test_write_token_all_layers_matches_lia_tpu(rng):
    """One decode step's K/V of every layer at each row's length; the inactive
    row writes to the null page."""
    L, nb, H, bs, D, B = 2, 9, 2, 4, 16, 3
    k0 = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32)
    ks = rng.standard_normal((L, B, H, 1, D)).astype(np.float32)
    vs = rng.standard_normal((L, B, H, 1, D)).astype(np.float32)
    table = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    lengths = np.asarray([5, 3, 9], np.int32)
    active = np.asarray([True, True, False])
    kp, vp = t(k0), t(k0)
    pg.write_token_all_layers(kp, vp, t(ks), t(vs), t(table), t(lengths), t(active))
    jk, jv = jpg.write_token_all_layers(jnp.asarray(k0), jnp.asarray(k0), jnp.asarray(ks), jnp.asarray(vs),
                                        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(active))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(kp.numpy()[:, 2, :, 1], ks[:, 0, :, 0])  # row 0: page 2, slot 1


def test_decode_step_paged_matches_lia_tpu():
    """Prompts committed to a shuffled pool, then 3 paged decode steps (one row
    inactive in one step): logits ≤ 1e-4 against lia_tpu and the same pool."""
    from functools import partial

    from lia_tpu.ops.fuse import fuse_projections as j_fuse

    from lia_tpu_torch.ops.fuse import fuse_projections

    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_fuse(jcfg, j_init(jcfg, seed=21, scale=0.12))
    tcfg = get_config("opt-tiny").replace(dtype="float32")
    tp = fuse_projections(tcfg, params_from_jax(jp))
    rng = np.random.default_rng(3)
    L, H, D, bs, nb, B = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim, 8, 12, 2
    k0 = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32) * 0.5
    v0 = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32) * 0.5
    table = np.asarray([[7, 2, 9, 0], [4, 11, 1, 0]], np.int32)
    lengths = np.asarray([13, 21], np.int32)
    pos = lengths.copy()
    kp, vp = t(k0), t(v0)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    jstep = jax.jit(partial(jpg.decode_step_paged, jcfg))
    for i, tok in enumerate(rng.integers(2, tcfg.vocab_size, (3, B)).astype(np.int32)):
        active = np.asarray([True, i != 1])
        jl, jk, jv = jstep(jp, jnp.asarray(tok[:, None]), jnp.asarray(pos), jk, jv, jnp.asarray(table),
                           jnp.asarray(lengths), jnp.asarray(active))
        tl, _, _ = pg.decode_step_paged(tcfg, tp, t(tok[:, None]), t(pos), kp, vp, t(table), t(lengths), t(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        lengths, pos = lengths + active, pos + active
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)
