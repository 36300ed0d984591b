"""The port's public fused-op API (``lia_tpu_torch.modules``) against
``lia_tpu.modules`` and eager compositions on the CPU, in fp32, as
``tests/test_modules.py`` holds lia_tpu's: varlen attention per sequence
(and with GQA), the indirect-access decode attention against full causal
attention and against lia_tpu's over bf16 and int8 caches (the cache it
writes too), the rotary embedding, the linear fusions (raw and quantized
weights) and paged attention. Tolerances 2e-5 (1e-5 for the fusions) as
lia_tpu's own; int8 caches 1e-4.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from lia_tpu import modules as JM
from lia_tpu.config import ModelConfig as JModelConfig
from lia_tpu.ops import kv_cache as jkvc

from lia_tpu_torch import modules as M
from lia_tpu_torch.config import ModelConfig, QuantConfig
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.quant import quantize_weight


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the many small CPU ops here run faster without a
    pool contending with XLA's threads in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_causal(q, k, v):
    """Eager per-sequence causal attention. q/k/v: [S, N, D]."""
    S, N, D = q.shape
    logits = np.einsum("snd,tnd->nst", q, k) / np.sqrt(D)
    logits = np.where(np.tril(np.ones((S, S), bool))[None], logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("nst,tnd->snd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("n_kv,lens,T", [(4, [5, 3, 7], 24), (2, [4, 4], 8)])
def test_varlen_attention_matches_per_sequence_and_lia_tpu(rng, n_kv, lens, T):
    N, D = 4, 16
    q = rng.standard_normal((T, N, D), dtype=np.float32) * 0.3
    k = rng.standard_normal((T, n_kv, D), dtype=np.float32) * 0.3
    v = rng.standard_normal((T, n_kv, D), dtype=np.float32) * 0.3
    out = M.varlen_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.tensor(lens, dtype=torch.int32)).numpy()
    ref = np.asarray(JM.varlen_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens, jnp.int32)))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    kx, vx = np.repeat(k, N // n_kv, axis=1), np.repeat(v, N // n_kv, axis=1)
    off = 0
    for L in lens:
        np.testing.assert_allclose(out[off:off + L], _dense_causal(q[off:off + L], kx[off:off + L], vx[off:off + L]),
                                   rtol=2e-5, atol=2e-5)
        off += L
    assert np.all(out[off:] == 0)  # padding rows zeroed


def _cfgs(n_kv=4):
    kw = dict(name="m", vocab_size=32, hidden_size=64, ffn_size=8, num_layers=2, num_heads=4, num_kv_heads=n_kv,
              head_dim=16, max_position_embeddings=32, dtype="float32")
    return JModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("int8,n_kv", [(False, 4), (False, 2), (True, 4)])
def test_indirect_access_kv_cache_attention_matches_full_and_lia_tpu(rng, int8, n_kv):
    """Prefill S tokens into every layer, decode one more at layer 1: row S
    of full causal attention over S + 1 tokens, lia_tpu's output and cache."""
    B, S, N, D = 2, 6, 4, 16
    jcfg, cfg = _cfgs(n_kv)
    seq = rng.standard_normal((B, S + 1, N, D), dtype=np.float32) * 0.3
    kseq = rng.standard_normal((B, S + 1, n_kv, D), dtype=np.float32) * 0.3
    vseq = rng.standard_normal((B, S + 1, n_kv, D), dtype=np.float32) * 0.3
    jcache = jkvc.init_cache(jcfg, B, 16, jnp.float32, quantized=int8)
    cache = kvc.init_cache(cfg, B, 16, torch.float32, quantized=int8)
    for li in range(cfg.num_layers):
        kl, vl = jkvc.update_layer(jkvc.index_layer_kv(jcache.k, li), jkvc.index_layer_kv(jcache.v, li),
                                   jnp.swapaxes(jnp.asarray(kseq[:, :S]), 1, 2),
                                   jnp.swapaxes(jnp.asarray(vseq[:, :S]), 1, 2), jnp.int32(0))
        jcache = jcache._replace(k=jkvc.set_layer_kv(jcache.k, kl, li), v=jkvc.set_layer_kv(jcache.v, vl, li))
        kvc.update_layer(kvc.index_layer_kv(cache.k, li), kvc.index_layer_kv(cache.v, li),
                         torch.from_numpy(kseq[:, :S]).transpose(1, 2), torch.from_numpy(vseq[:, :S]).transpose(1, 2), 0)
    jcache = jkvc.advance(jcache, jnp.ones((B, S), bool), S)
    cache = kvc.advance(cache, torch.ones((B, S), dtype=torch.bool), S)
    ref, jcache = JM.indirect_access_kv_cache_attention(
        jnp.asarray(seq[:, S:]), jnp.asarray(kseq[:, S:]), jnp.asarray(vseq[:, S:]), jcache, layer_idx=1)
    out, cache = M.indirect_access_kv_cache_attention(
        torch.from_numpy(seq[:, S:]), torch.from_numpy(kseq[:, S:]), torch.from_numpy(vseq[:, S:]), cache, layer_idx=1)
    tol = 1e-4 if int8 else 2e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
    planes = [(cache.k, jcache.k), (cache.v, jcache.v)]
    for got, want in planes:
        for g, w in ((got.q, want.q), (got.s, want.s)) if int8 else ((got, want),):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    if not int8:
        rep = N // n_kv
        for b in range(B):
            full = _dense_causal(seq[b], np.repeat(kseq[b], rep, 1), np.repeat(vseq[b], rep, 1))[S]
            np.testing.assert_allclose(out[b, 0].numpy(), full, rtol=2e-4, atol=2e-4)


def test_indirect_access_beam_reorder_equals_lia_tpu(rng):
    B, S, N, D = 3, 4, 4, 16
    jcfg, cfg = _cfgs()
    k = rng.standard_normal((2, B, N, 16, D), dtype=np.float32)
    v = rng.standard_normal((2, B, N, 16, D), dtype=np.float32)
    mask = np.zeros((B, 16), bool)
    mask[:, :S] = True
    jcache = jkvc.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(S), jnp.asarray(mask))
    cache = kvc.KVCache(torch.tensor(k), torch.tensor(v), torch.tensor(S, dtype=torch.int32), torch.tensor(mask))
    q = rng.standard_normal((B, 1, N, D), dtype=np.float32)
    kn = rng.standard_normal((B, 1, N, D), dtype=np.float32)
    beam = np.array([2, 0, 0], np.int32)
    ref, _ = JM.indirect_access_kv_cache_attention(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(kn), jcache, 0,
                                                   beam_idx=jnp.asarray(beam))
    out, cache = M.indirect_access_kv_cache_attention(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(kn),
                                                      cache, 0, beam_idx=torch.from_numpy(beam))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(cache.k[1, :, :, :S].numpy(), k[1][beam][:, :, :S])


def test_rotary_embedding_equals_lia_tpu(rng):
    B, S, N, D = 2, 5, 4, 16
    q = rng.standard_normal((B, S, N, D), dtype=np.float32)
    k = rng.standard_normal((B, S, 2, D), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for kw in (dict(), dict(rotary_dim=8, interleaved=True, theta=500.0)):
        jq, jk = JM.rotary_embedding(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), **kw)
        tq, tk = M.rotary_embedding(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), **kw)
        assert tq.shape == q.shape and tk.shape == k.shape
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tq[:, 0].numpy(), q[:, 0], atol=1e-6)  # position 0 does not rotate


def test_norms_equal_lia_tpu(rng):
    x = rng.standard_normal((3, 5, 32), dtype=np.float32)
    g, b = rng.standard_normal(32, dtype=np.float32), rng.standard_normal(32, dtype=np.float32)
    np.testing.assert_allclose(M.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                               np.asarray(JM.rms_norm(jnp.asarray(x), jnp.asarray(g))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(M.fast_layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy(),
                               np.asarray(JM.fast_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)


def test_linear_fusions_match_compositions_and_lia_tpu(rng):
    x = rng.standard_normal((3, 32), dtype=np.float32) * 0.3
    w = rng.standard_normal((32, 16), dtype=np.float32) * 0.1
    wu = rng.standard_normal((32, 16), dtype=np.float32) * 0.1
    b = rng.standard_normal(16, dtype=np.float32) * 0.1
    o = rng.standard_normal((3, 16), dtype=np.float32)
    tx, tw, twu, tb, to = (torch.from_numpy(a) for a in (x, w, wu, b, o))
    jx, jw, jwu, jb, jo = (jnp.asarray(a) for a in (x, w, wu, b, o))
    y = tx @ tw + tb
    cases = [
        ("linear_silu", (tb,), (jb,), F.silu(y)),
        ("linear_relu", (tb,), (jb,), F.relu(y)),
        ("linear_gelu", (tb,), (jb,), F.gelu(y)),
        ("linear_new_gelu", (tb,), (jb,), F.gelu(y, approximate="tanh")),
        ("linear_add", (to, tb), (jo, jb), y + to),
        ("linear_add_add", (to, to, tb), (jo, jo, jb), y + 2 * to),
        ("linear_mul", (to, tb), (jo, jb), y * to),
    ]
    for name, targs, jargs, want in cases:
        got = getattr(M, name)(tx, tw, *targs)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(JM, name)(jx, jw, *jargs)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    got = M.linear2_silu_mul(tx, tw, twu)
    np.testing.assert_allclose(got.numpy(), (F.silu(tx @ tw) * (tx @ twu)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(JM.linear2_silu_mul(jx, jw, jwu)), rtol=1e-5, atol=1e-6)


def test_linear_fusion_quantized(rng):
    """A QuantizedWeight goes through the same entry point (the
    quantized-matmul kernels' plain versions here)."""
    x = torch.from_numpy(rng.standard_normal((3, 64), dtype=np.float32) * 0.3)
    w = rng.standard_normal((64, 16), dtype=np.float32) * 0.1
    got = M.linear_silu(x, quantize_weight(torch.from_numpy(w), QuantConfig(weight_dtype="int8"))).numpy()
    ref = F.silu(x @ torch.from_numpy(w)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.03


def test_paged_attention_equals_lia_tpu(rng):
    """Decode attention over a shuffled page pool through a block table."""
    jcfg, cfg = _cfgs(n_kv=2)
    nb, bs, B, D = 9, 4, 2, 16
    jpool = JM.init_paged_cache(jcfg, nb, bs, jnp.float32)
    pool = M.init_paged_cache(cfg, nb, bs, torch.float32)
    assert tuple(pool.k.shape) == tuple(jpool.k.shape)
    k = rng.standard_normal((nb, 2, bs, D), dtype=np.float32)
    v = rng.standard_normal((nb, 2, bs, D), dtype=np.float32)
    table = np.array([[3, 7, 1, 0], [5, 2, 8, 6]], np.int32)
    lengths = np.array([10, 16], np.int32)
    q = rng.standard_normal((B, 1, 4, D), dtype=np.float32)
    # one token more through reshape_and_cache at each row's next slot
    kn, vn = (rng.standard_normal((B, 2, 1, D), dtype=np.float32) for _ in range(2))
    slots = np.array([table[0, 10 // bs] * bs + 10 % bs, table[1, 3] * bs + 3], np.int32)
    jpool = JM.reshape_and_cache(jnp.asarray(kn), jnp.asarray(vn), JM.PagedKVCache(jnp.asarray(k), jnp.asarray(v)),
                                 jnp.asarray(slots))
    pool = M.reshape_and_cache(torch.from_numpy(kn), torch.from_numpy(vn),
                               M.PagedKVCache(torch.tensor(k), torch.tensor(v)), torch.from_numpy(slots))
    np.testing.assert_array_equal(pool.k.numpy(), np.asarray(jpool.k))
    ref = JM.paged_attention(jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(lengths + 1))
    out = M.paged_attention(torch.from_numpy(q), pool, torch.from_numpy(table), torch.from_numpy(lengths + 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_public_names_match_lia_tpu():
    assert M.__all__ == JM.__all__
    assert all(callable(getattr(M, n)) for n in M.__all__)
