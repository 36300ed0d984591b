"""The port's beam search against the JAX package on the CPU, in fp32.

The grouped-beam kernels' plain versions against lia_tpu's Pallas kernels (in
interpret mode), the beam front door against lia_tpu's concat golden, the
beam cache ops on the same arrays, the beam expansion and the final
selection, then ``generate_beam`` token for token: grouped and expanded,
bf16 and int8 KV, with the logits processors, resident and under the tiered
scheduler, and against Hugging Face's beam search on an in-process OPT.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine import beam as jbeam
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import attention as jatt
from lia_tpu.ops import kv_cache as jkvc
from lia_tpu.ops.pallas_attention import decode_beam_attention as j_beam_kernel
from lia_tpu.ops.pallas_attention import decode_beam_attention_int8 as j_beam_kernel_int8
from lia_tpu.ops.quant import QuantizedKV as JQKV
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine import beam
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops.quant import QuantizedKV, quantize_kv
from lia_tpu_torch.utils.checkpoint import params_from_hf_state_dict, params_from_jax

PROMPTS = [[5, 9, 5, 9, 23, 41], [100, 7, 3]]
PROC = dict(repetition_penalty=1.3, no_repeat_ngram_size=2, min_new_tokens=3, eos_token_id=2)
NEW = 6


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def model():
    """opt-tiny in fp32 (2 layers) with the reference's dummy weights, scale
    raised so the logits are far from flat, as (jax cfg, jax params, port cfg,
    port params)."""
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=11, scale=0.05)
    return jcfg, jp, get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp)


@pytest.fixture(scope="module")
def engines(model):
    """Resident engines of both packages by KV type, made once."""
    jcfg, jp, tcfg, tp = model
    return {kv: (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv))),
                 InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)), device="cpu"))
            for kv in ("none", "int8")}


# ---------------------------------------------------------------------------
# B9 / B10: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _beam_inputs(G, tlen, int8, D=16, L=2, B0=3, nb=2, Nkv=2, S_p=16, T_max=8, plen=12, pstarts=(2, 0, 11)):
    """Seeded numpy inputs of both kernels over layer 1: group prompts from
    ``pstarts`` (the last group holds one token, at plen - 1) and ``tlen`` tail
    slots. Returns (jax args, port args)."""
    rng = np.random.default_rng(G * 10 + tlen + 100 * int8)
    B, N = B0 * nb, Nkv * G
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kf, vf = f(B, 1, N, D), f(B, Nkv, 1, D), f(B, Nkv, 1, D)
    kp, vp, kt, vt = f(L, B0, Nkv, S_p, D), f(L, B0, Nkv, S_p, D), f(L, B, Nkv, T_max, D), f(L, B, Nkv, T_max, D)
    pm = np.zeros((B0, S_p), bool)
    for g, p in enumerate(pstarts):
        pm[g, p:plen] = True
    lens_j = (jnp.asarray(1, jnp.int32), jnp.asarray(pstarts, jnp.int32), jnp.asarray(plen, jnp.int32),
              jnp.asarray(tlen, jnp.int32))
    lens_t = (1, t(pm), torch.tensor(plen, dtype=torch.int32), torch.tensor(tlen, dtype=torch.int32), nb)
    if int8:
        planes = [quantize_kv(t(x)) for x in (kp, vp, kt, vt)]
        jplanes = [x for p in planes for x in (jnp.asarray(p.q.numpy()), jnp.asarray(p.s.numpy()))]
        tplanes = [x for p in planes for x in p]
        return ((jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), *jplanes, *lens_j, nb),
                (t(q), t(kf), t(vf), *tplanes, *lens_t))
    return ((*(jnp.asarray(x) for x in (q, kf, vf, kp, vp, kt, vt)), *lens_j, nb),
            (*(t(x) for x in (q, kf, vf, kp, vp, kt, vt)), *lens_t))


@pytest.mark.parametrize("tlen", [0, 3, 8])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_beam_plain_versions_match_pallas(G, tlen, int8):
    """B9 (2e-5) and B10 (2e-4) plain versions against the Pallas kernels in
    interpret mode, at the reference test's shapes and GQA up to G = 4, tail
    lengths 0, 3 and T_max, and a group whose prompt is one token."""
    jargs, targs = _beam_inputs(G, tlen, int8)
    jk, tk, tol = (j_beam_kernel_int8, ca.decode_beam_attention_int8, 2e-4) if int8 else (
        j_beam_kernel, ca.decode_beam_attention, 2e-5)
    ref = jk(*jargs, block_k=8, interpret=True)
    before = tk.launches
    out = tk(*targs)
    assert tk.launches == before  # a CPU tensor takes the plain version: no launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_beam_kernels_need_nb_to_divide_the_batch():
    _, targs = _beam_inputs(1, 3, False)
    with pytest.raises(ValueError, match="nb"):
        ca.decode_beam_attention(*targs[:-1], 4)
    _, targs = _beam_inputs(1, 3, True)
    with pytest.raises(ValueError, match="nb"):
        ca.decode_beam_attention_int8(*targs[:-1], 4)


# ---------------------------------------------------------------------------
# the beam cache and the front door
# ---------------------------------------------------------------------------


def _prefilled(kv: str, B0=2, L=2, Nkv=2, S=16, D=8, seed=0):
    """A group-level prefill cache of both packages on the same arrays (fp32,
    bf16 or int8 planes), pads at the front of each row."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((L, B0, Nkv, S, D)).astype(np.float32) for _ in range(2))
    mask = np.zeros((B0, S), bool)
    for b, p in enumerate((0, 5)[:B0]):
        mask[b, p:12] = True
    length = 12
    if kv == "int8":
        tk, tv = quantize_kv(t(k)), quantize_kv(t(v))
        jk, jv = (JQKV(jnp.asarray(p.q.numpy()), jnp.asarray(p.s.numpy())) for p in (tk, tv))
    else:
        dt, jdt = (torch.bfloat16, jnp.bfloat16) if kv == "bf16" else (torch.float32, jnp.float32)
        tk, tv, jk, jv = t(k).to(dt), t(v).to(dt), jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    jc = jkvc.KVCache(jk, jv, jnp.asarray(length, jnp.int32), jnp.asarray(mask))
    tc = kvc.KVCache(tk, tv, torch.tensor(length, dtype=torch.int32), t(mask))
    return jc, tc


def _np(x):
    if isinstance(x, (QuantizedKV, JQKV)):
        return [_np(x.q), _np(x.s)]
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(a.dtype) == "bfloat16" else a


def _assert_same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_beam_cache_ops_match_lia_tpu(kv):
    """beam_cache_from_prefill (shapes, tail buckets: 32 slots, 128 over int8),
    beam_commit_token, beam_tail_reorder and beam_reorder give lia_tpu's arrays,
    in place (every buffer keeps its address)."""
    nb, new = 3, 5
    jc, tc = _prefilled(kv)
    jb, tb = jkvc.beam_cache_from_prefill(jc, nb, new), kvc.beam_cache_from_prefill(tc, nb, new)
    assert tb.nb == nb and tb.tail_k.shape == jb.tail_k.shape == (2, 6, 2, 128 if kv == "int8" else 32, 8)
    assert tb.prompt_k is tc.k  # the prefilled slab is the shared prompt, uncopied
    rng = np.random.default_rng(1)
    for step in range(3):
        k, v = (rng.standard_normal((2, 6, 2, 1, 8)).astype(np.float32) for _ in range(2))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        if kv == "int8":
            from lia_tpu.ops.quant import quantize_kv as jq

            jk, jv = jq(jk), jq(jv)
        jb = jkvc.beam_commit_token(jb, jk, jv)
        tb = kvc.beam_commit_token(tb, t(k), t(v))
        src = np.array([2, 0, 0, 4, 5, 3])  # within each group of 3
        jb = jkvc.beam_tail_reorder(jb, jnp.asarray(src))
        ptrs = [p.data_ptr() for p in _parts(tb.tail_k)]
        tb = kvc.beam_tail_reorder(tb, t(src))
        assert [p.data_ptr() for p in _parts(tb.tail_k)] == ptrs
    assert int(tb.tail_len) == int(jb.tail_len) == 3
    _assert_same(tb.tail_k, jb.tail_k)
    _assert_same(tb.tail_v, jb.tail_v)
    # the expanded path's whole-cache gather, mask included
    jc, tc = _prefilled(kv)
    idx = np.array([1, 1])
    _assert_same(kvc.beam_reorder(tc, t(idx)).k, jkvc.beam_reorder(jc, jnp.asarray(idx)).k)
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jkvc.beam_reorder(jc, jnp.asarray(idx)).mask))


def _parts(plane):
    return list(plane) if isinstance(plane, QuantizedKV) else [plane]


def test_write_token_matches_lia_tpu():
    """One layer's fresh K/V at a tail offset, bf16 and int8 planes."""
    for kv in ("bf16", "int8"):
        jc, tc = _prefilled(kv)
        new = np.random.default_rng(2).standard_normal((2, 2, 1, 8)).astype(np.float32)
        jn = jnp.asarray(new, jnp.float32)
        out_t = kvc.write_token(tc.k, t(new), 1, torch.tensor(12, dtype=torch.int32))
        out_j = jkvc.write_token(jc.k, jn, jnp.asarray(1, jnp.int32), jnp.asarray(12, jnp.int32))
        _assert_same(out_t, out_j)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("tail", [0, 2])
def test_attend_decode_beam_matches_lia_tpu_golden(kv, tail):
    """The front door (the plain version on the CPU) against lia_tpu's
    attend_decode_beam (its concat golden on the CPU) and the port's own copy
    of that golden; over an int8 cache the fresh K/V arrive dequantized."""
    jc, tc = _prefilled(kv)
    nb = 2
    jb, tb = jkvc.beam_cache_from_prefill(jc, nb, 4), kvc.beam_cache_from_prefill(tc, nb, 4)
    rng = np.random.default_rng(3)
    for _ in range(tail):
        k, v = (rng.standard_normal((2, 4, 2, 1, 8)).astype(np.float32) for _ in range(2))
        jb = jkvc.beam_commit_token(jb, jnp.asarray(k), jnp.asarray(v))
        tb = kvc.beam_commit_token(tb, t(k), t(v))
    q = rng.standard_normal((4, 1, 4, 8)).astype(np.float32)  # G = 2
    kf, vf = (rng.standard_normal((4, 2, 1, 8)).astype(np.float32) for _ in range(2))
    ref = jatt.attend_decode_beam(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jb, jnp.asarray(1, jnp.int32))
    out = att.attend_decode_beam(t(q), t(kf), t(vf), tb, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    golden = att.attend_decode_beam_golden(t(q), t(kf), t(vf), tb, 1)
    np.testing.assert_allclose(out.numpy(), golden.numpy(), rtol=2e-5, atol=2e-5)


def test_alibi_bias_raises_naming_a3():
    """ALiBi is ported (it raised, naming ROADMAP A3, before): the beam front
    door with slopes gives lia_tpu's attend_decode_beam under its
    _alibi_beam_bias (prompt ranks, real_len + t on the tail, the fresh token
    at real_len + tail_len)."""
    jc, tc = _prefilled("fp32")
    jb, tb = jkvc.beam_cache_from_prefill(jc, 2, 4), kvc.beam_cache_from_prefill(tc, 2, 4)
    rng = np.random.default_rng(6)
    k, v = (rng.standard_normal((2, 4, 2, 1, 8)).astype(np.float32) for _ in range(2))
    jb, tb = jkvc.beam_commit_token(jb, jnp.asarray(k), jnp.asarray(v)), kvc.beam_commit_token(tb, t(k), t(v))
    q = rng.standard_normal((4, 1, 4, 8)).astype(np.float32)
    kf, vf = (rng.standard_normal((4, 2, 1, 8)).astype(np.float32) for _ in range(2))
    positions = np.repeat(np.asarray(jc.mask).sum(1), 2)[:, None].astype(np.int32) + 1
    jcfg = j_get_config("opt-tiny").replace(num_heads=4, alibi=True)
    from lia_tpu.models import transformer as JT

    ref = jatt.attend_decode_beam(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jb, jnp.asarray(0, jnp.int32),
                                  bias=JT._alibi_beam_bias(jcfg, jb, jnp.asarray(positions)))
    out = att.attend_decode_beam(t(q), t(kf), t(vf), tb, 0, att.alibi_slopes(4))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# beam expansion and final selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proc", [False, True])
def test_beam_select_matches_lia_tpu(proc):
    """Deterministic expansion with frozen (EOS-finished) beams and, with
    ``proc``, the post-log-softmax processors: tokens, scores, finished flags
    and source rows equal lia_tpu's; then reorder_proc's state."""
    B, nb, V, S = 2, 3, 64, 5
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((B * nb, V)) * 3).astype(np.float32)
    scores = np.array([[-1.0, -2.5, -3.0], [-0.5, -0.7, -9.0]], np.float32)
    finished = np.array([[False, True, False], [False, False, True]])
    kw = dict(eos_token_id=3, pad_token_id=1, **({} if not proc else dict(repetition_penalty=1.4,
                                                                         no_repeat_ngram_size=2, min_new_tokens=4)))
    jgen, tgen = JGen(num_beams=nb, **kw), GenerationConfig(num_beams=nb, **kw)
    jproc = tproc = None
    if proc:
        hist = rng.integers(0, V, (B * nb, S + 4)).astype(np.int32)
        seen = rng.random((B * nb, V)) < 0.2
        jproc = (jnp.asarray(seen), jnp.asarray(hist), jnp.asarray(S, jnp.int32), 2)
        tproc = (t(seen), t(hist), S, 2)
    ref = jbeam.beam_select(jgen, V, jnp.asarray(logits), jnp.asarray(scores), jnp.asarray(finished), proc=jproc)
    out = beam.beam_select(tgen, V, t(logits), t(scores), t(finished), proc=tproc)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    if proc:
        jr = jbeam.reorder_proc(jproc, ref[3], ref[0])
        tr = beam.reorder_proc(tproc, out[3], out[0])
        for a, b in zip(tr[:2], jr[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tr[2:] == (int(jr[2]), jr[3])


def test_top_k_takes_the_lower_index_first_among_ties():
    """jax.lax.top_k's tie order, which a stable descending sort keeps."""
    x = np.array([[0.0, 2.0, 2.0, 1.0, 2.0, -1.0], [5.0, 5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(beam.top_k(t(x), 4).numpy(), np.asarray(ref))


def test_select_best_matches_lia_tpu():
    """With and without length_penalty, EOS-shortened beams included."""
    rng = np.random.default_rng(5)
    history = rng.integers(0, 9, (3, 4, 7)).astype(np.int32)
    scores = rng.standard_normal((3, 4)).astype(np.float32) * 4
    for kw in (dict(), dict(eos_token_id=2, length_penalty=1.0), dict(length_penalty=0.7),
               dict(eos_token_id=2, length_penalty=-0.5)):
        np.testing.assert_array_equal(beam.select_best(history, scores, GenerationConfig(**kw)),
                                      jbeam.select_best(history, scores, JGen(**kw)))


# ---------------------------------------------------------------------------
# generate_beam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(num_beams=4, eos_token_id=2), dict(num_beams=3, **PROC), dict(num_beams=1)],
                         ids=["nb4-eos", "nb3-processors", "nb1"])
@pytest.mark.parametrize("kv", ["none", "int8"])
def test_generate_beam_matches_lia_tpu(engines, kv, kw):
    """Token-exact against lia_tpu, grouped and expanded, and the two layouts
    equal inside the port."""
    jeng, teng = engines[kv]
    jgen, tgen = JGen(max_new_tokens=NEW, **kw), GenerationConfig(max_new_tokens=NEW, **kw)
    ref = jeng.generate_beam(PROMPTS, jgen, grouped=True).sequences
    grouped = teng.generate_beam(PROMPTS, tgen).sequences
    expanded = teng.generate_beam(PROMPTS, tgen, grouped=False).sequences
    np.testing.assert_array_equal(grouped, ref)
    np.testing.assert_array_equal(expanded, grouped)
    assert grouped.shape == (len(PROMPTS), NEW) and grouped.dtype == np.int32


def test_beam1_equals_greedy(engines):
    _, teng = engines["none"]
    for kw in (dict(), dict(no_repeat_ngram_size=2, min_new_tokens=4, eos_token_id=2)):
        gen = GenerationConfig(max_new_tokens=NEW, **kw)
        np.testing.assert_array_equal(teng.generate_beam(PROMPTS, gen.replace(num_beams=1)).sequences,
                                      teng.generate(PROMPTS, gen).sequences)


def test_stochastic_beams(engines):
    """Gumbel-top-k beams draw from a torch.Generator (other draws than JAX's),
    so they are checked on structure: ids in the vocabulary, one sequence per
    seed, both layouts alike, and unlike deterministic beams."""
    _, teng = engines["none"]
    V = teng.cfg.vocab_size
    gen = GenerationConfig(max_new_tokens=NEW, num_beams=3, do_sample=True, temperature=2.0)
    a = teng.generate_beam(PROMPTS, gen, seed=7).sequences
    assert ((a >= 0) & (a < V)).all() and a.shape == (len(PROMPTS), NEW)
    np.testing.assert_array_equal(a, teng.generate_beam(PROMPTS, gen, seed=7).sequences)
    np.testing.assert_array_equal(a, teng.generate_beam(PROMPTS, gen, seed=7, grouped=False).sequences)
    det = teng.generate_beam(PROMPTS, gen.replace(do_sample=False)).sequences
    others = [teng.generate_beam(PROMPTS, gen, seed=s).sequences for s in (8, 9)]
    assert any(not np.array_equal(x, det) for x in [a, *others])


def test_resident_beam_runs_the_beam_kernel_front_door(engines, monkeypatch):
    """The grouped decode reaches the beam kernel's wrapper every layer and
    step and never the fresh-merge decode wrappers; the expanded one the
    reverse."""
    _, teng = engines["none"]
    calls = {"beam": 0, "fresh": 0}
    real_beam, real_fresh = ca.decode_beam_attention, ca.decode_attention_fresh

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ca, "decode_beam_attention", count("beam", real_beam))
    monkeypatch.setattr(ca, "decode_attention_fresh", count("fresh", real_fresh))
    gen = GenerationConfig(max_new_tokens=NEW, num_beams=2)
    teng.generate_beam(PROMPTS, gen)
    assert calls == {"beam": teng.cfg.num_layers * (NEW - 1), "fresh": 0}
    teng.generate_beam(PROMPTS, gen, grouped=False)
    assert calls == {"beam": teng.cfg.num_layers * (NEW - 1), "fresh": teng.cfg.num_layers * (NEW - 1)}


# -- under the tiered scheduler ----------------------------------------------


@pytest.fixture(scope="module")
def model4():
    jcfg = j_get_config("opt-tiny").replace(num_layers=4, dtype="float32")
    jp = j_init(jcfg, seed=13, scale=0.05)
    return jcfg, jp, get_config("opt-tiny").replace(num_layers=4, dtype="float32"), params_from_jax(jp)


@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("hbm", [50, 0])
def test_scheduler_grouped_beam_matches_resident(model4, hbm, kv):
    """Policy 3 with half the layers (or none) resident takes the grouped path:
    the resident engine's tokens, with and without processors, and the
    expanded scheduled path's."""
    _, _, tcfg, tp = model4
    q = QuantConfig(kv_cache_dtype=kv)
    res = InferenceEngine(tcfg, tp, RuntimeConfig(quant=q), device="cpu")
    sch = InferenceEngine(tcfg, tp, RuntimeConfig(hbm_percentage=hbm, stream_weights=True, quant=q), device="cpu")
    assert sch.scheduler.grouped_beam_ok
    for kw in (dict(num_beams=4, eos_token_id=2), dict(num_beams=3, **PROC)):
        gen = GenerationConfig(max_new_tokens=NEW, **kw)
        ref = res.generate_beam(PROMPTS, gen).sequences
        np.testing.assert_array_equal(sch.generate_beam(PROMPTS, gen).sequences, ref)
        np.testing.assert_array_equal(sch.generate_beam(PROMPTS, gen, grouped=False).sequences, ref)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_scheduler_host_kv_beam_matches_lia_tpu(model4, kv):
    """Policy 0 keeps the streamed KV on the host: the expanded path (the
    reorder gathers the host cache too), lia_tpu's tokens with processors."""
    jcfg, jp, tcfg, tp = model4
    kw = dict(hbm_percentage=50, prefill_policy=0, decode_policy=0)
    jeng = JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv), **kw))
    teng = InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **kw), device="cpu")
    assert not teng.scheduler.grouped_beam_ok and teng.scheduler.kv_host
    gen = dict(max_new_tokens=NEW, num_beams=3, **PROC)
    np.testing.assert_array_equal(teng.generate_beam(PROMPTS, GenerationConfig(**gen)).sequences,
                                  jeng.generate_beam(PROMPTS, JGen(**gen)).sequences)
    with pytest.raises(NotImplementedError):
        teng.scheduler.beam_state_from_prefill({}, 2, 4)


def test_scheduler_beam_passes_match_lia_tpu(model4):
    """The scheduler's grouped passes step by step (h50, policy 3): logits of
    the prompt and of 3 beam steps within 1e-4 of lia_tpu's, each step's tail
    shuffle forced to the same source rows."""
    jcfg, jp, tcfg, tp = model4
    kw = dict(hbm_percentage=50, stream_weights=True)
    js, ts = JEngine(jcfg, jp, JRuntime(**kw)).scheduler, InferenceEngine(tcfg, tp, RuntimeConfig(**kw),
                                                                          device="cpu").scheduler
    from lia_tpu_torch.engine.engine import pack_prompts

    tokens, mask = pack_prompts(PROMPTS, 1)
    nb = 2
    jl, jst = js.prefill_pass(tokens, mask, 128)
    tl, tst = ts.prefill_pass(tokens, mask, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jst, tst = js.beam_state_from_prefill(jst, nb, 4), ts.beam_state_from_prefill(tst, nb, 4)
    pos = np.repeat(mask.sum(1), nb).astype(np.int32)
    src = np.array([1, 1, 2, 3], np.int32)
    for i, tok in enumerate(np.random.default_rng(6).integers(2, 500, (3, 4)).astype(np.int32)):
        jl, jst = js.decode_pass_beam(jnp.asarray(tok), jnp.asarray(pos + i), jst)
        tl, tst = ts.decode_pass_beam(t(tok), t(pos + i), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        jst, tst = js.reorder_state_beam(jst, jnp.asarray(src)), ts.reorder_state_beam(tst, t(src).long())
    assert int(tst["str"].tail_len) == int(tst["res"].tail_len) == 3


# -- against Hugging Face ------------------------------------------------------


def test_beam_processors_match_hf():
    """Beam search with repetition penalty and no-repeat-ngram gives HF
    transformers' beam_search tokens on the same in-process OPT (no EOS, fixed
    length), through the port's params_from_hf_state_dict."""
    transformers = pytest.importorskip("transformers")
    cfg = get_config("opt-tiny").replace(dtype="float32")
    hf_cfg = transformers.OPTConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, ffn_dim=cfg.ffn_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        max_position_embeddings=cfg.max_position_embeddings, do_layer_norm_before=True,
        word_embed_proj_dim=cfg.hidden_size, activation_function="relu",
    )
    torch.manual_seed(0)
    hf = transformers.OPTForCausalLM(hf_cfg).eval()
    eng = InferenceEngine(cfg, params_from_hf_state_dict(cfg, hf.state_dict()), device="cpu")
    prompts, n_new = [[5, 9, 5, 9, 23, 41], [100, 7, 3, 100, 7]], 6
    gen = GenerationConfig(max_new_tokens=n_new, num_beams=3, repetition_penalty=1.5, no_repeat_ngram_size=2,
                           eos_token_id=None, pad_token_id=1)
    for p in prompts:  # one prompt at a time: no padding skew in HF's beam scores
        with torch.no_grad():
            want = hf.generate(torch.tensor([p]), max_new_tokens=n_new, min_new_tokens=n_new, num_beams=3,
                               do_sample=False, repetition_penalty=1.5, no_repeat_ngram_size=2, eos_token_id=None,
                               pad_token_id=1, early_stopping=False, length_penalty=1.0)[0, len(p):].numpy()
        np.testing.assert_array_equal(eng.generate_beam([p], gen).sequences[0], want)
