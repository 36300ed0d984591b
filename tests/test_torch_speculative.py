"""The port's speculative decoding (lia_tpu_torch.engine.lookahead, the
scheduler's verify pass, the paged verify and speculative serving) against
lia_tpu on the CPU, in fp32.

Both packages run on the same numpy parameters (params_from_jax) and prompts:
prompt lookup and greedy draft speculation give lia_tpu's sequences and verify
step counts exactly, and the port's own greedy generate; the tiered verify
gives the resident engine's tokens; the paged verify writes lia_tpu's pools
bit for bit; speculative serving gives plain serving's tokens request by
request. The two packages draw random numbers differently, so sampled
acceptance is held to lia_tpu's with lia_tpu's uniforms handed in, to greedy
at top_k=1, and to the Leviathan law by a seeded chi-square test.
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
from lia_tpu.engine import lookahead as jla
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import paged as jpg
from lia_tpu.ops.quant import quantize_params as j_quantize
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine import lookahead as la
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops import paged as pg
from lia_tpu_torch.utils.checkpoint import params_from_jax

# repetitive prompts, so that prompt lookup lands proposals (as tests/test_lookahead.py)
PROMPTS = [[5, 9, 23, 41, 5, 9, 23, 41, 5, 9], [100, 7, 3], [7, 7, 8, 7, 7, 8, 7, 7, 8], [50, 60, 7, 9, 50, 60]]
NEW = 12
K = 3


def _model(name: str, seed: int):
    jcfg = j_get_config(name).replace(dtype="float32")
    jp = j_init(jcfg, seed=seed, scale=0.12)  # decisive greedy margins
    return jcfg, jp, get_config(name).replace(dtype="float32"), params_from_jax(jp)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the many small CPU ops here run faster without a
    pool contending with XLA's threads in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def opt():
    return _model("opt-tiny", 21)


@pytest.fixture(scope="module")
def llama():
    return _model("llama-tiny", 21)  # GQA, G = 2


@pytest.fixture(scope="module")
def models(opt, llama):
    return {"opt": opt, "llama": llama}


@pytest.fixture(scope="module")
def drafts():
    """Draft models: each target's config with other weights."""
    return {"opt": _model("opt-tiny", 77), "llama": _model("llama-tiny", 77)}


_ENGINES = {}


def _engines(model, kv="none", **kw):
    """(lia_tpu engine, port engine) over the model's parameters, made once
    per configuration: lia_tpu's engine keeps its compiled functions."""
    key = (id(model), kv, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jcfg, jp, tcfg, tp = model
        _ENGINES[key] = (JEngine(jcfg, jp, JRuntime(quant=JQuant(kv_cache_dtype=kv), **kw)),
                         InferenceEngine(tcfg, tp, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **kw),
                                         device="cpu"))
    return _ENGINES[key]


# -- prompt lookup -------------------------------------------------------------


def test_propose_ngram_matches_lia_tpu():
    """Seeded histories over a small alphabet (matches at every n-gram
    length), no match, a history shorter than the n-gram, pad-fill past the
    history's end."""
    rng = np.random.default_rng(3)
    cases = [([5, 6, 7], 2, 2), ([9, 8, 9], 3, 1), ([4], 3, 2), ([], 3, 2), ([1, 2, 3, 1, 2], 2, 4),
             ([1, 2, 3, 4, 1, 2, 3], 3, 3)]
    cases += [(rng.integers(0, 4, int(rng.integers(1, 30))).tolist(), int(rng.integers(1, 5)),
               int(rng.integers(1, 6))) for _ in range(200)]
    for h, n, k in cases:
        assert la.propose_ngram(h, n, k, 0) == jla.propose_ngram(h, n, k, 0), (h, n, k)
    assert la.propose_ngram([1, 2, 3, 1, 2], 2, 4, 0) == [3, 1, 2, 0]  # pad-filled


@pytest.mark.parametrize("name,kv", [("opt", "none"), ("opt", "int8"), ("llama", "none"), ("llama", "int8")])
def test_prompt_lookup_matches_lia_tpu(models, name, kv):
    """(sequences, verify steps) equal lia_tpu's generate_speculative, over a
    bf16 or int8 slab, and the sequences equal the port's greedy generate."""
    jeng, teng = _engines(models[name], kv)
    gen, jgen = GenerationConfig(max_new_tokens=NEW), JGen(max_new_tokens=NEW)
    seqs, steps = teng.generate_speculative(PROMPTS, gen, ngram=3, k=K)
    jseqs, jsteps = jeng.generate_speculative(PROMPTS, jgen, ngram=3, k=K)
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    assert steps == jsteps and steps < NEW
    np.testing.assert_array_equal(seqs, teng.generate(PROMPTS, gen).sequences)


def test_prompt_lookup_int8_weights(opt):
    """An int8-weight target: the same sequences and steps as lia_tpu's."""
    jcfg, jp, tcfg, _ = opt
    jq = j_quantize(jcfg, jp, JQuant(weight_dtype="int8", group_size=-1))
    jeng = JEngine(jcfg, jq, JRuntime(quant=JQuant(weight_dtype="int8")))
    teng = InferenceEngine(tcfg, params_from_jax(jq), RuntimeConfig(quant=QuantConfig(weight_dtype="int8")),
                           device="cpu")
    seqs, steps = teng.generate_speculative(PROMPTS, GenerationConfig(max_new_tokens=8))
    jseqs, jsteps = jeng.generate_speculative(PROMPTS, JGen(max_new_tokens=8))
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    assert steps == jsteps
    np.testing.assert_array_equal(seqs, teng.generate(PROMPTS, GenerationConfig(max_new_tokens=8)).sequences)


@pytest.mark.parametrize("mode", ["lookup", "draft"])
def test_eos_mid_chunk(opt, mode):
    """An EOS the model emits mid-sequence: the speculative output stops at it
    (pad-filled), as greedy generate's, and equals lia_tpu's."""
    jeng, teng = _engines(opt)
    free = teng.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences
    eos = int(free[0, 5])
    gen = GenerationConfig(max_new_tokens=NEW, eos_token_id=eos, pad_token_id=1)
    jgen = JGen(max_new_tokens=NEW, eos_token_id=eos, pad_token_id=1)
    if mode == "lookup":
        seqs, steps = teng.generate_speculative(PROMPTS, gen, k=K)
        jseqs, jsteps = jeng.generate_speculative(PROMPTS, jgen, k=K)
    else:
        seqs, steps = teng.generate_speculative_draft(teng, PROMPTS, gen, k=K)
        jseqs, jsteps = jeng.generate_speculative_draft(jeng, PROMPTS, jgen, k=K)
    ref = teng.generate(PROMPTS, gen).sequences
    np.testing.assert_array_equal(seqs[:, : ref.shape[1]], ref)
    assert (seqs[:, ref.shape[1]:] == 1).all()
    assert (seqs[0] == 1).any()  # row 0 stopped inside the budget
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    assert steps == jsteps


# -- draft speculation ---------------------------------------------------------


@pytest.mark.parametrize("name,kv", [("opt", "none"), ("opt", "int8"), ("llama", "none")])
def test_draft_matches_lia_tpu(models, drafts, name, kv):
    """A draft of the same config and other weights (over a bf16 or int8
    cache: B2 or B3 in its loop): sequences and steps equal lia_tpu's, the
    sequences equal greedy generate's; budgets cut chunks (NEW % (K+1) != 0)."""
    jeng, teng = _engines(models[name])
    jdraft, tdraft = _engines(drafts[name], kv)
    new = 10
    seqs, steps = teng.generate_speculative_draft(tdraft, PROMPTS, GenerationConfig(max_new_tokens=new), k=K)
    jseqs, jsteps = jeng.generate_speculative_draft(jdraft, PROMPTS, JGen(max_new_tokens=new), k=K)
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    assert steps == jsteps
    np.testing.assert_array_equal(seqs, teng.generate(PROMPTS, GenerationConfig(max_new_tokens=new)).sequences)


def test_perfect_draft_accepts_every_proposal(opt):
    """Draft == target: every verify accepts all k proposals and the bonus,
    so the steps are ceil(new / (k + 1))."""
    _, teng = _engines(opt)
    gen = GenerationConfig(max_new_tokens=NEW)
    seqs, steps = teng.generate_speculative_draft(teng, PROMPTS, gen, k=K)
    np.testing.assert_array_equal(seqs, teng.generate(PROMPTS, gen).sequences)
    assert steps == -(-NEW // (K + 1))


# -- sampled acceptance --------------------------------------------------------


def test_sampled_topk1_equals_greedy(opt, drafts):
    """top_k = 1 makes every warped distribution a point mass: the sampled
    path gives the greedy path's tokens and steps, bit for bit."""
    _, teng = _engines(opt)
    _, draft = _engines(drafts["opt"])
    greedy = teng.generate_speculative_draft(draft, PROMPTS, GenerationConfig(max_new_tokens=NEW), k=K)
    sampled = teng.generate_speculative_draft(
        draft, PROMPTS, GenerationConfig(max_new_tokens=NEW, do_sample=True, temperature=0.8, top_k=1), k=K, seed=5)
    np.testing.assert_array_equal(sampled[0], greedy[0])
    assert sampled[1] == greedy[1]


def test_sampled_identical_models_accept_all(opt):
    """p == q: every proposal is accepted (u < 1), so the steps are
    ceil(new / (k + 1)), and every token lies in the vocabulary."""
    _, teng = _engines(opt)
    gen = GenerationConfig(max_new_tokens=NEW, do_sample=True, temperature=0.9, top_p=0.95)
    seqs, steps = teng.generate_speculative_draft(teng, PROMPTS, gen, k=K, seed=1)
    assert steps == -(-NEW // (K + 1))
    assert seqs.shape == (len(PROMPTS), NEW) and ((seqs >= 0) & (seqs < teng.cfg.vocab_size)).all()


def _dists(rng, B, n, V):
    """Rows of distributions with zeros in them (a warp's cut-off tail)."""
    x = rng.random((B, n, V)) ** 3
    x[x < 0.05] = 0.0
    x[..., 0] += 0.01
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["sampled", "lookup"])
def test_accept_counts_match_lia_tpu(kind):
    """Fed lia_tpu's uniforms (rebuilt from its key as its accept function
    splits it), the port's acceptance gives lia_tpu's accept counts."""
    rng = np.random.default_rng(11)
    B, k, V = 64, 4, 12
    ps = _dists(rng, B, k + 1, V)
    qs = _dists(rng, B, k, V)
    # proposals: mostly the likeliest tokens of p, so that runs of accepts occur
    props = np.where(rng.random((B, k)) < 0.7, ps[:, :k].argmax(-1), rng.integers(0, V, (B, k))).astype(np.int32)
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(jax.random.split(key)[0], (B, k)))
    gen = torch.Generator().manual_seed(0)
    if kind == "sampled":
        ja, _ = jla._sampled_accept_fn(k)(jnp.asarray(props), jnp.asarray(qs), jnp.asarray(ps), key)
        a, extra = la.sampled_accept(torch.from_numpy(props), torch.from_numpy(qs), torch.from_numpy(ps),
                                     torch.from_numpy(u), gen)
    else:
        ja, _ = jla._lookup_accept_fn(k)(jnp.asarray(props), jnp.asarray(ps), key)
        a, extra = la.lookup_accept(torch.from_numpy(props), torch.from_numpy(ps), torch.from_numpy(u), gen)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert 0 < a.float().mean() < k  # both early rejections and full accepts
    assert ((extra >= 0) & (extra < V)).all()


@pytest.mark.parametrize("kind", ["sampled", "lookup"])
def test_residual_law(kind):
    """Seeded chi-square tests at a 6-token vocabulary over 60000 draws: the
    extra token after a rejection at the first proposal follows the residual
    max(p - q, 0) (the rejected token zeroed for prompt lookup), and the first
    emitted token follows p itself (the Leviathan guarantee)."""
    V, k, B = 6, 2, 60000
    p = np.asarray([0.3, 0.25, 0.2, 0.15, 0.1, 0.0], np.float32)
    q = np.asarray([0.05, 0.4, 0.1, 0.1, 0.05, 0.3], np.float32)
    rng = np.random.default_rng(8)
    ps = torch.from_numpy(np.broadcast_to(p, (B, k + 1, V)).copy())
    gen = torch.Generator().manual_seed(9)
    if kind == "sampled":
        props = torch.from_numpy(rng.choice(V, size=(B, k), p=q).astype(np.int32))
        qs = torch.from_numpy(np.broadcast_to(q, (B, k, V)).copy())
        a, extra = la.sampled_accept(props, qs, ps, torch.from_numpy(rng.random((B, k)).astype(np.float32)), gen)
        residual = np.maximum(p - q, 0)
    else:
        props = torch.full((B, k), 1, dtype=torch.int32)  # a fixed proposal, token 1
        a, extra = la.lookup_accept(props, ps, torch.from_numpy(rng.random((B, k)).astype(np.float32)), gen)
        residual = p.copy()
        residual[1] = 0.0
    a, extra, props = a.numpy(), extra.numpy(), props.numpy()

    def chi2(samples, law):
        counts = np.bincount(samples, minlength=V)
        keep = law > 0
        assert counts[~keep].sum() == 0  # nothing drawn outside the law's support
        expected = law[keep] / law[keep].sum() * len(samples)
        return float(((counts[keep] - expected) ** 2 / expected).sum()), int(keep.sum()) - 1

    # the 99.99th percentile of chi-square at df <= 5 is below 25.8
    stat, df = chi2(extra[a == 0], residual)
    assert df >= 3 and stat < 25.8, stat
    stat, _ = chi2(np.where(a >= 1, props[:, 0], extra), p)
    assert stat < 25.8, stat


# -- the tiered verify pass ----------------------------------------------------


@pytest.mark.parametrize("name,kv,hbm", [("opt", "none", 50), ("opt", "none", 0), ("opt", "int8", 50)])
def test_tiered_verify_matches(models, name, kv, hbm):
    """Prompt lookup under the scheduler (half resident, or every layer
    streamed): the resident engine's sequences and steps, and lia_tpu's
    scheduler's."""
    rt = dict(hbm_percentage=hbm, stream_weights=hbm == 0)
    jeng, teng = _engines(models[name], kv, **rt)
    _, resident = _engines(models[name], kv)
    gen = GenerationConfig(max_new_tokens=NEW)
    seqs, steps = teng.generate_speculative(PROMPTS, gen, k=K)
    ref, ref_steps = resident.generate_speculative(PROMPTS, gen, k=K)
    np.testing.assert_array_equal(seqs, ref)
    assert steps == ref_steps
    jseqs, jsteps = jeng.generate_speculative(PROMPTS, JGen(max_new_tokens=NEW), k=K)
    np.testing.assert_array_equal(seqs, np.asarray(jseqs))
    assert steps == jsteps


def test_tiered_draft_target(opt, drafts):
    """A tiered target with a resident draft, greedy and sampled at top_k=1:
    the resident target's tokens."""
    _, teng = _engines(opt, hbm_percentage=50)
    _, resident = _engines(opt)
    _, draft = _engines(drafts["opt"])
    gen = GenerationConfig(max_new_tokens=NEW)
    ref = resident.generate_speculative_draft(draft, PROMPTS, gen, k=K)
    out = teng.generate_speculative_draft(draft, PROMPTS, gen, k=K)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1] == ref[1]
    sampled = teng.generate_speculative_draft(draft, PROMPTS, gen.replace(do_sample=True, top_k=1), k=K)
    np.testing.assert_array_equal(sampled[0], ref[0])


def test_host_placement_raises_before_prefill(opt, monkeypatch):
    """A host-KV plan has no chunk attention: speculation raises before the
    (streamed) prefill runs; the scheduler's verify_pass raises too."""
    _, teng = _engines(opt, hbm_percentage=50, prefill_policy=0, decode_policy=0)
    sched = teng.scheduler

    def refuse(*a, **kw):
        raise AssertionError("the prefill ran")

    monkeypatch.setattr(sched, "prefill_pass", refuse)
    with pytest.raises(NotImplementedError, match="host-placement"):
        teng.generate_speculative(PROMPTS, GenerationConfig(max_new_tokens=4))
    with pytest.raises(NotImplementedError, match="host-placement"):
        teng.generate_speculative_draft(teng_resident := _engines(opt)[1], PROMPTS, GenerationConfig(max_new_tokens=4))
    with pytest.raises(NotImplementedError, match="draft model must be resident"):
        teng_resident.generate_speculative_draft(teng, PROMPTS, GenerationConfig(max_new_tokens=4))
    with pytest.raises(NotImplementedError, match="host-placement"):
        sched.verify_pass(torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32), {})


# -- the paged verify ----------------------------------------------------------


@pytest.mark.parametrize("name", ["opt", "llama"])
def test_verify_step_paged_matches_lia_tpu(models, name):
    """write_chunk_all_layers and verify_step_paged on the same pools:
    lia_tpu's pools bit for bit (the null page too), its logits within 1e-5.
    Row 0's chunk straddles a page boundary, row 2 is inactive (its chunk
    goes to page 0)."""
    jcfg, jp, tcfg, tp = models[name]
    rng = np.random.default_rng(5)
    L, nb, H, bs, D, C = tcfg.num_layers, 12, tcfg.num_kv_heads, 8, tcfg.head_dim, K + 1
    k_pool = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32)
    v_pool = rng.standard_normal((L, nb, H, bs, D)).astype(np.float32)
    table = np.asarray([[3, 5, 0], [7, 1, 9], [0, 0, 0]], np.int32)
    lengths = np.asarray([6, 11, 0], np.int32)  # row 0 writes slots 6..9: pages 3 and 5
    active = np.asarray([True, True, False])
    tokens = rng.integers(2, tcfg.vocab_size, (3, C)).astype(np.int32)
    positions = (lengths[:, None] + np.arange(C)[None, :]).astype(np.int32)

    ks = rng.standard_normal((L, 3, H, C, D)).astype(np.float32)
    vs = rng.standard_normal((L, 3, H, C, D)).astype(np.float32)
    jk, jv = jpg.write_chunk_all_layers(*map(jnp.asarray, (k_pool, v_pool, ks, vs, table, lengths, active)))
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    pg.write_chunk_all_layers(tk, tv, *map(torch.from_numpy, (ks, vs, table, lengths, active)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy()[:, 0], k_pool[:, 0])  # the inactive row wrote the null page

    jlogits, jk, jv = jpg.verify_step_paged(jcfg, jax.tree_util.tree_map(jnp.asarray, jp), *map(
        jnp.asarray, (tokens, positions, k_pool, v_pool, table, lengths, active)))
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    logits, _, _ = pg.verify_step_paged(tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(positions), tk, tv,
                                        *map(torch.from_numpy, (table, lengths, active)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    for mine, ref in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(mine.numpy()[:, 1:], np.asarray(ref)[:, 1:], rtol=1e-5, atol=1e-5)


# -- speculative serving -------------------------------------------------------

SYS = [((11 * i) % 300) + 2 for i in range(24)]  # a shared system prompt: prefix-cache hits
SERVE_PROMPTS = PROMPTS + [SYS + [401, 402, 5, 9, 401], SYS + [404, 405, 406], list(range(3, 30))]
SERVE_NEW = 9


def _serve(model, cls, prompts, gen_kw=None, submit_kw=None, **kw):
    jcfg, jp, tcfg, tp = model
    gen = dict(max_new_tokens=SERVE_NEW, **(gen_kw or {}))
    if cls is JBatcher:
        cb = JBatcher(jcfg, jp, gen=JGen(**gen), **kw)
    else:
        cb = ContinuousBatcher(tcfg, tp, gen=GenerationConfig(**gen), device="cpu", **kw)
    submit_kw = submit_kw or [{}] * len(prompts)
    ids = [cb.submit(p, **s) for p, s in zip(prompts, submit_kw)]
    by_id = {r.req_id: r.output for r in cb.run()}
    return [[int(t) for t in by_id[i]] for i in ids], cb


def _pool_clean(cb):
    assert (cb.page_rc == 0).all()
    assert len(cb.free_blocks) + len(cb.cached_pages) == cb.num_blocks - 1


SPEC_SERVING = {
    "slab": dict(),
    "slab-int8kv": dict(kv_quantized=True),
    "paged": dict(paged=True, block_size=8, prefix_cache=False),
    "paged-prefix-cache": dict(paged=True, block_size=8),
    "chunked": dict(prefill_chunk=16),
    "chunked-paged": dict(paged=True, block_size=8, prefill_chunk=16),
    "draft-slab": dict(draft=True),
    "draft-paged": dict(draft=True, paged=True, block_size=8),
}


@pytest.mark.parametrize("name", sorted(SPEC_SERVING))
def test_spec_serving_matches_plain_and_lia_tpu(opt, drafts, name):
    """Speculative serving (k = 3) over the slab (bf16 / int8 KV), the paged
    pool with and without prefix caching, chunked admission and a draft
    model (slab and paged): every request's tokens equal plain serving's and
    lia_tpu's speculative batcher's, with the same verify steps and prefix
    hits; every page comes back."""
    kw = dict(SPEC_SERVING[name])
    base = {key: v for key, v in kw.items() if key != "draft"}
    plain, _ = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, max_batch=3, max_len=128, **base)
    spec = dict(base, speculate_k=K)
    djcfg, djp, dtcfg, dtp = drafts["opt"]
    jkw = dict(spec, draft=(djcfg, djp)) if kw.get("draft") else spec
    tkw = dict(spec, draft=(dtcfg, dtp)) if kw.get("draft") else spec
    out, cb = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, max_batch=3, max_len=128, **tkw)
    ref, jcb = _serve(opt, JBatcher, SERVE_PROMPTS, max_batch=3, max_len=128, **jkw)
    assert out == plain
    assert out == ref
    stats, jstats = cb.stats(), jcb.stats()
    for key in ("decode_steps", "prefix_hits", "prefix_tokens_reused"):
        assert stats.get(key) == jstats.get(key), key
    assert stats["decode_steps"] < sum(map(len, out)) - len(out)  # proposals landed
    if cb.paged:
        _pool_clean(cb)
    if name == "paged-prefix-cache":
        assert stats["prefix_hits"] == 1


def test_spec_serving_stop_tokens(opt):
    """Per-request stop tokens cut an accepted run: each request ends at its
    first stop token, as in plain serving and lia_tpu's batcher."""
    plain, _ = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, max_batch=3, max_len=128)
    stops = [[plain[i][3]] for i in range(len(SERVE_PROMPTS))]
    sub = [dict(stop_token_ids=s) for s in stops]
    out, _ = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, submit_kw=sub, max_batch=3, max_len=128, speculate_k=K)
    ref, _ = _serve(opt, JBatcher, SERVE_PROMPTS, submit_kw=sub, max_batch=3, max_len=128, speculate_k=K)
    plain_stop, _ = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, submit_kw=sub, max_batch=3, max_len=128)
    assert out == ref == plain_stop
    assert all(o[-1] == s[0] and len(o) <= 4 for o, s in zip(out, stops))


@pytest.mark.parametrize("draft", [False, True])
def test_spec_serving_topk1_sampled_equals_greedy(opt, drafts, draft):
    """Sampled speculative serving at top_k = 1 (prompt lookup's point-mass
    acceptance, or the draft's Leviathan rule): greedy serving's tokens."""
    kw = dict(max_batch=3, max_len=128, speculate_k=K)
    if draft:
        kw["draft"] = drafts["opt"][2:]
    greedy, _ = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, **kw)
    sampled, _ = _serve(opt, ContinuousBatcher, SERVE_PROMPTS, gen_kw=dict(do_sample=True, temperature=0.7, top_k=1),
                        **kw)
    assert sampled == greedy


def test_spec_serving_guards(opt):
    """Speculation refuses what it does not compose with: the logits
    processors, host-placement plans of the tiered scheduler, meshes (A13),
    per-request sampling overrides, and a draft without speculate_k."""
    _, _, tcfg, tp = opt
    for kw, item in ((dict(enable_processors=True), "processors"),
                     (dict(gen=GenerationConfig(repetition_penalty=1.2)), "processors"),
                     (dict(runtime=RuntimeConfig(decode_policy=1, stream_weights=True)), "chunk attention kernel"),
                     (dict(mesh=object()), "A13")):
        with pytest.raises(NotImplementedError, match=item):
            ContinuousBatcher(tcfg, tp, speculate_k=K, device="cpu", **kw)
    with pytest.raises(ValueError, match="speculate_k"):
        ContinuousBatcher(tcfg, tp, draft=(tcfg, tp), device="cpu")
    cb = ContinuousBatcher(tcfg, tp, speculate_k=K, device="cpu")
    with pytest.raises(ValueError, match="engine-level warp"):
        cb.submit([1, 2], temperature=0.5)
    cb = ContinuousBatcher(tcfg, tp, speculate_k=K, max_len=64, device="cpu")
    cb.submit(list(range(2, 18)), 45)  # 16 + 45 slots fit; with the k + 1 slack they do not
    with pytest.raises(ValueError, match="slots > max_len"):
        cb.run()
    eng = InferenceEngine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="processor"):
        eng.generate_speculative(PROMPTS, GenerationConfig(repetition_penalty=1.2))
    with pytest.raises(NotImplementedError, match="greedy-only"):
        eng.generate_speculative(PROMPTS, GenerationConfig(do_sample=True))
