"""Speculative decoding (port of ``lia_tpu/engine/lookahead.py``): prompt
lookup, a draft model, and sampled (Leviathan) acceptance.

Each step proposes ``k`` tokens per sequence, by matching the trailing
``ngram`` against the sequence's own history (prompt lookup) or by ``k + 1``
ragged decode steps of a small draft model, then verifies all C = k + 1
positions in ONE chunked pass over the target's cache
(:func:`lia_tpu_torch.models.transformer.verify_chunk`, the
``flash_attention_cached`` kernel at per-row bases; under the tiered scheduler
``StreamingScheduler.verify_pass``, which streams each layer's weights once
for all C candidates). Greedy requests accept the longest prefix of proposals
that equals the target's argmax, plus the target's own next token, so the
output is exactly stepwise greedy decoding's; sampled requests accept each
proposal x with probability min(1, p(x) / q(x)) and draw the extra token from
the residual max(p - q, 0), so the output is distributed as plain sampling
under the same warp.

The conventions are the reference's: validity is contiguous, ``[start_b,
length_b)``; the verify writes all C candidates and the mask and length then
advance by the accepted count only (:func:`lia_tpu_torch.ops.kv_cache.accept_ragged`),
so rejected slots are dead until the next write; the draft's cache advances
k + 1 slots a step and is rewound to the verified prefix
(:func:`lia_tpu_torch.ops.kv_cache.rewind_ragged`).

Distributions stay on the device; only the ``[B]`` accept counts and extra
tokens (and the ``[B, k]`` proposals) go to the host. Every random draw comes
from an explicit ``torch.Generator``; the acceptance functions take their
uniforms as an argument (:func:`uniforms` draws them), so a test can hand them
the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from lia_tpu_torch.config import GenerationConfig, torch_dtype
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import sampling

HOST_PLANS = ("the chunked verify pass needs plans that keep KV on the card (policy 3 streaming); "
              "host-placement policies have no chunk attention kernel")


def propose_ngram(history: List[int], ngram: int, k: int, pad_id: int) -> List[int]:
    """Propose k continuation tokens by matching the trailing n-gram against
    the sequence's own history, the most recent earlier occurrence first, and
    falling back to shorter n-grams; pad-filled where nothing matches (a pad
    proposal simply fails verification)."""
    h = history
    for n in range(min(ngram, len(h) - 1), 0, -1):
        tail = h[-n:]
        for i in range(len(h) - n - 1, -1, -1):
            if h[i : i + n] == tail:
                cand = h[i + n : i + n + k]
                if cand:
                    return (cand + [pad_id] * k)[:k]
    return [pad_id] * k


def reject_processors(gen: GenerationConfig) -> None:
    """Speculation verifies against the raw argmax / distributions; stateful
    logits processors would break its exactness, so it refuses them."""
    if sampling.needs_processors(gen):
        raise NotImplementedError(
            "repetition_penalty/min_new_tokens/no_repeat_ngram_size are not wired into speculative decoding; "
            "use engine.generate for processor-bearing requests (ROADMAP A3)"
        )


def spec_slots(S: int, new_tokens: int, C: int) -> int:
    """Cache slots of a speculative run: the prompt bucket, the new tokens and
    one chunk of slack (the last verify writes C candidates past the
    committed length), rounded up to 128."""
    return -(-(S + new_tokens + C) // 128) * 128


def uniforms(B: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """The acceptance tests' uniforms [B, k] in [0, 1)."""
    return torch.rand((B, k), generator=generator, device=generator.device)


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(``logits``) ([..., V] → [...] int32) by
    the Gumbel-max trick, as ``jax.random.categorical`` draws. The uniforms
    are kept off 0, so the noise lies within about [-4.5, 17]: a logit masked
    to -1e30 (or a log-probability clamped at 1e-30) is never drawn over one
    that is not."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + g, dim=-1).to(torch.int32)


def _extra_token(pa: torch.Tensor, residual: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The one token after the accepted run: from the normalized residual, or
    from ``pa`` where the residual is empty; the reference's clamps (1e-20 on
    the sums, 1e-30 under the log)."""
    ssum = residual.sum(dim=1, keepdim=True)
    dist = torch.where(ssum > 0, residual / ssum.clamp(min=1e-20), pa / pa.sum(dim=1, keepdim=True).clamp(min=1e-20))
    return categorical(torch.log(dist.clamp(min=1e-30)), generator)


def greedy_accept(props: np.ndarray, greedy: np.ndarray) -> np.ndarray:
    """Per row, how many leading proposals (props [B, k]) equal the target's
    argmax at their positions (greedy [B, k+1]: entry i follows chunk token
    i); the row then takes those and the argmax after them."""
    return np.cumprod(props == greedy[:, : props.shape[1]], axis=1).sum(axis=1)


def _leading(acc: torch.Tensor) -> torch.Tensor:
    """Per row, the count of leading True entries of ``acc`` [B, k]."""
    return torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)


def sampled_accept(props, qs, ps, u, generator: torch.Generator):
    """Leviathan acceptance for a draft model's sampled proposals: proposal i
    of a row is accepted while ``u[b, i] < p(x) / q(x)``; the extra token comes
    from the residual max(p_a - q_a, 0) after a rejection at a, or from p_k
    after a full accept. props [B, k] int, qs [B, k, V] (the draft's warped
    distributions), ps [B, k+1, V] (the target's), u [B, k]. Returns (accepted
    counts [B] int32, extra tokens [B] int32), on the device."""
    B, k, _ = qs.shape
    rows = torch.arange(B, device=ps.device)
    idx = props.long()
    kk = torch.arange(k, device=ps.device)[None, :]
    px, qx = ps[rows[:, None], kk, idx], qs[rows[:, None], kk, idx]
    a = _leading(u < px / qx.clamp(min=1e-20))
    pa = ps[rows, a]
    qa = torch.where((a < k)[:, None], qs[rows, a.clamp(max=k - 1)], torch.zeros_like(pa))
    extra = _extra_token(pa, (pa - qa).clamp(min=0.0), generator)
    return a.to(torch.int32), extra


def lookup_accept(props, ps, u, generator: torch.Generator):
    """Leviathan acceptance for deterministic proposals (prompt lookup): the
    draft distribution is a point mass, so proposal i is accepted while
    ``u[b, i] < p(x)``, and the residual after a rejection is p_a with the
    rejected token zeroed. props [B, k] int, ps [B, k+1, V], u [B, k].
    Returns (accepted counts [B] int32, extra tokens [B] int32)."""
    B, k = props.shape
    rows = torch.arange(B, device=ps.device)
    idx = props.long()
    px = ps[rows[:, None], torch.arange(k, device=ps.device)[None, :], idx]
    a = _leading(u < px)
    pa = ps[rows, a]
    rej = idx.gather(1, a.clamp(max=k - 1).long()[:, None])  # [B, 1]
    drop = (a < k)[:, None] & (torch.arange(pa.shape[1], device=ps.device)[None, :] == rej)
    extra = _extra_token(pa, torch.where(drop, torch.zeros_like(pa), pa), generator)
    return a.to(torch.int32), extra


def draft_loop(cfg, params, pending, n_real, cache: kvc.KVCache, k: int, active=None):
    """The draft's k + 1 ragged greedy decode steps (B2, or B3 over an INT8
    cache): it feeds [pending, p_1, .., p_k], so the last step writes p_k's KV
    (the cache then covers every token that can be accepted) and its logits
    are dropped. pending / n_real (logical positions) [B] on the device;
    ``active`` [B] bool, default all rows. Returns (proposals [B, k] int32, the
    cache, k + 1 slots on for active rows)."""
    if active is None:
        active = torch.ones(pending.shape[0], dtype=torch.bool, device=pending.device)
    tok, props = pending, []
    for i in range(k + 1):
        logits, cache = T.decode_step_ragged(cfg, params, tok[:, None], n_real + i, cache, active)
        tok = sampling.greedy(logits)
        props.append(tok)
    return torch.stack(props[:k], dim=1), cache


def draft_loop_sampled(cfg, params, pending, n_real, cache: kvc.KVCache, k: int, gen: GenerationConfig,
                       generator: torch.Generator, active=None):
    """:func:`draft_loop` with sampled proposals: each is drawn from the
    draft's warped logits, and its warped distribution is kept. Returns
    (proposals [B, k] int32, q [B, k, V] fp32, the cache)."""
    if active is None:
        active = torch.ones(pending.shape[0], dtype=torch.bool, device=pending.device)
    tok, props, qs = pending, [], []
    for i in range(k + 1):
        logits, cache = T.decode_step_ragged(cfg, params, tok[:, None], n_real + i, cache, active)
        if i == k:
            break
        qs.append(sampling.warped_probs(logits, gen))
        tok = categorical(sampling.warp_logits(logits, gen), generator)
        props.append(tok)
    return torch.stack(props, dim=1), torch.stack(qs, dim=1), cache


class _Target:
    """The target side of a speculative run: the prompt's prefill, then chunk
    verifies and acceptance advances, over the resident engine's ragged slab
    cache or the tiered scheduler's segment caches. Host-placement plans
    raise before the prefill runs."""

    def __init__(self, engine, tokens: np.ndarray, mask: np.ndarray, max_len: int):
        B = tokens.shape[0]
        dev = engine.device
        self.engine, self.dev = engine, dev
        self.sched = engine.scheduler
        if self.sched is not None:
            if not self.sched.tpu_kv_plans:
                raise NotImplementedError(HOST_PLANS)
            self.logits, state = self.sched.prefill_pass(tokens, mask, max_len)
            self.state = self.sched.ragged_state(state)
            return
        cfg = engine.cfg
        cache = kvc.init_cache(cfg, B, max_len, torch_dtype(cfg.dtype),
                               quantized=engine.runtime.quant.kv_cache_dtype == "int8", device=dev)
        self.logits, cache = T.prefill(cfg, engine.params, torch.from_numpy(tokens).to(dev),
                                       torch.from_numpy(mask).to(dev), cache)
        self.cache = cache._replace(length=cache.length.reshape(1).repeat(B))  # ragged: one length a row

    def verify(self, chunk: np.ndarray, positions: np.ndarray, probs_gen: Optional[GenerationConfig] = None):
        """The chunk [B, C] at its positions through the target: the argmax of
        every position [B, C] int32, or with ``probs_gen`` the warped
        distributions [B, C, V] fp32, on the device."""
        tok, pos = torch.from_numpy(chunk).to(self.dev), torch.from_numpy(positions).to(self.dev)
        if self.sched is not None:
            out, self.state = self.sched.verify_pass(tok, pos, self.state, probs_gen=probs_gen)
            return out
        logits = T.verify_chunk(self.engine.cfg, self.engine.params, tok, pos, self.cache)
        return sampling.greedy(logits) if probs_gen is None else sampling.warped_probs(logits, probs_gen)

    def accept(self, accept: np.ndarray) -> None:
        acc = torch.from_numpy(accept).to(self.dev)
        if self.sched is not None:
            self.state = self.sched.accept_state(self.state, acc)
        else:
            self.cache = kvc.accept_ragged(self.cache, acc)


def _positions(n_real: np.ndarray, C: int) -> np.ndarray:
    return (n_real[:, None] + np.arange(C, dtype=np.int32)[None, :]).astype(np.int32)


def _take(out: List[int], new_toks: List[int], eos: Optional[int]):
    """Append a step's tokens to a row's output, cut after the first EOS;
    returns (the tokens taken, whether the row is done)."""
    done = eos is not None and eos in new_toks
    if done:
        new_toks = new_toks[: new_toks.index(eos) + 1]
    out.extend(new_toks)
    return new_toks, done


def _sequences(out: List[List[int]], gen: GenerationConfig) -> np.ndarray:
    n, pad = gen.max_new_tokens, gen.pad_token_id
    return np.stack([np.asarray((o + [pad] * n)[:n], np.int32) for o in out])


def _live(out, done, gen) -> bool:
    return any(not done[b] and len(out[b]) < gen.max_new_tokens for b in range(len(out)))


def generate_prompt_lookup(engine, prompts: Sequence[Sequence[int]], gen: GenerationConfig, ngram: int = 3,
                           k: int = 4):
    """Greedy generation with prompt-lookup speculation. Returns ``(sequences
    [B, max_new_tokens] int32, n_verify_steps)``; the sequences equal
    :meth:`InferenceEngine.generate`'s greedy output, and the step count falls
    below ``max_new_tokens`` wherever proposals land."""
    from lia_tpu_torch.engine.engine import pack_prompts

    if gen.do_sample or gen.num_beams > 1:
        raise NotImplementedError("prompt-lookup speculation is greedy-only")
    reject_processors(gen)
    tokens, mask = pack_prompts(prompts, gen.pad_token_id)
    B, S = tokens.shape
    C = k + 1
    target = _Target(engine, tokens, mask, spec_slots(S, gen.max_new_tokens, C))
    pending = sampling.greedy(target.logits).cpu().numpy().copy()
    n_real = mask.sum(1).astype(np.int32)  # logical position of the pending token
    history = [list(p) + [int(pending[b])] for b, p in enumerate(prompts)]
    out: List[List[int]] = [[int(pending[b])] for b in range(B)]
    eos = gen.eos_token_id
    done = [eos is not None and out[b][0] == eos for b in range(B)]

    steps = 0
    while _live(out, done, gen):
        props = np.stack([propose_ngram(history[b], ngram, k, gen.pad_token_id) for b in range(B)]).astype(np.int32)
        chunk = np.concatenate([pending[:, None], props], axis=1)  # [B, C]
        greedy = target.verify(chunk, _positions(n_real, C)).cpu().numpy()  # [b, i] follows chunk[b, i]
        steps += 1
        accepted = greedy_accept(props, greedy)
        accept = np.zeros((B,), np.int32)
        for b in range(B):
            if done[b] or len(out[b]) >= gen.max_new_tokens:
                continue  # frozen: its cache slots are scratch from here on
            a = int(accepted[b])
            accept[b] = a + 1  # the pending token and a verified proposals
            new_toks, done[b] = _take(out[b], [int(t) for t in chunk[b, 1 : a + 1]] + [int(greedy[b, a])], eos)
            history[b].extend(new_toks)
            pending[b] = new_toks[-1]
        n_real = n_real + accept
        target.accept(accept)
    return _sequences(out, gen), steps


class _Draft:
    """The draft model's side: its own ragged slab cache, prefilled with the
    prompts, k + 1 decode steps a verify and a rewind to the verified prefix."""

    @staticmethod
    def check(engine, draft_engine) -> None:
        """Refuse a draft that streams, or whose vocabulary is not the target's."""
        if draft_engine.scheduler is not None:
            # the draft is the small model: it stays resident, only the target streams
            raise NotImplementedError("the draft model must be resident")
        if draft_engine.cfg.vocab_size != engine.cfg.vocab_size:
            # sampled acceptance subtracts q from p elementwise: both over one vocabulary
            raise ValueError("speculation requires draft vocab == target vocab")

    def __init__(self, draft_engine, tokens: np.ndarray, mask: np.ndarray, max_len: int):
        B, S = tokens.shape
        d = draft_engine
        self.cfg, self.params, self.dev = d.cfg, d.params, d.device
        cache = kvc.init_cache(d.cfg, B, max_len, torch_dtype(d.cfg.dtype),
                               quantized=d.runtime.quant.kv_cache_dtype == "int8", device=d.device)
        _, cache = T.prefill(d.cfg, d.params, torch.from_numpy(tokens).to(d.device),
                             torch.from_numpy(mask).to(d.device), cache)
        self.cache = cache._replace(length=cache.length.reshape(1).repeat(B))
        self.abs_len = np.full((B,), S, np.int32)  # the cache's write slot, prompts left-padded to S

    def propose(self, pending: np.ndarray, n_real: np.ndarray, k: int, gen=None, generator=None):
        tok, pos = torch.from_numpy(pending).to(self.dev), torch.from_numpy(n_real).to(self.dev)
        if gen is None:
            props, self.cache = draft_loop(self.cfg, self.params, tok, pos, self.cache, k)
            return props, None
        props, qs, self.cache = draft_loop_sampled(self.cfg, self.params, tok, pos, self.cache, k, gen, generator)
        return props, qs

    def rewind(self, accept: np.ndarray) -> None:
        self.abs_len = self.abs_len + accept
        self.cache = kvc.rewind_ragged(self.cache, torch.from_numpy(self.abs_len).to(self.dev))


def generate_draft_speculative(engine, draft_engine, prompts: Sequence[Sequence[int]], gen: GenerationConfig,
                               k: int = 4):
    """Greedy generation with a draft model proposing k tokens per verify pass
    (``draft_engine`` shares the target's vocabulary, e.g. opt-125m drafting
    for opt-6.7b). Returns ``(sequences, n_verify_steps)``, the sequences
    exactly the target's stepwise greedy output."""
    from lia_tpu_torch.engine.engine import pack_prompts

    if gen.do_sample or gen.num_beams > 1:
        raise NotImplementedError("draft speculation is greedy-only")
    reject_processors(gen)
    _Draft.check(engine, draft_engine)
    tokens, mask = pack_prompts(prompts, gen.pad_token_id)
    B, S = tokens.shape
    C = k + 1
    max_len = spec_slots(S, gen.max_new_tokens, C)
    target = _Target(engine, tokens, mask, max_len)
    draft = _Draft(draft_engine, tokens, mask, max_len)
    pending = sampling.greedy(target.logits).cpu().numpy().copy()
    n_real = mask.sum(1).astype(np.int32)
    out: List[List[int]] = [[int(pending[b])] for b in range(B)]
    eos = gen.eos_token_id
    done = [eos is not None and out[b][0] == eos for b in range(B)]

    steps = 0
    while _live(out, done, gen):
        props = draft.propose(pending, n_real, k)[0].cpu().numpy()  # [B, k]
        chunk = np.concatenate([pending[:, None], props], axis=1)
        greedy = target.verify(chunk, _positions(n_real, C)).cpu().numpy()
        steps += 1
        accepted = greedy_accept(props, greedy)
        accept = np.zeros((B,), np.int32)
        for b in range(B):
            if done[b] or len(out[b]) >= gen.max_new_tokens:
                continue
            a = int(accepted[b])
            accept[b] = a + 1
            new_toks, done[b] = _take(out[b], [int(t) for t in chunk[b, 1 : a + 1]] + [int(greedy[b, a])], eos)
            pending[b] = new_toks[-1]
        n_real = n_real + accept
        target.accept(accept)
        draft.rewind(accept)
    return _sequences(out, gen), steps


def generate_draft_speculative_sampled(engine, draft_engine, prompts: Sequence[Sequence[int]],
                                       gen: GenerationConfig, k: int = 4, seed: int = 0):
    """Sampled two-model speculation: the output is distributed as plain
    target sampling under ``gen``'s warp; with ``top_k=1`` it is the greedy
    path's output token for token. Every draw comes from one generator seeded
    with ``seed``. Returns ``(sequences, n_verify_steps)``."""
    from lia_tpu_torch.engine.engine import pack_prompts

    if gen.num_beams > 1:
        raise NotImplementedError("speculation composes with greedy/sampling only")
    reject_processors(gen)
    _Draft.check(engine, draft_engine)
    tokens, mask = pack_prompts(prompts, gen.pad_token_id)
    B, S = tokens.shape
    C = k + 1
    max_len = spec_slots(S, gen.max_new_tokens, C)
    target = _Target(engine, tokens, mask, max_len)
    draft = _Draft(draft_engine, tokens, mask, max_len)
    generator = torch.Generator(device=engine.device)
    generator.manual_seed(seed)
    pending = categorical(sampling.warp_logits(target.logits, gen), generator).cpu().numpy().copy()
    n_real = mask.sum(1).astype(np.int32)
    out: List[List[int]] = [[int(pending[b])] for b in range(B)]
    eos = gen.eos_token_id
    done = [eos is not None and out[b][0] == eos for b in range(B)]

    steps = 0
    while _live(out, done, gen):
        props, qs = draft.propose(pending, n_real, k, gen, generator)
        props_np = props.cpu().numpy()  # [B, k]: small
        chunk = np.concatenate([pending[:, None], props_np], axis=1)
        ps = target.verify(chunk, _positions(n_real, C), probs_gen=gen)
        # acceptance runs on the device over the full distributions; only [B]
        # counts and tokens come back
        a_dev, extra_dev = sampled_accept(props, qs, ps, uniforms(B, k, generator), generator)
        a_np, extra_np = a_dev.cpu().numpy(), extra_dev.cpu().numpy()
        steps += 1
        accept = np.zeros((B,), np.int32)
        for b in range(B):
            if done[b] or len(out[b]) >= gen.max_new_tokens:
                continue
            a = int(a_np[b])
            accept[b] = a + 1
            new_toks, done[b] = _take(out[b], [int(t) for t in props_np[b, :a]] + [int(extra_np[b])], eos)
            pending[b] = new_toks[-1]
        n_real = n_real + accept
        target.accept(accept)
        draft.rewind(accept)
    return _sequences(out, gen), steps
