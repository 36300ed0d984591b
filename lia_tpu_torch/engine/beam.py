"""Beam search over the preallocated KV cache (port of ``lia_tpu/engine/beam.py``).

Classic beam search: beams expand over the top nb of nb·V; finished beams are
frozen (they may only emit pad, at no score change); scores are summed token
log-probs. The logits processors run on the log-softmax scores, as HF's
beam_search runs its LogitsProcessorList, and their state (seen tokens,
token history) is reordered with the winning beams. Stochastic beams
(``gen.do_sample``, HF's ``_beam_sample``) perturb the candidate scores with
Gumbel noise from an explicit ``torch.Generator`` before the top-k, which
draws beams without replacement while exact scores keep accumulating; the
draws differ from ``jax.random``'s.

The cache is either a plain :class:`~lia_tpu_torch.ops.kv_cache.KVCache` at
B0·nb rows (expanded: the whole cache is gathered on each reorder) or a
:class:`~lia_tpu_torch.ops.kv_cache.BeamKVCache` (grouped: a shared prompt per
group and a per-beam tail, and the reorder gathers only the tail). Both
reorder in place.

Ties: ``jax.lax.top_k`` returns the lower index first among equal scores;
``torch.topk`` promises no order, so the selection is a stable descending sort
of the [B, nb·V] flat scores. A tie resolved the other way would change the
winning beams and every later token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lia_tpu_torch.config import GenerationConfig, ModelConfig
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import sampling

NEG_INF = -1e30


def select_best(history: np.ndarray, scores: np.ndarray, gen: GenerationConfig) -> np.ndarray:
    """Final beam selection [B, nb, L] × [B, nb] → [B, L] sequences.

    ``gen.length_penalty`` != 0 applies HF BeamSearchScorer's normalization
    (score / len**lp, len = tokens through the first EOS): rank-neutral when
    every beam runs the full length."""
    B = scores.shape[0]
    if gen.length_penalty != 0.0:
        L = history.shape[-1]
        if gen.eos_token_id is not None:
            hits = history == gen.eos_token_id
            lens = np.where(hits.any(-1), hits.argmax(-1) + 1, L)
        else:
            lens = np.full(scores.shape, L)
        scores = scores / np.maximum(lens, 1) ** gen.length_penalty
    best = scores.argmax(axis=1)
    return history[np.arange(B), best]


def init_beam_state(B: int, nb: int, device=None):
    """Scores [B, nb] (0 for beam 0, NEG_INF for the rest, so the first
    expansion draws from one beam) and the finished flags."""
    scores = torch.full((B, nb), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return scores, torch.zeros((B, nb), dtype=torch.bool, device=device)


def top_k(select: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, the lower index first
    among ties (``jax.lax.top_k``'s order): a stable descending sort."""
    return torch.sort(select, dim=1, descending=True, stable=True).indices[:, :k]


def beam_select(
    gen: GenerationConfig,
    vocab_size: int,
    logits: torch.Tensor,  # [B*nb, V] this step's logits
    scores: torch.Tensor,  # [B, nb]
    finished: torch.Tensor,  # [B, nb]
    generator: Optional[torch.Generator] = None,  # => stochastic beams (_beam_sample)
    proc: Optional[tuple] = None,  # (seen [B*nb, V], hist [B*nb, L], cur_len, n_gen)
):
    """The beam expansion shared by the resident loop and the scheduler's
    stepwise loop. Returns (next_tok [B*nb] int32, scores, finished, flat_src
    [B*nb] int64: the source batch row of each winner)."""
    B, nb = scores.shape
    V = vocab_size
    if gen.do_sample and gen.temperature != 1.0:
        logits = logits / max(gen.temperature, 1e-6)
    lp_flat = torch.log_softmax(logits.float(), dim=-1)
    if proc is not None:
        seen, hist, cur_len, n_gen = proc
        lp_flat = sampling.process_logits(lp_flat, gen, seen, n_gen, history=hist, cur_len=cur_len)
    logprobs = lp_flat.reshape(B, nb, V)
    if gen.eos_token_id is not None:
        # frozen beams may only emit pad, with no score change
        pad_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=logits.device)
        if 0 <= gen.pad_token_id < V:
            pad_only[gen.pad_token_id] = 0.0
        logprobs = torch.where(finished[:, :, None], pad_only, logprobs)
    flat = (scores[:, :, None] + logprobs).reshape(B, nb * V)
    select = flat
    if generator is not None and gen.do_sample:
        # Gumbel-top-k: nb candidates drawn without replacement
        u = torch.rand(flat.shape, generator=generator, device=flat.device).clamp_(min=1e-20)
        select = flat - torch.log(-torch.log(u))
    idx = top_k(select, nb)
    beam_src = idx // V  # which beam each winner came from
    next_tok = (idx % V).to(torch.int32)
    flat_src = ((torch.arange(B, device=flat.device) * nb)[:, None] + beam_src).reshape(-1)
    if gen.eos_token_id is not None:
        finished = finished.gather(1, beam_src) | (next_tok == gen.eos_token_id)
    return next_tok.reshape(-1), flat.gather(1, idx), finished, flat_src


def reorder_proc(proc: Optional[tuple], flat_src: torch.Tensor, next_tok: torch.Tensor):
    """Gather processor state rows by the winning beams and record the fresh
    tokens (seen set; token history at ``cur_len``)."""
    if proc is None:
        return None
    seen, hist, cur_len, n_gen = proc
    seen = sampling.update_seen(seen.index_select(0, flat_src), next_tok)
    hist = hist.index_select(0, flat_src)
    hist[:, cur_len] = next_tok
    return seen, hist, cur_len + 1, n_gen + 1


def beam_step(cfg: ModelConfig, gen: GenerationConfig, params, tokens, positions, cache, scores, finished,
              generator: Optional[torch.Generator] = None, proc: Optional[tuple] = None):
    """One expansion step: tokens/positions [B*nb]. Returns (next_tokens, cache,
    scores, finished, flat_src, proc), the cache reordered in place with the
    winning beams (its tail only, for a grouped cache) and the processor state
    reordered and updated with the fresh tokens."""
    grouped = isinstance(cache, kvc.BeamKVCache)
    step = T.beam_decode_step if grouped else T.decode_step
    logits, cache = step(cfg, params, tokens[:, None], positions[:, None], cache)
    next_tok, scores, finished, flat_src = beam_select(gen, cfg.vocab_size, logits, scores, finished, generator,
                                                       proc)
    cache = kvc.beam_tail_reorder(cache, flat_src) if grouped else kvc.beam_reorder(cache, flat_src)
    return next_tok, cache, scores, finished, flat_src, reorder_proc(proc, flat_src, next_tok)


def make_beam_decoder(cfg: ModelConfig, gen: GenerationConfig, num_steps: int):
    """The fused beam decode: ``num_steps`` beam steps on the device, tracking
    the token history (reordered with the beams every step), with no host sync
    inside; the caller syncs once when it reads the history. Returns
    ``fused(params, tok0, pos0, cache, scores0, finished0, generator, proc0)``
    → (history [B*nb, num_steps + 1] int32, scores [B, nb])."""

    def fused(params, tok0, pos0, cache, scores, finished, generator=None, proc=None):
        history = torch.full((tok0.shape[0], num_steps + 1), gen.pad_token_id, dtype=torch.int32,
                             device=tok0.device)
        history[:, 0] = tok0
        tok, pos = tok0, pos0
        for i in range(num_steps):
            tok, cache, scores, finished, src, proc = beam_step(
                cfg, gen, params, tok, pos, cache, scores, finished, generator, proc)
            history = history.index_select(0, src)  # reorder past tokens too
            history[:, i + 1] = tok
            pos = pos + 1
        return history, scores

    return fused
