"""Token selection: greedy, temperature, top-k, top-p, for a batch and per row,
and the logits processors (port of the per-step functions of
``lia_tpu/ops/sampling.py``).

Random draws take an explicit ``torch.Generator``. It gives other numbers than
``jax.random`` from the same seed, so the tests compare warped probabilities,
not draws. The processors (repetition penalty, min-new-tokens, no-repeat-ngram:
HF's LogitsProcessorList) run on the device with no host sync; their state is
a [B, V] token-presence mask and a [B, L] token history. Serving applies them
per row (:func:`process_logits_rows`, :func:`mark_seen`,
:func:`ban_tokens_rows`): each slot its own penalty and EOS suppression, and
no-repeat-ngram as ban lists the host computes from each slot's history.
"""

from __future__ import annotations

from typing import Optional

import torch

from lia_tpu_torch.config import GenerationConfig

NEG_INF = -1e30


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] → [B] int32 (first index among ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """``p``: a float, or a [B] tensor of per-row thresholds (serving)."""
    if isinstance(p, torch.Tensor) and p.ndim == 1:
        p = p[:, None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens until cumulative prob exceeds p (always keep the top token)
    keep = torch.roll(cum < p, 1, dims=-1)
    keep[..., 0] = True
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def apply_top_k_rows(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k ([B] int tensor; 0 = off) through a sorted-threshold gather."""
    V = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = desc.gather(1, (k.long() - 1).clamp(0, V - 1)[:, None])
    return torch.where((k > 0)[:, None] & (logits < kth), torch.full_like(logits, NEG_INF), logits)


def warp_logits_rows(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row temperature / top-k / top-p warp ([B] tensors each; top_k 0 and
    top_p 1.0 are off) of [B, V] logits, in fp32: serving's per-request
    sampling parameters."""
    x = logits.float() / temperature.clamp(min=1e-6)[:, None]
    return apply_top_p(apply_top_k_rows(x, top_k), top_p)


def sample_per_row(
    logits: torch.Tensor, generator: Optional[torch.Generator], temperature, top_k, top_p, greedy_row
) -> torch.Tensor:
    """Per-row sampling ([B] tensors of parameters and greedy flags) → [B] int32:
    greedy rows take the argmax, the others draw from their warped
    distribution with ``generator``."""
    probs = torch.softmax(warp_logits_rows(logits, temperature, top_k, top_p), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.where(greedy_row, greedy(logits), sampled)


def seen_from_prompt(tokens: torch.Tensor, mask: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, S] prompt (+ [B, S] validity) → [B, V] bool token-presence mask (the
    state RepetitionPenaltyLogitsProcessor derives from input_ids). Pads and ids
    outside the vocabulary land in a trash column, as the reference's scatter
    into a V+1-wide buffer."""
    B = tokens.shape[0]
    ids = tokens.long()
    safe = torch.where(mask & (ids >= 0) & (ids < vocab), ids, vocab)
    seen = torch.zeros((B, vocab + 1), dtype=torch.bool, device=tokens.device)
    seen.scatter_(1, safe, True)
    return seen[:, :vocab].contiguous()


def update_seen(seen: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Mark [B] freshly generated tokens as seen, in place."""
    seen[torch.arange(seen.shape[0], device=seen.device), tok.long()] = True
    return seen


def ban_repeated_ngrams(logits: torch.Tensor, history: torch.Tensor, cur_len: int, n: int) -> torch.Tensor:
    """HF NoRepeatNGramLogitsProcessor: ban (set to NEG_INF) every token that
    would complete an n-gram already present in ``history[:, :cur_len]``
    ([B, L] ids, prompt pads included as HF scans the raw ids). ``cur_len`` is
    a host int, so the step keeps no host sync. ``n == 1`` bans every token
    seen so far (HF's edge case)."""
    B, L = history.shape
    if L < n:
        return logits
    dev = history.device
    if n == 1:
        match = (torch.arange(L, device=dev) < cur_len)[None, :].expand(B, L)
        banned = history
    else:
        W = L - n + 1
        windows = torch.stack([history[:, i : W + i] for i in range(n - 1)], dim=-1)  # [B, W, n-1]
        st = min(max(cur_len - (n - 1), 0), L - (n - 1))  # clamped, as dynamic_slice
        tail = history[:, st : st + n - 1]  # the last n-1 tokens
        starts = torch.arange(W, device=dev)
        valid = starts + n - 1 < cur_len  # the window's completing token must exist
        match = (windows == tail[:, None, :]).all(dim=-1) & valid[None, :]
        banned = history[:, n - 1 :]  # history[:, starts + n - 1]
    V = logits.shape[-1]
    ids = banned.long()
    ids = torch.where((ids >= 0) & (ids < V), ids, V)  # out-of-range ids drop into a trash column
    fill = torch.where(match, NEG_INF, float("inf")).to(torch.float32)
    mask = torch.full((B, V + 1), float("inf"), dtype=torch.float32, device=dev)
    mask.scatter_reduce_(1, ids, fill, reduce="amin")
    return torch.where(mask[:, :V] <= NEG_INF, torch.full_like(logits, NEG_INF), logits)


def needs_processors(gen: GenerationConfig) -> bool:
    """True when per-step logits processors (repetition penalty /
    min-new-tokens / no-repeat-ngram) must run."""
    return (
        gen.repetition_penalty != 1.0
        or (gen.min_new_tokens > 0 and gen.eos_token_id is not None)
        or gen.no_repeat_ngram_size > 0
    )


def processor_state(tokens: torch.Tensor, mask: torch.Tensor, gen: GenerationConfig, vocab: int):
    """The processors' state for [B, S] prompts: the seen-token mask and the
    token history (the prompt, then room for every new token), or None when
    no processor is on."""
    if not needs_processors(gen):
        return None
    pad = torch.full((tokens.shape[0], gen.max_new_tokens), gen.pad_token_id, dtype=torch.int32,
                     device=tokens.device)
    return seen_from_prompt(tokens, mask, vocab), torch.cat([tokens.to(torch.int32), pad], dim=1)


def process_logits(
    logits: torch.Tensor,  # [B, V]
    gen: GenerationConfig,
    seen: Optional[torch.Tensor] = None,  # [B, V] bool token presence
    n_generated: Optional[int] = None,  # tokens already emitted this generation
    history: Optional[torch.Tensor] = None,  # [B, L] ids (no-repeat-ngram state)
    cur_len: Optional[int] = None,  # valid columns in history
) -> torch.Tensor:
    """Pre-warp logits processors (HF generate parity): repetition penalty,
    min-new-tokens EOS suppression and no-repeat-ngram, in that order."""
    if gen.repetition_penalty != 1.0 and seen is not None:
        x = logits.float()
        pen = torch.where(x > 0, x / gen.repetition_penalty, x * gen.repetition_penalty)
        logits = torch.where(seen, pen, x).to(logits.dtype)
    if gen.min_new_tokens > 0 and gen.eos_token_id is not None and n_generated is not None:
        if n_generated < gen.min_new_tokens:
            eos_col = torch.arange(logits.shape[-1], device=logits.device) == gen.eos_token_id
            logits = torch.where(eos_col, torch.full_like(logits, NEG_INF), logits)
    if gen.no_repeat_ngram_size > 0 and history is not None and cur_len is not None:
        logits = ban_repeated_ngrams(logits, history, cur_len, gen.no_repeat_ngram_size)
    return logits


def process_logits_rows(
    logits: torch.Tensor,  # [B, V]
    seen: torch.Tensor,  # [B, V] bool: each slot's prompt and generated tokens
    rep_penalty: torch.Tensor,  # [B] f32 (1.0 = off)
    suppress_eos: torch.Tensor,  # [B] bool: min_new_tokens not reached yet
    eos_token_id: Optional[int],
) -> torch.Tensor:
    """Per-row processors for continuous batching: each row its own repetition
    penalty and EOS suppression (the per-request form of
    :func:`process_logits`)."""
    x = logits.float()
    rep = rep_penalty.to(x.device, torch.float32)[:, None]
    pen = torch.where(x > 0, x / rep, x * rep)
    x = torch.where(seen & (rep != 1.0), pen, x)
    if eos_token_id is not None:
        eos_col = torch.arange(x.shape[-1], device=x.device)[None, :] == eos_token_id
        x = torch.where(eos_col & suppress_eos.to(x.device)[:, None], torch.full_like(x, NEG_INF), x)
    return x.to(logits.dtype)


def mark_seen(seen: torch.Tensor, toks: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Record [B] emitted tokens in the presence mask, in place; inactive rows
    keep theirs."""
    rows = torch.arange(seen.shape[0], device=seen.device)
    t = toks.long().to(seen.device)
    seen[rows, t] = seen[rows, t] | active.to(seen.device)
    return seen


def ban_tokens_rows(logits: torch.Tensor, banned: torch.Tensor) -> torch.Tensor:
    """Set each row's banned token ids ([B, K], -1 = none) to NEG_INF: serving's
    no-repeat-ngram, whose ban lists the host computes from each slot's
    un-padded history."""
    ids = banned.long().to(logits.device)
    V = logits.shape[-1]
    ids = torch.where((ids >= 0) & (ids < V), ids, V)  # unused entries drop into a trash column
    mask = torch.zeros((logits.shape[0], V + 1), dtype=torch.bool, device=logits.device)
    mask.scatter_(1, ids, True)
    return torch.where(mask[:, :V], torch.full_like(logits, NEG_INF), logits)


def warp_logits(logits: torch.Tensor, gen: GenerationConfig) -> torch.Tensor:
    """Temperature/top-k/top-p warp ([..., V] → [..., V] warped logits)."""
    x = logits / max(gen.temperature, 1e-6)
    if gen.top_k > 0:
        x = apply_top_k(x, gen.top_k)
    if gen.top_p < 1.0:
        x = apply_top_p(x, gen.top_p)
    return x


def warped_probs(logits: torch.Tensor, gen: GenerationConfig) -> torch.Tensor:
    """Normalized post-warp probabilities ([..., V], fp32)."""
    return torch.softmax(warp_logits(logits, gen).float(), dim=-1)


def sample(
    logits: torch.Tensor, gen: GenerationConfig, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """One sampling step honoring temperature/top-k/top-p. [B, V] → [B] int32."""
    if not gen.do_sample:
        return greedy(logits)
    probs = warped_probs(logits, gen)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
