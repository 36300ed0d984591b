"""Token selection: greedy, temperature, top-k, top-p
(port of the per-step functions of ``lia_tpu/ops/sampling.py``).

Random draws take an explicit ``torch.Generator``. It gives other numbers than
``jax.random`` from the same seed, so the tests compare warped probabilities,
not draws. The logits processors (repetition penalty, min-new-tokens,
no-repeat-ngram) are not ported yet.
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


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens until cumulative prob exceeds p (always keep the top token)
    keep = torch.roll(cum < p, 1, dims=-1)
    keep[..., 0] = True
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


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
