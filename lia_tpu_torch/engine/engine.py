"""Inference engine: bucketed prefill + decode loops
(port of ``lia_tpu/engine/engine.py``, resident single-device path).

Two decode drivers, as in the reference:

- **stepwise**: a Python loop that reads each token back to the host, records
  per-token wall-clock latency, streams tokens to ``on_token`` and stops early
  once every row has emitted EOS;
- **fused** (``fused=True``): the same decode steps with tokens, positions and
  cache lengths kept on the device; the host syncs once, at the end. It is the
  counterpart of the reference's on-device ``lax.scan``; capturing it as a CUDA
  graph is later work, and nothing in the loop (no ``.item()``, no host-side
  length) stands in the way of a capture.

Quantized weights come as an already-quantized tree (``quantize_params``,
``init_dummy_params(quant=...)``, a GPTQ checkpoint), as in the reference;
the engine fuses and places it.

A tiering :class:`RuntimeConfig` (``hbm_percentage < 100``, ``stream_weights``
or a policy other than 3) hands the tree to the tiered scheduler
(:class:`lia_tpu_torch.runtime.scheduler.StreamingScheduler`): the first
``hbm_percentage``% of layers go to the device, the rest stay in pinned host
memory and stream in layer by layer, and ``generate`` runs the scheduler's
stepwise loop (``fused`` is ignored there, as in the reference; ``on_token``
raises). Meshes, beam search, speculative decoding and the logits processors
are not ported yet; asking for any of them raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lia_tpu_torch.config import GenerationConfig, ModelConfig, RuntimeConfig, torch_dtype
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.utils.checkpoint import to_device
from lia_tpu_torch.utils.metrics import LatencyStats


def _needs_processors(gen: GenerationConfig) -> bool:
    """True when per-step logits processors (repetition penalty /
    min-new-tokens / no-repeat-ngram) must run."""
    return (
        gen.repetition_penalty != 1.0
        or (gen.min_new_tokens > 0 and gen.eos_token_id is not None)
        or gen.no_repeat_ngram_size > 0
    )


def bucket_length(n: int, minimum: int = 16) -> int:
    """Next power-of-two bucket."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pack_prompts(
    prompts: Sequence[Sequence[int]], pad_id: int, bucket: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts to a common bucket. Returns (tokens [B,S] int32, mask [B,S] bool).

    Left-padding makes every sequence end at the same slot, so decode writes to
    one cache position for the whole batch."""
    maxlen = max(len(p) for p in prompts)
    S = bucket or bucket_length(maxlen)
    B = len(prompts)
    tokens = np.full((B, S), pad_id, np.int32)
    mask = np.zeros((B, S), bool)
    for i, p in enumerate(prompts):
        tokens[i, S - len(p):] = np.asarray(p, np.int32)
        mask[i, S - len(p):] = True
    return tokens, mask


@dataclass
class GenerationResult:
    sequences: np.ndarray  # [B, num_generated] generated token ids
    latency: LatencyStats = field(default_factory=LatencyStats)

    def summary(self, batch: Optional[int] = None) -> Dict[str, float]:
        return self.latency.summary(batch or self.sequences.shape[0])


def _unsupported(runtime: RuntimeConfig) -> List[str]:
    default = RuntimeConfig()
    out = []
    if runtime.mesh_shape != default.mesh_shape:
        out.append("meshes")
    if not runtime.use_pallas:
        out.append("running without the kernels (use_pallas=False)")
    if runtime.quant.kv_cache_dtype not in ("none", "int8"):
        out.append(f"kv_cache_dtype={runtime.quant.kv_cache_dtype!r}")
    return out


class InferenceEngine:
    """Owns the device parameters (or the tiered scheduler) and the generation loops."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        runtime: RuntimeConfig = RuntimeConfig(),
        device=None,
    ):
        """``params``: a parameter tree of tensors and quantized records (e.g.
        ``init_dummy_params`` or ``params_from_jax``), moved to ``device``.
        ``device`` defaults to ``"cuda"``, and the engine raises when no GPU is
        present; tests pass ``device="cpu"``, where the kernels' plain versions
        run."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("InferenceEngine needs a CUDA device (pass device='cpu' to run on the CPU)")
            device = "cuda"
        missing = _unsupported(runtime)
        if missing:
            raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
        T.check_supported(cfg)
        self.cfg = cfg
        self.runtime = runtime
        self.device = torch.device(device)
        self.scheduler = None
        if runtime.fuse_projections:
            params = fuse_projections(cfg, params)
        if (runtime.hbm_percentage < 100 or runtime.stream_weights
                or runtime.prefill_policy != 3 or runtime.decode_policy != 3):
            from lia_tpu_torch.runtime.scheduler import StreamingScheduler

            self.scheduler = StreamingScheduler(cfg, runtime, params, self.device)
            self.params = self.scheduler.top  # embeddings, norms, head
        else:
            self.params = to_device(params, self.device)

    def _slot_bucket(self) -> int:
        """KV slot rounding, as the reference's (64 for bf16 KV, 128 for int8 KV),
        so caches convert one-to-one between the two packages."""
        return 128 if self.runtime.quant.kv_cache_dtype == "int8" else 64

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        gen: GenerationConfig = GenerationConfig(),
        fused: bool = False,
        seed: int = 0,
        on_token=None,
    ) -> GenerationResult:
        """Generate ``gen.max_new_tokens`` tokens per prompt. ``on_token``, if
        given, is called with the ``[B]`` int token array as each step completes
        (stepwise resident loop only)."""
        if on_token is not None and (fused or self.scheduler is not None):
            raise ValueError("on_token streaming needs the stepwise resident loop (fused=False, no tiered scheduler)")
        if gen.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        if _needs_processors(gen):
            raise NotImplementedError(
                "logits processors (repetition penalty, min_new_tokens, no_repeat_ngram) "
                "are not ported yet"
            )
        cfg, dev = self.cfg, self.device
        tokens_np, mask_np = pack_prompts(prompts, gen.pad_token_id)
        B, S = tokens_np.shape
        bucket = self._slot_bucket()
        max_len = -(-(S + gen.max_new_tokens) // bucket) * bucket
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        lat = LatencyStats()
        if self.scheduler is not None:
            return self.scheduler.generate(tokens_np, mask_np, gen, max_len, lat, generator)
        tokens = torch.from_numpy(tokens_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        cache = kvc.init_cache(
            cfg, B, max_len, torch_dtype(cfg.dtype),
            quantized=self.runtime.quant.kv_cache_dtype == "int8", device=dev,
        )

        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, self.params, tokens, mask, cache)
        first = sampling.sample(logits, gen, generator)
        first_host = first.cpu().numpy()
        lat.record(time.perf_counter() - t0)
        if on_token is not None:
            on_token(first_host)

        eos = gen.eos_token_id
        positions = mask.to(torch.int32).sum(dim=1)  # logical position of the next token
        finished = first == eos if eos is not None else torch.zeros(B, dtype=torch.bool, device=dev)
        n_steps = gen.max_new_tokens - 1

        def step(tok, pos, cache, finished):
            logits, cache = T.decode_step(cfg, self.params, tok[:, None], pos[:, None], cache)
            nxt = sampling.sample(logits, gen, generator)
            if eos is not None:
                nxt = torch.where(finished, torch.full_like(nxt, gen.pad_token_id), nxt)
                finished = finished | (nxt == eos)
            return nxt, cache, finished

        if fused:
            toks = torch.empty((B, n_steps), dtype=torch.int32, device=dev)
            tok = first
            t0 = time.perf_counter()
            for i in range(n_steps):
                tok, cache, finished = step(tok, positions + i, cache, finished)
                toks[:, i] = tok
            rest = toks.cpu().numpy()  # the loop's one host sync
            dt = time.perf_counter() - t0
            for _ in range(n_steps):
                lat.record(dt / max(n_steps, 1))
            return GenerationResult(np.concatenate([first_host[:, None], rest], axis=1), lat)

        out: List[np.ndarray] = [first_host]
        tok = first
        for i in range(n_steps):
            t0 = time.perf_counter()
            tok, cache, finished = step(tok, positions + i, cache, finished)
            out.append(tok.cpu().numpy())
            lat.record(time.perf_counter() - t0)
            if on_token is not None:
                on_token(out[-1])
            if eos is not None and bool(finished.all()):
                break
        return GenerationResult(np.stack(out, axis=1), lat)
