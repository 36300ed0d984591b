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

The logits processors (repetition penalty, min-new-tokens, no-repeat-ngram)
run in both decode loops, as the reference's: stepwise records each token in
the processor state before the EOS pad replaces it, fused after.

:meth:`InferenceEngine.generate_beam` is beam search (:mod:`.beam`): grouped
by default (the prompt prefilled once per input into a shared cache, a
per-beam tail, only the tail reordered) or expanded (``grouped=False``: nb
rows a prompt, the whole cache reordered). :meth:`InferenceEngine.loglikelihood`
and :meth:`InferenceEngine.score` are lm-eval's scoring.

A tiering :class:`RuntimeConfig` (``hbm_percentage < 100``, ``stream_weights``
or a policy other than 3) hands the tree to the tiered scheduler
(:class:`lia_tpu_torch.runtime.scheduler.StreamingScheduler`): the first
``hbm_percentage``% of layers go to the device, the rest stay in pinned host
memory and stream in layer by layer, and ``generate`` runs the scheduler's
stepwise loop (``fused`` is ignored there, as in the reference; ``on_token``
raises); beam search and scoring run the scheduler's passes too. Meshes are
not ported yet; asking for one raises.

:meth:`InferenceEngine.generate_speculative` (prompt lookup) and
:meth:`InferenceEngine.generate_speculative_draft` (a draft model, greedy or
sampled) are speculative decoding (:mod:`.lookahead`), over the resident
slab cache or, for plans that keep KV on the card, the scheduler's verify
pass.
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


def needs_scheduler(runtime: RuntimeConfig) -> bool:
    """True when a runtime config tiers the weights or places a phase off the
    card, which the tiered scheduler runs."""
    return (runtime.hbm_percentage < 100 or runtime.stream_weights
            or runtime.prefill_policy != 3 or runtime.decode_policy != 3)


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
        if needs_scheduler(runtime):
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
            raise ValueError("use generate_beam() for num_beams > 1")
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
        proc = sampling.processor_state(tokens, mask, gen, cfg.vocab_size)

        def record(tok, cur_len):  # the processors' state takes the token (in place)
            if proc is not None:
                sampling.update_seen(proc[0], tok)
                proc[1][:, cur_len] = tok

        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, self.params, tokens, mask, cache)
        if proc is not None:
            logits = sampling.process_logits(logits, gen, proc[0], 0, history=proc[1], cur_len=S)
        first = sampling.sample(logits, gen, generator)
        record(first, S)
        first_host = first.cpu().numpy()
        lat.record(time.perf_counter() - t0)
        if on_token is not None:
            on_token(first_host)

        eos = gen.eos_token_id
        positions = mask.to(torch.int32).sum(dim=1)  # logical position of the next token
        finished = first == eos if eos is not None else torch.zeros(B, dtype=torch.bool, device=dev)
        n_steps = gen.max_new_tokens - 1

        def step(tok, i, cache, finished):
            logits, cache = T.decode_step(cfg, self.params, tok[:, None], (positions + i)[:, None], cache)
            if proc is not None:
                logits = sampling.process_logits(logits, gen, proc[0], i + 1, history=proc[1], cur_len=S + i + 1)
            nxt = sampling.sample(logits, gen, generator)
            if not fused:  # the reference's stepwise loop records the token before the EOS pad
                record(nxt, S + i + 1)
            if eos is not None:
                nxt = torch.where(finished, torch.full_like(nxt, gen.pad_token_id), nxt)
                finished = finished | (nxt == eos)
            if fused:  # its fused loop, after
                record(nxt, S + i + 1)
            return nxt, cache, finished

        if fused:
            toks = torch.empty((B, n_steps), dtype=torch.int32, device=dev)
            tok = first
            t0 = time.perf_counter()
            for i in range(n_steps):
                tok, cache, finished = step(tok, i, cache, finished)
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
            tok, cache, finished = step(tok, i, cache, finished)
            out.append(tok.cpu().numpy())
            lat.record(time.perf_counter() - t0)
            if on_token is not None:
                on_token(out[-1])
            if eos is not None and bool(finished.all()):
                break
        return GenerationResult(np.stack(out, axis=1), lat)

    # -- speculative decoding ----------------------------------------------------

    @torch.inference_mode()
    def generate_speculative(
        self,
        prompts: Sequence[Sequence[int]],
        gen: GenerationConfig = GenerationConfig(),
        ngram: int = 3,
        k: int = 4,
    ):
        """Greedy generation with prompt-lookup speculation
        (:mod:`lia_tpu_torch.engine.lookahead`). Returns ``(sequences,
        n_verify_steps)``: the sequences equal :meth:`generate`'s greedy
        output, and the steps fall below ``max_new_tokens`` wherever the n-gram
        proposals land (repetitive or retrieval-heavy text). Under the tiered
        scheduler each verify streams every layer's weights once for k + 1
        candidates."""
        from lia_tpu_torch.engine.lookahead import generate_prompt_lookup

        return generate_prompt_lookup(self, prompts, gen, ngram=ngram, k=k)

    @torch.inference_mode()
    def generate_speculative_draft(
        self,
        draft_engine: "InferenceEngine",
        prompts: Sequence[Sequence[int]],
        gen: GenerationConfig = GenerationConfig(),
        k: int = 4,
        seed: int = 0,
    ):
        """Generation with a draft model (a resident engine over the same
        vocabulary, e.g. opt-125m for opt-6.7b) proposing k tokens per verify
        pass. Greedy requests are exact, as prompt lookup's; ``gen.do_sample``
        runs Leviathan acceptance sampling, whose output is distributed as
        plain target sampling, every draw from a generator seeded with
        ``seed``. Returns ``(sequences, n_verify_steps)``."""
        from lia_tpu_torch.engine import lookahead as la

        if gen.do_sample:
            return la.generate_draft_speculative_sampled(self, draft_engine, prompts, gen, k=k, seed=seed)
        return la.generate_draft_speculative(self, draft_engine, prompts, gen, k=k)

    # -- beam search -----------------------------------------------------------

    def _beam_proc(self, tokens: np.ndarray, mask: np.ndarray, gen: GenerationConfig):
        """Per-beam processor state for beam_select, (seen, history, cur_len,
        n_generated) over [B*nb, S] prompts, or None."""
        state = sampling.processor_state(torch.from_numpy(tokens).to(self.device),
                                         torch.from_numpy(mask).to(self.device), gen, self.cfg.vocab_size)
        return None if state is None else (*state, tokens.shape[1], 0)

    def _sync(self) -> None:
        """Wait for the card (a stepwise loop's per-token latency)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate_beam(
        self,
        prompts: Sequence[Sequence[int]],
        gen: GenerationConfig,
        seed: int = 0,
        grouped: Optional[bool] = None,
    ) -> GenerationResult:
        """Beam-search generation (the reference's _beam_search with its beam_idx
        KV reorder). Returns the best beam per prompt.

        ``grouped`` (the default) prefills each prompt ONCE, at B0 rows into
        ``ceil(S/128)*128`` slots, into the shared prompt of a
        :class:`~lia_tpu_torch.ops.kv_cache.BeamKVCache`; the beams' generated
        tokens go into per-beam tails, and the per-step shuffle gathers only
        the tails. ``grouped=False`` is the expanded path (nb rows a prompt,
        the whole cache gathered each step), token for token the same. Under
        the tiered scheduler the grouped path needs plans that keep KV on the
        card; host-KV plans take the expanded path, as in the reference. The
        resident decode runs on the device and syncs with the host once;
        ``gen.do_sample`` draws the Gumbel noise from a generator seeded with
        ``seed``."""
        from lia_tpu_torch.engine import beam as beam_mod

        nb = gen.num_beams
        if nb < 1:
            raise ValueError(f"num_beams must be >= 1, got {nb}")
        cfg, dev = self.cfg, self.device
        grouped = True if grouped is None else grouped
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        lat = LatencyStats()
        if self.scheduler is not None:
            return self._generate_beam_scheduled(prompts, gen, lat, generator,
                                                 grouped and self.scheduler.grouped_beam_ok)
        tokens_np, mask_np, etokens, emask, max_len = self._beam_prompts(prompts, gen, grouped)
        B = len(prompts)
        cache = kvc.init_cache(cfg, tokens_np.shape[0], max_len, torch_dtype(cfg.dtype),
                               quantized=self.runtime.quant.kv_cache_dtype == "int8", device=dev)
        proc = self._beam_proc(etokens, emask, gen)

        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, self.params, torch.from_numpy(tokens_np).to(dev),
                                  torch.from_numpy(mask_np).to(dev), cache)
        if grouped:
            cache = kvc.beam_cache_from_prefill(cache, nb, gen.max_new_tokens)
            logits = logits.repeat_interleave(nb, dim=0)  # [B*nb, V] identical beam rows
        # the first expansion, from the prompt's last token; as the reference's
        # resident path, it does not divide by the temperature
        scores, finished = beam_mod.init_beam_state(B, nb, dev)
        first, scores, finished, src = beam_mod.beam_select(
            gen.replace(temperature=1.0), cfg.vocab_size, logits, scores, finished, generator, proc)
        if not grouped:
            # grouped: the tail is still empty and the prompt is shared per
            # group, so the first expansion needs no cache shuffle
            kvc.beam_reorder(cache, src)
        proc = beam_mod.reorder_proc(proc, src, first)
        self._sync()
        lat.record(time.perf_counter() - t0)

        decoder = beam_mod.make_beam_decoder(cfg, gen, gen.max_new_tokens - 1)
        positions = torch.from_numpy(emask.sum(1).astype(np.int32)).to(dev)  # [B*nb]
        t0 = time.perf_counter()
        history, scores = decoder(self.params, first, positions, cache, scores, finished, generator, proc)
        history = history.cpu().numpy().reshape(B, nb, -1)  # the loop's one host sync
        dt = time.perf_counter() - t0
        for _ in range(gen.max_new_tokens - 1):
            lat.record(dt / max(gen.max_new_tokens - 1, 1))
        return GenerationResult(beam_mod.select_best(history, scores.cpu().numpy(), gen), lat)

    def _beam_prompts(self, prompts, gen: GenerationConfig, grouped: bool):
        """Packed prompts for beam search: grouped, one row a prompt and
        ``ceil(S/128)*128`` prompt slots; expanded, nb rows a prompt and the
        slot bucket over prompt + new tokens. Returns (tokens, mask, the
        [B*nb, S] tokens and mask of the beam rows, cache slots)."""
        nb = gen.num_beams
        if grouped:
            tokens, mask = pack_prompts(prompts, gen.pad_token_id)
            S = tokens.shape[1]
            return tokens, mask, np.repeat(tokens, nb, axis=0), np.repeat(mask, nb, axis=0), -(-S // 128) * 128
        tokens, mask = pack_prompts([p for p in prompts for _ in range(nb)], gen.pad_token_id)
        bucket = self._slot_bucket()
        return tokens, mask, tokens, mask, -(-(tokens.shape[1] + gen.max_new_tokens) // bucket) * bucket

    def _generate_beam_scheduled(self, prompts, gen: GenerationConfig, lat: LatencyStats,
                                 generator: torch.Generator, grouped: bool) -> GenerationResult:
        """Stepwise beam search over the scheduler's passes. Grouped: prefill at
        B0 rows, both segment caches become beam caches, and each step's
        shuffle gathers only their tails (``decode_pass_beam``,
        ``reorder_state_beam``); expanded: prefill at B0*nb rows and the whole
        of both caches gathered each step (``decode_pass``, ``reorder_state``),
        the host cache included. The token history stays on the device."""
        from lia_tpu_torch.engine import beam as beam_mod

        cfg, dev, sched = self.cfg, self.device, self.scheduler
        nb = gen.num_beams
        tokens, mask, etokens, emask, max_len = self._beam_prompts(prompts, gen, grouped)
        B = len(prompts)
        proc = self._beam_proc(etokens, emask, gen)

        def select(logits, scores, finished, proc):
            return beam_mod.beam_select(gen, cfg.vocab_size, logits, scores, finished, generator, proc)

        t0 = time.perf_counter()
        logits, state = sched.prefill_pass(tokens, mask, max_len)
        if grouped:
            state = sched.beam_state_from_prefill(state, nb, gen.max_new_tokens)
            logits = logits.repeat_interleave(nb, dim=0)
        scores, finished = beam_mod.init_beam_state(B, nb, dev)
        tok, scores, finished, src = select(logits, scores, finished, proc)
        if not grouped:
            state = sched.reorder_state(state, src)
        proc = beam_mod.reorder_proc(proc, src, tok)
        history = torch.full((B * nb, gen.max_new_tokens), gen.pad_token_id, dtype=torch.int32, device=dev)
        history[:, 0] = tok
        self._sync()
        lat.record(time.perf_counter() - t0)

        decode = sched.decode_pass_beam if grouped else sched.decode_pass
        reorder = sched.reorder_state_beam if grouped else sched.reorder_state
        pos = torch.from_numpy(emask.sum(1).astype(np.int32)).to(dev)
        for i in range(gen.max_new_tokens - 1):
            t0 = time.perf_counter()
            logits, state = decode(tok, pos, state)
            tok, scores, finished, src = select(logits, scores, finished, proc)
            state = reorder(state, src)
            proc = beam_mod.reorder_proc(proc, src, tok)
            history = history.index_select(0, src)
            history[:, i + 1] = tok
            self._sync()
            lat.record(time.perf_counter() - t0)
            pos = pos + 1
        seqs = beam_mod.select_best(history.cpu().numpy().reshape(B, nb, -1), scores.cpu().numpy(), gen)
        return GenerationResult(seqs, lat)

    # -- scoring (the accuracy harness) ------------------------------------------

    def _logprob_matrix(self, tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Per-position next-token log-probs [B, S, V] fp32 on the engine's
        device: the resident pass over a bf16 cache of S slots, or the
        scheduler's streamed scoring pass."""
        B, S = tokens.shape
        if self.scheduler is not None:
            return self.scheduler.score_logprobs(tokens, mask, S)
        cache = kvc.init_cache(self.cfg, B, S, torch_dtype(self.cfg.dtype), device=self.device)
        return T.score_logprobs(self.cfg, self.params, torch.from_numpy(tokens).to(self.device),
                                torch.from_numpy(mask).to(self.device), cache)

    def loglikelihood(
        self,
        contexts: Sequence[Sequence[int]],
        continuations: Sequence[Sequence[int]],
        pad_id: Optional[int] = None,
    ) -> np.ndarray:
        """Summed log-prob of each continuation given its context (lm-eval
        ``loglikelihood``). Returns [B] float64; raises on a record with nothing
        to score. Works under every placement policy."""
        for b, (c, t) in enumerate(zip(contexts, continuations)):
            if len(t) == 0:
                raise ValueError(f"record {b}: empty continuation")
            if len(c) == 0 and len(t) == 1:
                # one unconditioned token has no previous position to score from
                raise ValueError(f"record {b}: empty context with single-token continuation cannot be scored "
                                 "(no conditioning position)")
        return self.score(contexts, continuations, pad_id=pad_id)[0]

    @torch.inference_mode()
    def score(
        self,
        contexts: Sequence[Sequence[int]],
        continuations: Sequence[Sequence[int]],
        pad_id: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """lm-eval ``loglikelihood`` semantics: (summed log-prob, is_greedy) per
        record; ``is_greedy`` is True when every continuation token is the
        argmax next-token prediction. The log-probs of the continuation tokens
        and the argmax at their positions are picked on the device, so only
        those cross to the host (not [B, S, V] fp32); the sums then run in
        float64 in the reference's order."""
        pad_id = self.cfg.pad_token_id if pad_id is None else pad_id
        full = [list(c) + list(t) for c, t in zip(contexts, continuations)]
        tokens, mask = pack_prompts(full, pad_id)
        B, S = tokens.shape
        # (record, scoring position, token) of every scorable continuation token;
        # continuations are right-aligned, token j of t at slot S - len(t) + j
        picks = [(b, S - len(t) + j - 1, tok) for b, t in enumerate(continuations) for j, tok in enumerate(t)
                 if S - len(t) + j >= 1]  # an empty context's first token has no position to score from
        ll, greedy = np.zeros(B, np.float64), np.ones(B, bool)
        if not picks:
            return ll, greedy
        lp = self._logprob_matrix(tokens, mask)
        rows, cols, toks = (torch.tensor(x, device=lp.device) for x in zip(*picks))
        at = lp[rows, cols]  # [n, V]
        picked = at.gather(1, toks[:, None])[:, 0].cpu().numpy()
        top = at.argmax(dim=-1).cpu().numpy()
        for (b, _, tok), v, t in zip(picks, picked, top):
            ll[b] += v
            greedy[b] &= int(t) == int(tok)
        return ll, greedy
