"""Continuous batching: slot-based serving over a ragged or paged KV cache
(port of ``lia_tpu/engine/serving.py``, resident weights on one device).

A fixed decode step over ``max_batch`` slots in which every slot carries its
own cache length; a finished request frees its slot at once, and a waiting one
is admitted by prefilling it alone and splicing its KV into the free slot.
Two storages, as in the reference:

- **slab** (bf16 or int8 KV): one ``[L, max_batch, N_kv, max_len, D]`` cache;
  admission prefills into a one-row cache and copies it into the slot
  (:func:`lia_tpu_torch.ops.kv_cache.insert_slot`); decode is
  :func:`lia_tpu_torch.models.transformer.decode_step_ragged` (the fresh-merge
  decode kernels with per-row lengths);
- **paged**: a shared ``[L, num_blocks, N_kv, block_size, D]`` pool with a
  block table per slot, pages allocated at admission for the whole request
  and freed when it finishes; decode walks the table inside the
  ``paged_decode_attention`` kernel
  (:func:`lia_tpu_torch.ops.paged.decode_step_paged`). Automatic prefix
  caching: full prompt blocks register under their token prefix, finished
  requests' pages stay cached (refcount 0) until the pool reclaims them
  (FIFO), and an admission whose prefix hits seeds its KV from the shared
  pages and runs only the suffix through ``flash_attention_cached``.

``prefill_chunk`` admits at most one chunk of a prompt per engine step, so
running requests keep decoding while a long prompt prefills; ``fused_steps``
decodes up to that many tokens per dispatch when no chunked admission is in
flight: the steps run back to back with the tokens, positions and lengths on
the device, and the host syncs once at the end of the block, as the
reference's fused ``lax.scan`` does. Per-request sampling parameters and stop
tokens ride every path.

The logits processors (``enable_processors``, or processor defaults in
``gen``) take per-request repetition penalty, min-new-tokens and
no-repeat-ngram size: a [B, V] token-presence mask on the device, set at
admission from the prompt and the first token and updated every step, and
per-slot penalties and EOS suppression
(:func:`lia_tpu_torch.ops.sampling.process_logits_rows`); the n-gram ban lists
are computed on the host from each slot's un-padded prompt and output
(:func:`lia_tpu_torch.ops.sampling.ban_tokens_rows`). Repetition penalty and
min-new-tokens ride fused blocks (the mask updated on the device each step);
an active slot with an n-gram size keeps the per-step path.

With a tiering ``runtime`` (:func:`lia_tpu_torch.engine.engine.needs_scheduler`)
every pass goes through the tiered scheduler
(:class:`lia_tpu_torch.runtime.scheduler.StreamingScheduler`): admission is
its streamed prefill, decode its ragged pass over the {resident, streamed}
cache pair under any placement policy, or its paged pass over one pool for
all layers (plans that keep KV on the card), one step a dispatch.

The host holds the slot bookkeeping (block tables, lengths, refcounts) in numpy,
as the reference does, and uploads what a step needs; every cache and pool
write is in place on the device. Each decode step reads its tokens back to
the host once (a fused block once per block). ``device=None`` means ``"cuda"``
and the constructor raises without a GPU; the tests pass ``device="cpu"``,
where the kernels' plain versions run.

``speculate_k`` makes every engine step speculative
(:mod:`lia_tpu_torch.engine.lookahead`): each active slot proposes k tokens,
by prompt lookup over its own history (``speculate_ngram``) or by k + 1
decode steps of a ``draft`` model over the draft's own ragged slab cache,
and one chunked verify pass checks all k + 1 positions of every slot: over
the slab cache through ``flash_attention_cached`` at per-row bases
(:func:`lia_tpu_torch.models.transformer.verify_chunk`), over the paged pool
through ``paged_decode_attention`` at k + 1 queries
(:func:`lia_tpu_torch.ops.paged.verify_step_paged`). Greedy requests accept
the longest argmax-matching prefix and the bonus token (exact); with
``gen.do_sample`` proposals are accepted by the Leviathan rule under the
engine-level warp (per-request sampling overrides are refused). Every
admission reserves k + 1 slots of slack; the lengths advance by the accepted
count only, and the draft's cache is rewound to the verified prefix.

Refused as the reference refuses them: speculation with the logits
processors, ``prefill_chunk`` over the scheduler, paged or speculative serving
over host-placement plans (no paged or chunk host kernel), paged over the
scheduler with speculation, and paged pools with int8 KV (the reference keeps
its pools in the model's dtype). Tensor-parallel meshes are not ported yet
(ROADMAP A13).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from lia_tpu_torch.config import GenerationConfig, ModelConfig, RuntimeConfig, torch_dtype
from lia_tpu_torch.engine.engine import bucket_length, needs_scheduler, pack_prompts
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import paged as pg
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.ops.fuse import fuse_projections
from lia_tpu_torch.utils.checkpoint import to_device


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    # per-request sampling params; None → the engine's GenerationConfig
    do_sample: Optional[bool] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    stop_token_ids: Optional[List[int]] = None  # extra per-request stops
    repetition_penalty: Optional[float] = None  # these three need the processors on
    min_new_tokens: Optional[int] = None
    no_repeat_ngram_size: Optional[int] = None
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.first_token_at is None else self.first_token_at - self.submitted_at


class ContinuousBatcher:
    """Slot-based continuous batching engine (one device; resident weights or the tiered scheduler)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        max_batch: int = 8,
        max_len: int = 512,
        gen: GenerationConfig = GenerationConfig(),
        kv_quantized: bool = False,
        mesh=None,
        runtime: Optional[RuntimeConfig] = None,
        paged: bool = False,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        fused_steps: int = 1,
        enable_processors: Optional[bool] = None,
        speculate_k: Optional[int] = None,
        speculate_ngram: int = 3,
        draft: Optional[tuple] = None,  # (draft ModelConfig, draft params)
        prefix_cache: bool = True,  # paged mode: automatic prefix caching (the A/B knob)
        device=None,
    ):
        """``params``: a parameter tree (e.g. ``device_dummy_params`` or
        ``params_from_jax``); it is fused (unless ``runtime.fuse_projections``
        is off) and moved to ``device``, or, with a tiering ``runtime``,
        handed to the tiered scheduler, which keeps the streamed layers in
        host memory. The other arguments are the reference's; see the module
        docstring for what each mode does."""
        if mesh is not None:
            raise NotImplementedError("serving over a tensor-parallel mesh is not ported yet (ROADMAP A13)")
        if draft is not None and speculate_k is None:
            raise ValueError("draft serving requires speculate_k")
        if enable_processors is None:
            enable_processors = sampling.needs_processors(gen)
        if enable_processors and speculate_k is not None:
            raise NotImplementedError("speculation does not compose with logits processors")
        if paged and kv_quantized:
            raise NotImplementedError("paged pools store the model's dtype; int8-KV paged is not a format "
                                      "of the reference")
        if fused_steps < 1:
            raise ValueError("fused_steps must be >= 1")
        T.check_supported(cfg)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ContinuousBatcher needs a CUDA device (pass device='cpu' to run on the CPU)")
            device = "cuda"
        self.device = dev = torch.device(device)
        self.cfg = cfg
        self.gen = gen
        self.B = max_batch
        self.max_len = max_len
        if runtime is None or runtime.fuse_projections:
            params = fuse_projections(cfg, params)
        self.sched = None
        if runtime is not None and needs_scheduler(runtime):
            from lia_tpu_torch.engine.lookahead import HOST_PLANS
            from lia_tpu_torch.runtime.scheduler import PAGED_HOST_PLANS, StreamingScheduler

            if prefill_chunk is not None:
                raise ValueError("prefill_chunk composes with resident serving only: the scheduler's streamed "
                                 "prefill would stream every layer's weights again for each chunk")
            self.sched = StreamingScheduler(cfg, runtime, params, dev)
            if paged:
                if not self.sched.tpu_kv_plans:
                    raise NotImplementedError(PAGED_HOST_PLANS)
                if speculate_k is not None:
                    raise NotImplementedError("speculative paged serving over the scheduler: the tiered verify "
                                              "pass reads the slab segment caches, not the pool")
                if runtime.quant.kv_cache_dtype == "int8":
                    raise NotImplementedError("paged pools store the model's dtype; int8-KV paged is not a "
                                              "format of the reference")
            if speculate_k is not None and not self.sched.tpu_kv_plans:
                raise NotImplementedError(HOST_PLANS)
            self.params = self.sched.top  # embeddings, norms, head
            # the paged pool replaces the slab serving state
            self.state = None if paged else self.sched.init_serving_state(max_batch, max_len)
        else:
            self.params = to_device(params, dev)
        dtype = torch_dtype(cfg.dtype)
        self.paged = paged
        self.cache = None  # the resident slab's (the scheduler keeps its own state)
        if paged:
            self.block_size = block_size
            # default pool: enough pages for every slot at max_len, + the null page
            nb = num_blocks or (max_batch * -(-max_len // block_size) + 1)
            self.num_blocks = nb
            shape = (cfg.num_layers, nb, cfg.num_kv_heads, block_size, cfg.head_dim)
            self.k_pool = torch.zeros(shape, dtype=dtype, device=dev)
            self.v_pool = torch.zeros(shape, dtype=dtype, device=dev)
            self.free_blocks = list(range(nb - 1, 0, -1))  # block 0 = null page
            # automatic prefix caching: full prompt blocks register under their
            # token prefix; pages stay cached after their request finishes
            # (refcount 0) until the pool needs them back (FIFO eviction)
            self.page_rc = np.zeros(nb, np.int64)
            self.prefix_map: Dict[Any, int] = {}  # token prefix -> page id
            self.page_key: Dict[int, Any] = {}  # page id -> token prefix
            self.cached_pages: Dict[int, None] = {}  # insertion-ordered (FIFO)
            # an admission over the scheduler is its streamed prefill, which has
            # no suffix-chunk form: no prefix reuse there
            self.prefix_cache = prefix_cache and self.sched is None
            self.prefix_hits = 0
            self.prefix_tokens_reused = 0
            self.max_pages = -(-max_len // block_size)
            self.block_table = np.zeros((max_batch, self.max_pages), np.int32)
            self.kv_lengths = np.zeros(max_batch, np.int32)
        elif self.sched is None:
            cache = kvc.init_cache(cfg, max_batch, max_len, dtype, quantized=kv_quantized, device=dev)
            self.cache = cache._replace(length=torch.zeros(max_batch, dtype=torch.int32, device=dev))
        self.kv_quantized = kv_quantized
        self.logical_pos = np.zeros(max_batch, np.int64)
        self.active = np.zeros(max_batch, bool)
        # per-slot sampling params (engine defaults until a request lands)
        self.s_temp = np.full(max_batch, gen.temperature, np.float32)
        self.s_topk = np.full(max_batch, gen.top_k, np.int32)
        self.s_topp = np.full(max_batch, gen.top_p, np.float32)
        self.s_greedy = np.full(max_batch, not gen.do_sample, bool)
        self._s_dev = None  # device copies of the slot params, made when they change
        # logits processors: each slot's token-presence mask on the device, and
        # its penalty, min-new-tokens and n-gram size (engine defaults until a
        # request lands)
        self.use_processors = enable_processors
        if enable_processors:
            self.seen = torch.zeros((max_batch, cfg.vocab_size), dtype=torch.bool, device=dev)
            self.s_rep = np.full(max_batch, gen.repetition_penalty, np.float32)
            self.s_minnew = np.full(max_batch, gen.min_new_tokens, np.int32)
            self.s_ngram = np.full(max_batch, gen.no_repeat_ngram_size, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.tokens = np.full(max_batch, gen.pad_token_id, np.int32)
        # speculation: k proposals a slot (prompt lookup or the draft) and one
        # verify pass a step; the draft keeps its own ragged slab cache, each
        # slot holding its history but the pending token
        self.speculate_k = speculate_k
        self.speculate_ngram = speculate_ngram
        self.draft = draft
        if draft is not None:
            self.dcfg, dparams = draft
            T.check_supported(self.dcfg)
            if runtime is None or runtime.fuse_projections:
                dparams = fuse_projections(self.dcfg, dparams)
            self.dparams = to_device(dparams, dev)
            dcache = kvc.init_cache(self.dcfg, max_batch, max_len, torch_dtype(self.dcfg.dtype), device=dev)
            self.dcache = dcache._replace(length=torch.zeros(max_batch, dtype=torch.int32, device=dev))
            self.dlen = np.zeros(max_batch, np.int32)  # the draft cache's lengths, on the host
        self.prefill_chunk = prefill_chunk
        self._pending = None  # in-flight chunked admission
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self._next_id = 0
        self._rng = torch.Generator(device=dev)
        self._rng.manual_seed(0)
        self._steps = 0
        self._dispatches = 0  # decode dispatches (a fused block counts once)
        self.fused_steps = fused_steps

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- paged-pool allocation / prefix cache ----------------------------------

    def _alloc_page(self) -> Optional[int]:
        """One free page, evicting the oldest rc==0 cached page if needed."""
        if self.free_blocks:
            return self.free_blocks.pop()
        if self.cached_pages:
            page = next(iter(self.cached_pages))  # oldest insertion (FIFO)
            del self.cached_pages[page]
            key = self.page_key.pop(page, None)
            if key is not None:
                self.prefix_map.pop(key, None)
            return page
        return None

    def _allocatable(self) -> int:
        return len(self.free_blocks) + len(self.cached_pages)

    def _prefix_chain_keys(self, prompt: List[int]) -> List[Any]:
        bs = self.block_size
        return [tuple(prompt[: (i + 1) * bs]) for i in range(len(prompt) // bs)]

    def _prefix_lookup(self, prompt: List[int]):
        """Longest cached full-block chain for this prompt → (pages, n_tokens)."""
        pages: List[int] = []
        for key in self._prefix_chain_keys(prompt):
            page = self.prefix_map.get(key)
            if page is None:
                break
            pages.append(page)
        return pages, len(pages) * self.block_size

    def _claim_page(self, page: int) -> None:
        self.page_rc[page] += 1
        self.cached_pages.pop(page, None)  # active again: not evictable

    def _release_pages(self, pages) -> None:
        for b in pages:
            b = int(b)
            if b == 0:
                continue
            self.page_rc[b] -= 1
            if self.page_rc[b] > 0:
                continue
            if b in self.page_key:  # a registered prefix block stays cached
                self.cached_pages[b] = None
            else:
                self.free_blocks.append(b)

    def _register_prefix(self, prompt: List[int], row: np.ndarray) -> None:
        for i, key in enumerate(self._prefix_chain_keys(prompt)):
            page = int(row[i])
            if key not in self.prefix_map:
                self.prefix_map[key] = page
                self.page_key[page] = key

    def _paged_admission_plan(self, req: Request, span_of):
        """Reserve pages for one admission, reusing the cached prefix chain.

        ``span_of(suffix_len)`` maps the uncached suffix length to the span the
        admission recomputes (the chunk covers [n - span, n) with real tokens
        only: extending down keeps cache validity contiguous). Returns ``(row,
        chain, base, n_shared, n_seed)``, or None when the pool is short of
        pages (the caller requeues)."""
        n = len(req.prompt)
        bs_pg = self.block_size
        n_pages = -(-(n + req.max_new_tokens + self._slack()) // bs_pg)
        if self.prefix_cache:
            chain, reused = self._prefix_lookup(req.prompt)
        else:
            chain, reused = [], 0
        reused = min(reused, n - 1)  # at least one token must produce logits
        base = 0
        if reused > 0:
            span = span_of(n - reused)
            if n - span >= bs_pg:  # at least one full shared block
                base = n - span
        n_shared = base // bs_pg  # full blocks this request shares
        n_seed = -(-base // bs_pg)  # chain pages the seed reads
        n_fresh = n_pages - n_shared
        cached_chain = sum(1 for p in chain[:n_seed] if p in self.cached_pages)
        if self._allocatable() - cached_chain < n_fresh:
            return None
        for p in chain[:n_seed]:  # pin before eviction can touch them
            self._claim_page(p)
        fresh = [self._alloc_page() for _ in range(n_fresh)]
        row = np.zeros(self.max_pages, np.int32)
        row[:n_pages] = chain[:n_shared] + fresh
        for p in fresh:
            self.page_rc[p] += 1
        return row, chain, base, n_shared, n_seed

    def _paged_seed(self, chain: List[int], base: int, n_seed: int, bucket: int) -> kvc.KVCache:
        """The prefix-cache seed: a one-row cache of ``bucket`` slots whose first
        ``base`` hold the KV of the shared pages."""
        seed_row = np.zeros(self.max_pages, np.int32)
        seed_row[:n_seed] = chain[:n_seed]
        return pg.seed_prefix_cache(self.k_pool, self.v_pool, self._dev(seed_row), base, bucket)

    def _paged_commit(self, req, slot, seg, row, chain, base, n_shared, n_seed, pad) -> None:
        """Write a finished prompt's KV into its pages and register the prefix.

        Prefix-cache admissions (base > 0) write [n_shared * bs, n) straight
        from the seg (slot 0 is position 0); full prefills arrive left-padded
        and are read from slot ``pad``."""
        n = len(req.prompt)
        if base > 0:
            write_start = n_shared * self.block_size
            self.prefix_hits += 1
            self.prefix_tokens_reused += base
        else:
            write_start = 0
        pg.write_prompt_all_layers(
            self.k_pool, self.v_pool, seg.k[:, 0, :, pad:], seg.v[:, 0, :, pad:], self._dev(row), n, write_start
        )
        self._release_pages(chain[n_shared:n_seed])  # the boundary page the seed read
        if self.prefix_cache:
            self._register_prefix(req.prompt, row)
        self.block_table[slot] = row
        self.kv_lengths[slot] = n

    # -- API ------------------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        do_sample: Optional[bool] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop_token_ids: Optional[Sequence[int]] = None,
        repetition_penalty: Optional[float] = None,
        min_new_tokens: Optional[int] = None,
        no_repeat_ngram_size: Optional[int] = None,
    ) -> int:
        """Queue a request. Sampling kwargs override the engine's
        GenerationConfig for this request (greedy and sampled requests decode
        together: :func:`lia_tpu_torch.ops.sampling.sample_per_row`)."""
        if (repetition_penalty is not None or min_new_tokens is not None
                or no_repeat_ngram_size is not None) and not self.use_processors:
            raise ValueError(
                "per-request repetition_penalty/min_new_tokens/no_repeat_ngram_size need the batcher built "
                "with enable_processors=True (or processor defaults in gen)"
            )
        if self.speculate_k is not None and any(x is not None for x in (do_sample, temperature, top_k, top_p)):
            raise ValueError(
                "speculative serving samples under the engine-level warp (one p/q warp a verify pass); "
                "per-request sampling overrides do not compose"
            )
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(
            rid, list(prompt), max_new_tokens or self.gen.max_new_tokens,
            do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p,
            stop_token_ids=list(stop_token_ids) if stop_token_ids else None,
            repetition_penalty=repetition_penalty, min_new_tokens=min_new_tokens,
            no_repeat_ngram_size=no_repeat_ngram_size,
        ))
        return rid

    # -- per-slot sampling ------------------------------------------------------

    def _slot_sampling(self, slot: int, req: Request) -> None:
        g = self.gen
        ds = g.do_sample if req.do_sample is None else req.do_sample
        self.s_greedy[slot] = not ds
        self.s_temp[slot] = g.temperature if req.temperature is None else req.temperature
        self.s_topk[slot] = g.top_k if req.top_k is None else req.top_k
        self.s_topp[slot] = g.top_p if req.top_p is None else req.top_p
        if self.use_processors:
            self.s_rep[slot], self.s_minnew[slot], self.s_ngram[slot] = self._req_processors(req)
        self._s_dev = None

    def _req_processors(self, req: Request):
        """(repetition penalty, min_new_tokens, n-gram size) of a request."""
        g = self.gen
        return (g.repetition_penalty if req.repetition_penalty is None else req.repetition_penalty,
                g.min_new_tokens if req.min_new_tokens is None else req.min_new_tokens,
                g.no_repeat_ngram_size if req.no_repeat_ngram_size is None else req.no_repeat_ngram_size)

    def _activate_slot(self, slot: int, req: Request, first: int) -> None:
        """Common admission tail: record the first token and bring the slot up."""
        req.first_token_at = time.perf_counter()
        req.output.append(first)
        self.slot_req[slot] = req
        self.active[slot] = True
        self._slot_sampling(slot, req)
        if self.use_processors:
            self.seen[slot].copy_(torch.from_numpy(self._prompt_seen(req, first)))
        self.tokens[slot] = first
        self.logical_pos[slot] = len(req.prompt)
        self._maybe_finish(slot, first)

    def _slot_params(self):
        if self._s_dev is None:  # re-upload only when a slot's params changed
            self._s_dev = tuple(self._dev(a) for a in (self.s_temp, self.s_topk, self.s_topp, self.s_greedy))
        return self._s_dev

    def _prompt_seen(self, req: Request, first: Optional[int] = None) -> np.ndarray:
        """A request's [V] presence row: its prompt, and ``first`` if given."""
        row = np.zeros(self.cfg.vocab_size, bool)
        row[np.asarray(req.prompt, np.int64)] = True
        if first is not None:
            row[first] = True
        return row

    @staticmethod
    def _ngram_bans(seq: List[int], n: int) -> List[int]:
        """HF NoRepeatNGram over one un-padded history: the tokens that would
        complete an n-gram already present in ``seq``."""
        if n <= 0 or len(seq) < n - 1:
            return []
        if n == 1:
            return sorted(set(seq))
        tail = tuple(seq[len(seq) - (n - 1):])
        return sorted({seq[i + n - 1] for i in range(len(seq) - n + 1) if tuple(seq[i : i + n - 1]) == tail})

    def _apply_ngram_bans(self, logits: torch.Tensor, ban_rows: List[List[int]]) -> torch.Tensor:
        """Upload the host's ban lists (the width bucketed, as the reference
        bounds its compiles) and ban them in one device scatter."""
        K = max(len(b) for b in ban_rows)
        if K == 0:
            return logits
        arr = np.full((len(ban_rows), bucket_length(K, minimum=8)), -1, np.int32)
        for b, bans in enumerate(ban_rows):
            arr[b, : len(bans)] = bans
        return sampling.ban_tokens_rows(logits, self._dev(arr))

    def _process_rows(self, logits: torch.Tensor) -> torch.Tensor:
        """The per-step path's processors over [B, V] logits: each active
        slot's penalty over its presence mask, EOS suppressed until its
        min_new_tokens, and its n-gram bans."""
        live = [b for b in range(self.B) if self.active[b] and self.slot_req[b] is not None]
        suppress = np.zeros(self.B, bool)
        for b in live:
            suppress[b] = len(self.slot_req[b].output) < self.s_minnew[b]
        logits = sampling.process_logits_rows(logits, self.seen, self._dev(self.s_rep), self._dev(suppress),
                                              self.gen.eos_token_id)
        if any(self.s_ngram[b] > 0 for b in live):
            bans = [[] for _ in range(self.B)]
            for b in live:
                req = self.slot_req[b]
                bans[b] = self._ngram_bans(req.prompt + req.output, int(self.s_ngram[b]))
            logits = self._apply_ngram_bans(logits, bans)
        return logits

    def _sample_rows(self, logits: torch.Tensor) -> torch.Tensor:
        if self.s_greedy.all():
            return sampling.greedy(logits)
        return sampling.sample_per_row(logits, self._rng, *self._slot_params())

    def _sample_one(self, logits: torch.Tensor, req: Request) -> int:
        """An admission's first token, the request's processors applied (its
        prompt as the presence mask, EOS suppressed if it has a minimum)."""
        g = self.gen
        if self.use_processors:
            rep, mn, ng = self._req_processors(req)
            logits = sampling.process_logits_rows(
                logits, self._dev(self._prompt_seen(req)[None]), torch.tensor([rep], device=self.device),
                torch.tensor([mn > 0 and g.eos_token_id is not None], device=self.device), g.eos_token_id,
            )
            logits = self._apply_ngram_bans(logits, [self._ngram_bans(req.prompt, ng)])
        if not (g.do_sample if req.do_sample is None else req.do_sample):
            return int(torch.argmax(logits[0]))
        params = (
            torch.tensor([g.temperature if req.temperature is None else req.temperature], device=self.device),
            torch.tensor([g.top_k if req.top_k is None else req.top_k], device=self.device),
            torch.tensor([g.top_p if req.top_p is None else req.top_p], device=self.device),
            torch.tensor([False], device=self.device),
        )
        return int(sampling.sample_per_row(logits, self._rng, *params)[0])

    # -- admission --------------------------------------------------------------

    def _new_seg(self, slots: int) -> kvc.KVCache:
        """A one-row cache for an admission's prefill (INT8 like the slab's)."""
        return kvc.init_cache(self.cfg, 1, slots, torch_dtype(self.cfg.dtype), quantized=self.kv_quantized,
                              device=self.device)

    def _admit_chunked(self) -> None:
        """Process at most ONE prompt chunk per engine step; decode continues
        between chunks. In paged mode the pages are reserved up front, a cached
        prefix seeds the seg, and only the uncached suffix is chunked."""
        C = self.prefill_chunk
        if self._pending is None:
            if not self.queue or self.active.all():
                return
            slot = int(np.flatnonzero(~self.active)[0])
            req = self.queue.popleft()
            n = len(req.prompt)
            plan = None
            if self.paged:
                plan = self._paged_admission_plan(req, lambda s: -(-s // C) * C)
                if plan is None:
                    if not self.active.any():  # nothing will ever free pages
                        raise ValueError(f"request {req.req_id} needs more KV pages than the pool holds")
                    self.queue.appendleft(req)  # no pages: wait for frees
                    return
            base = plan[2] if plan is not None else 0
            total = -(-(n - base) // C) * C  # chunked span (all real tokens if base > 0)
            need = total + req.max_new_tokens + self._slack()
            if need > self.max_len:
                raise ValueError(f"request {req.req_id} needs {need} slots > max_len {self.max_len}")
            if base > 0:
                toks = np.asarray(req.prompt[base:], np.int32)  # == total tokens
                mask = np.ones(total, bool)
                seg = self._paged_seed(plan[1], base, plan[4], self.max_len)
            else:
                toks = np.full(total, self.gen.pad_token_id, np.int32)
                toks[total - n:] = np.asarray(req.prompt, np.int32)  # left-pad chunk 0
                mask = np.zeros(total, bool)
                mask[total - n:] = True
                seg = self._new_seg(self.max_len)
            self._pending = [req, slot, seg, toks, mask, 0, plan]
        req, slot, seg, toks, mask, off, plan = self._pending
        logits, seg = T.prefill_chunk(
            self.cfg, self.params, self._dev(toks[off : off + C])[None], self._dev(mask[off : off + C])[None], seg
        )
        off += C
        if off < len(toks):
            self._pending = [req, slot, seg, toks, mask, off, plan]
            return
        # final chunk: sample the first token and splice the segment in
        self._pending = None
        first = self._sample_one(logits, req)
        if self.paged:
            row, chain, base, n_shared, n_seed = plan
            self._paged_commit(req, slot, seg, row, chain, base, n_shared, n_seed,
                               pad=len(toks) - len(req.prompt) if base == 0 else 0)
        else:
            kvc.insert_slot(self.cache, seg, slot)
        if self.draft is not None:
            # the draft prefills the whole prompt at the last chunk (chunking
            # bounds the target's prefill stalls; the draft is small)
            self._draft_admit(*pack_prompts([req.prompt], self.gen.pad_token_id,
                                            bucket=bucket_length(len(req.prompt))), slot)
        self._activate_slot(slot, req, first)

    def _admit(self) -> None:
        if self.prefill_chunk is not None:
            self._admit_chunked()
            return
        while self.queue and not self.active.all():
            slot = int(np.flatnonzero(~self.active)[0])
            req = self.queue.popleft()
            n = len(req.prompt)
            bucket = bucket_length(n)
            need = bucket + req.max_new_tokens + self._slack()
            if need > self.max_len:
                raise ValueError(f"request {req.req_id} needs {need} slots > max_len {self.max_len}")
            tokens, mask = pack_prompts([req.prompt], self.gen.pad_token_id, bucket=bucket)
            if not self.paged:
                if self.sched is not None:  # the streamed prefill into a one-row state
                    logits, seg_state = self.sched.prefill_pass(tokens, mask, self.max_len)
                    first = self._sample_one(logits, req)
                    self.sched.insert_slot_state(self.state, seg_state, slot)
                else:
                    seg = self._new_seg(self.max_len)
                    logits, seg = T.prefill(self.cfg, self.params, self._dev(tokens), self._dev(mask), seg)
                    first = self._sample_one(logits, req)
                    kvc.insert_slot(self.cache, seg, slot)
                if self.draft is not None:
                    self._draft_admit(tokens, mask, slot)
                self._activate_slot(slot, req, first)
                continue
            # automatic prefix caching: reuse the longest cached full-block
            # chain, recompute only a bucket-sized suffix
            plan = self._paged_admission_plan(req, bucket_length)
            if plan is None:
                if not self.active.any():  # nothing will ever free pages
                    raise ValueError(f"request {req.req_id} needs more KV pages than the pool holds")
                self.queue.appendleft(req)  # no memory: wait for frees
                return
            row, chain, base, n_shared, n_seed = plan
            if base > 0:
                # seed [0, base) from the shared pages, run [base, n) as one chunk
                # against it, commit the suffix to the request's pages
                seg = self._paged_seed(chain, base, n_seed, bucket)
                suffix = self._dev(np.asarray(req.prompt[base:], np.int32))[None]
                logits, seg = T.prefill_chunk(self.cfg, self.params, suffix, torch.ones_like(suffix, dtype=torch.bool),
                                              seg)
                pad = 0
            elif self.sched is not None:
                # the streamed prefill at the bucket's length; both segments'
                # caches become one slab for the page commit
                logits, seg_state = self.sched.prefill_pass(tokens, mask, bucket)
                seg = self._sched_seg_to_slab(seg_state)
                pad = bucket - n
            else:
                seg = self._new_seg(bucket)
                logits, seg = T.prefill(self.cfg, self.params, self._dev(tokens), self._dev(mask), seg)
                pad = bucket - n
            first = self._sample_one(logits, req)
            self._paged_commit(req, slot, seg, row, chain, base, n_shared, n_seed, pad)
            if self.draft is not None:
                self._draft_admit(tokens, mask, slot)
            self._activate_slot(slot, req, first)

    @staticmethod
    def _sched_seg_to_slab(seg_state) -> kvc.KVCache:
        """The scheduler's one-row {res, str} state as one [L, 1, N_kv, S, D]
        cache (plans that keep KV on the card: both segments are there)."""
        caches = [c for c in (seg_state["res"], seg_state["str"]) if c is not None]
        if len(caches) == 1:
            return caches[0]
        return caches[0]._replace(k=torch.cat([c.k for c in caches]), v=torch.cat([c.v for c in caches]))

    def _slack(self) -> int:
        """Slots past a request's last token that a verify may write: k + 1
        with speculation, else none."""
        return self.speculate_k + 1 if self.speculate_k is not None else 0

    def _draft_admit(self, tokens: np.ndarray, mask: np.ndarray, slot: int) -> None:
        """Prefill the draft's slab cache for a newly admitted slot ([1, bucket]
        left-padded prompt). The draft's cache is a slab whatever the
        target's storage, so draft speculation composes with paged targets
        and chunked admission."""
        seg = kvc.init_cache(self.dcfg, 1, self.max_len, torch_dtype(self.dcfg.dtype), device=self.device)
        _, seg = T.prefill(self.dcfg, self.dparams, self._dev(tokens), self._dev(mask), seg)
        kvc.insert_slot(self.dcache, seg, slot)
        self.dlen[slot] = tokens.shape[1]

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        eos_hit = self.gen.eos_token_id is not None and tok == self.gen.eos_token_id
        if req.stop_token_ids is not None and tok in req.stop_token_ids:
            eos_hit = True
        if eos_hit or len(req.output) >= req.max_new_tokens:
            req.finished_at = time.perf_counter()
            self.done.append(req)
            self.slot_req[slot] = None
            self.active[slot] = False
            if self.paged:  # drop refcounts; prefix pages stay cached
                self._release_pages(self.block_table[slot])
                self.block_table[slot] = 0
                self.kv_lengths[slot] = 0

    # -- decode -------------------------------------------------------------------

    def _fused_k(self) -> int:
        """How many decode steps the next dispatch may fuse (1 = the per-step
        path): none while a chunked admission is in flight, else up to
        ``fused_steps``, capped at the smallest remaining token budget of the
        active slots, so in-block writes stay inside each slot's reservation.
        A queued request has no free slot (or no pages) after ``_admit``, so a
        block delays it at most by that cap."""
        if (self.fused_steps <= 1 or self._pending is not None or self.speculate_k is not None
                or self.sched is not None):
            return 1
        if self.use_processors and (self.active & (self.s_ngram > 0)).any():
            # the n-gram ban lists come from the host each step. Only active
            # slots count: a finished slot keeps its request's values until
            # the slot is reused, and the reference's unmasked test let it
            # hold fused decode off
            return 1
        remaining = [
            self.slot_req[b].max_new_tokens - len(self.slot_req[b].output)
            for b in np.flatnonzero(self.active)
            if self.slot_req[b] is not None
        ]
        if not remaining:
            return 1
        return max(1, min(self.fused_steps, min(remaining)))

    def _decode(self, tok: torch.Tensor, pos: torch.Tensor, active: torch.Tensor, table=None, lengths=None):
        """One decode step of the whole batch on the device; the paged pool or
        the slab cache is written in place; over the scheduler, its paged or
        ragged pass. Returns the logits [B, V]."""
        if self.paged:
            if self.sched is not None:
                logits, _, _ = self.sched.decode_pass_paged(tok, pos, self.k_pool, self.v_pool, table, lengths,
                                                            active)
                return logits
            logits, _, _ = pg.decode_step_paged(
                self.cfg, self.params, tok[:, None], pos, self.k_pool, self.v_pool, table, lengths, active
            )
            return logits
        if self.sched is not None:
            logits, self.state = self.sched.decode_pass_ragged(tok, pos, self.state, active)
            return logits
        logits, self.cache = T.decode_step_ragged(self.cfg, self.params, tok[:, None], pos, self.cache, active)
        return logits

    def _fused_block(self, k: int) -> None:
        """k decode steps back to back with the tokens, positions and lengths on
        the device, then one read of the [k, B] tokens. Slots that finish
        inside the block stop counting at their stop token; their extra writes
        land in space reserved for them and are reset when the slot is
        reused. Repetition penalty and min-new-tokens apply at every step, the
        presence mask updated on the device; a slot's EOS suppression
        follows its count at the block's start plus j."""
        active = self._dev(self.active)
        adv = active.to(torch.int32)
        proc = self.use_processors
        if proc:
            gen0 = self._dev(np.array([0 if r is None else len(r.output) for r in self.slot_req], np.int32))
            rep, minnew = self._dev(self.s_rep), self._dev(self.s_minnew)
        tok = self._dev(self.tokens)
        pos = self._dev(self.logical_pos.astype(np.int32))
        table = self._dev(self.block_table) if self.paged else None
        lengths = self._dev(self.kv_lengths) if self.paged else None
        out = torch.empty((k, self.B), dtype=torch.int32, device=self.device)
        for j in range(k):
            logits = self._decode(tok, pos, active, table, lengths)
            if proc:
                logits = sampling.process_logits_rows(logits, self.seen, rep, active & (gen0 + j < minnew),
                                                      self.gen.eos_token_id)
            tok = self._sample_rows(logits)
            if proc:
                sampling.mark_seen(self.seen, tok, active)
            out[j] = tok
            pos = pos + adv
            if self.paged:
                lengths = lengths + adv
        toks = out.cpu().numpy()
        self._steps += k
        self._dispatches += 1
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            req = self.slot_req[slot]
            for j in range(k):
                t = int(toks[j, slot])
                req.output.append(t)
                self.tokens[slot] = t
                self.logical_pos[slot] += 1
                if self.paged:
                    self.kv_lengths[slot] += 1
                self._maybe_finish(slot, t)
                if not self.active[slot]:
                    break

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: admit waiting requests, then one decode step
        (or a fused block of up to ``fused_steps``). Returns False when there
        is nothing left to do."""
        self._admit()
        if not self.active.any():
            return bool(self.queue) or self._pending is not None
        if self.speculate_k is not None:
            self._spec_step()
            return True
        k = self._fused_k()
        if k > 1:
            self._fused_block(k)
            return True
        active = self._dev(self.active)
        tok = self._dev(self.tokens)
        pos = self._dev(self.logical_pos.astype(np.int32))
        if self.paged:
            logits = self._decode(tok, pos, active, self._dev(self.block_table), self._dev(self.kv_lengths))
            self.kv_lengths[self.active] += 1
        else:
            logits = self._decode(tok, pos, active)
        if self.use_processors:
            logits = self._process_rows(logits)
        toks = self._sample_rows(logits)
        if self.use_processors:
            sampling.mark_seen(self.seen, toks, active)
        toks = toks.cpu().numpy()
        self._steps += 1
        self._dispatches += 1
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            req = self.slot_req[slot]
            t = int(toks[slot])
            req.output.append(t)
            self.tokens[slot] = t
            self.logical_pos[slot] += 1
            self._maybe_finish(slot, t)
        return True

    def _spec_step(self) -> None:
        """One speculative iteration: k proposals per active slot (prompt
        lookup or the draft), one verify of all k + 1 positions, acceptance.
        Greedy rows take the longest argmax-matching prefix and the bonus
        token; with ``gen.do_sample`` the Leviathan rule runs on the device
        (prompt lookup's proposals as point masses), and only the [B] counts
        and tokens come to the host. Each request's budget and stop tokens
        cut its accepted run."""
        from lia_tpu_torch.engine import lookahead as la

        k, g = self.speculate_k, self.gen
        C = k + 1
        sampled = g.do_sample
        active = self.active.copy()
        active_dev = self._dev(active)
        qs = None
        if self.draft is not None:
            tok, pos = self._dev(self.tokens), self._dev(self.logical_pos.astype(np.int32))
            if sampled:
                props_dev, qs, self.dcache = la.draft_loop_sampled(self.dcfg, self.dparams, tok, pos, self.dcache, k,
                                                                   g, self._rng, active_dev)
            else:
                props_dev, self.dcache = la.draft_loop(self.dcfg, self.dparams, tok, pos, self.dcache, k, active_dev)
            props = props_dev.cpu().numpy()
        else:
            props = np.stack([
                la.propose_ngram(self.slot_req[b].prompt + self.slot_req[b].output, self.speculate_ngram, k,
                                 g.pad_token_id)
                if active[b] and self.slot_req[b] is not None else [g.pad_token_id] * k
                for b in range(self.B)
            ]).astype(np.int32)
            props_dev = self._dev(props)
        chunk = np.concatenate([self.tokens[:, None].astype(np.int32), props], axis=1)
        positions = self.logical_pos[:, None].astype(np.int32) + np.arange(C, dtype=np.int32)[None, :]
        if self.paged:
            logits, _, _ = pg.verify_step_paged(
                self.cfg, self.params, self._dev(chunk), self._dev(positions), self.k_pool, self.v_pool,
                self._dev(self.block_table), self._dev(self.kv_lengths), active_dev,
            )
        elif self.sched is not None:
            # the tiered verify: each streamed layer's weights cross once for
            # all k + 1 positions
            logits, self.state = self.sched.verify_logits(self._dev(chunk), self._dev(positions), self.state)
        else:
            logits = T.verify_chunk(self.cfg, self.params, self._dev(chunk), self._dev(positions), self.cache)
        if sampled:
            ps = sampling.warped_probs(logits, g)
            u = la.uniforms(self.B, k, self._rng)
            if self.draft is not None:
                a_dev, extra_dev = la.sampled_accept(props_dev, qs, ps, u, self._rng)
            else:
                a_dev, extra_dev = la.lookup_accept(props_dev, ps, u, self._rng)
            a_np, extra_np = a_dev.cpu().numpy(), extra_dev.cpu().numpy()
        else:
            greedy = sampling.greedy(logits).cpu().numpy()
            accepted = la.greedy_accept(props, greedy)
        self._steps += 1
        self._dispatches += 1
        accept = np.zeros(self.B, np.int32)
        for b in np.flatnonzero(active):
            b = int(b)
            req = self.slot_req[b]
            if sampled:
                a = int(a_np[b])
                new_toks = [int(t) for t in props[b, :a]] + [int(extra_np[b])]
            else:
                a = int(accepted[b])
                new_toks = [int(t) for t in chunk[b, 1 : a + 1]] + [int(greedy[b, a])]
            new_toks = new_toks[: req.max_new_tokens - len(req.output)]
            stops = set() if g.eos_token_id is None else {g.eos_token_id}
            if req.stop_token_ids:
                stops |= set(req.stop_token_ids)
            for j, t in enumerate(new_toks):
                if t in stops:
                    new_toks = new_toks[: j + 1]
                    break
            accept[b] = len(new_toks)
            req.output.extend(new_toks)
            self.tokens[b] = new_toks[-1]
            self.logical_pos[b] += len(new_toks)
            self._maybe_finish(b, new_toks[-1])
        if self.paged:
            # rejected chunk slots lie past the advanced length, dead until the
            # next verify overwrites them; a slot that finished this step has
            # released its pages and zeroed its length, and is not advanced
            self.kv_lengths = self.kv_lengths + accept * self.active
        elif self.sched is not None:
            self.state = self.sched.accept_state(self.state, self._dev(accept))
        else:
            self.cache = kvc.accept_ragged(self.cache, self._dev(accept))
        if self.draft is not None:
            # the draft advanced active rows k + 1 slots: back to the verified prefix
            self.dlen = self.dlen + accept
            self.dcache = kvc.rewind_ragged(self.dcache, self._dev(self.dlen))

    def run(self) -> List[Request]:
        while self.step() or self.queue or self.active.any() or self._pending is not None:
            if not self.queue and not self.active.any() and self._pending is None:
                break
        return self.done

    def stats(self) -> Dict[str, float]:
        """Aggregate serving metrics over finished requests: throughput, TTFT and
        per-request TPOT (time per output token after the first) percentiles,
        decode steps and dispatches, and (paged) the prefix-cache counters."""
        if not self.done:
            return {}
        ttfts = np.array([r.ttft_s for r in self.done if r.ttft_s is not None])
        tpots = np.array([
            (r.finished_at - r.first_token_at) / (len(r.output) - 1)
            for r in self.done
            if r.first_token_at is not None and len(r.output) > 1
        ])
        total_tokens = sum(len(r.output) for r in self.done)
        t0 = min(r.submitted_at for r in self.done)
        t1 = max(r.finished_at for r in self.done)
        out = {
            "requests": float(len(self.done)),
            "total_tokens": float(total_tokens),
            "tokens_per_s": total_tokens / max(t1 - t0, 1e-9),
            "decode_steps": float(self._steps),
            "decode_dispatches": float(self._dispatches),
            "steps_per_dispatch": self._steps / max(self._dispatches, 1),
        }
        for name, arr in (("ttft_s", ttfts), ("tpot_s", tpots)):
            if arr.size:
                out[f"mean_{name}"] = float(arr.mean())
                out[f"p50_{name}"] = float(np.percentile(arr, 50))
                out[f"p90_{name}"] = float(np.percentile(arr, 90))
                out[f"p99_{name}"] = float(np.percentile(arr, 99))
        if self.paged:
            out["prefix_hits"] = float(self.prefix_hits)
            out["prefix_tokens_reused"] = float(self.prefix_tokens_reused)
        return out
