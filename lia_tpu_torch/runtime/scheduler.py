"""Tiered generation scheduler: streamed weights and hybrid placements
(port of ``lia_tpu/runtime/scheduler.py``, the generation path).

LIA's layer-by-layer pipeline (lia/modeling_opt.py:1021-1586) on one CUDA card
and its host:

- the **resident prefix** (the first ``hbm_percentage``% of layers, policy 3)
  runs as the resident engine does, over its own device cache: flash prefill,
  and at decode the fresh-merge kernel over a past-only context;
- the **streamed layers** run one at a time while
  :class:`~lia_tpu_torch.runtime.weight_manager.TieredWeightManager` copies
  the next layer's weights on its copy stream; at decode they write the fresh
  K/V first and then attend with a context that includes the token
  (``decode_attention``);
- **placements** (:mod:`lia_tpu_torch.runtime.policy`) split a streamed
  layer at the attention boundary: policy 1 runs whole layers on the CPU
  over host weights; policies 2/4 run the linears on the card and attention
  on the CPU over a host KV cache; policy 0 attends on the card but keeps KV
  on the host (prefill stores it, decode streams each plane back in);
- ``overlap=False`` synchronizes after every transfer and every layer;
- minibatch prefill (``num_minibatch``) splits the batch so that each layer's
  weights serve several chunks; each chunk writes its own cache rows.

Host compute is the policy's placement: the CPU runs the golden attention and
the plain matmuls (``host=True`` in :mod:`lia_tpu_torch.models.transformer`),
reached only through policies 1, 2 and 4. With a host KV cache, K/V leave
the card by asynchronous copies into pinned memory; the host writes them
into its cache at the end of the pass, after waiting on each copy's event.

Beam search runs over the same segments: grouped (both segment caches become
beam caches, a shared prompt per group and per-beam tails; the streamed
layers attend through the beam kernel and write their tail slot per layer,
and a step's shuffle gathers only the tails) where both plans keep KV on the
card, and expanded (the whole of both caches gathered each step, the host
cache included) under host-KV plans (policies 0, 1, 2, 4), as in the
reference. The scoring pass is the prefill over both segments with the head
on every position. The chunked verify pass (:meth:`StreamingScheduler.verify_pass`,
speculative decoding) runs where both plans keep KV on the card.

Continuous batching runs over the same segments: ragged serving
(:meth:`StreamingScheduler.init_serving_state`, :meth:`insert_slot_state`,
:meth:`decode_pass_ragged`) gives both caches a length per row, under every
policy; paged serving (:meth:`decode_pass_paged`) replaces both caches by one
``[L, num_blocks, N_kv, block_size, D]`` pool that the resident and the
streamed layers read by layer index, where both plans keep KV on the card.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from lia_tpu_torch.config import GenerationConfig, ModelConfig, RuntimeConfig, torch_dtype
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import kv_cache as kvc
from lia_tpu_torch.ops import sampling
from lia_tpu_torch.ops.quant import QuantizedKV, is_quantized_kv
from lia_tpu_torch.runtime import policy as pol
from lia_tpu_torch.runtime.weight_manager import TieredWeightManager
from lia_tpu_torch.utils.checkpoint import to_device
from lia_tpu_torch.utils.metrics import LatencyStats

CPU = torch.device("cpu")


def _move(ctx, device):
    """An attention context (or any NamedTuple of tensors) on ``device``."""
    return type(ctx)(*[a.to(device) if isinstance(a, torch.Tensor) else a for a in ctx])


def _rows(x: Any, b0: int, b1: int) -> Any:
    """Batch rows [b0, b1) of a tensor, a QuantizedKV plane or an attention
    context, as views (writes go through)."""
    if is_quantized_kv(x):
        return QuantizedKV(x.q[b0:b1], x.s[b0:b1])
    if isinstance(x, tuple):  # PrefillAttn / DecodeAttn: per-sequence tensors have a batch dim (not the slopes)
        return type(x)(*[a[b0:b1] if isinstance(a, torch.Tensor) and a.dim() and f != "slopes" else a
                         for f, a in zip(x._fields, x)])
    return x[b0:b1]


PAGED_HOST_PLANS = ("paged serving over the scheduler needs plans that keep KV on the card (policy 3 "
                    "streaming); host-placement policies have no paged host kernel")


class StreamingScheduler:
    """Drives prefill/decode with tiered weights and hybrid placements."""

    def __init__(self, cfg: ModelConfig, runtime: RuntimeConfig, params: Any, device, mesh=None):
        """``params``: the (fused) parameter tree, anywhere. The weight manager
        puts its resident layers on ``device`` and packs the streamed ones into
        host buffers (pinned for a CUDA ``device``); the rest (embeddings,
        norms, head) goes to ``device``. The tree itself is not kept."""
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet")
        self.cfg = cfg
        self.runtime = runtime
        self.device = torch.device(device)
        self.prefill_plan, self.decode_plan = pol.phase_plans(runtime)
        hbm_pct = 0 if runtime.stream_weights and runtime.hbm_percentage >= 100 else runtime.hbm_percentage
        # a device ring only where a phase runs streamed layers on the card
        on_card = not (self.prefill_plan.all_host and self.decode_plan.all_host)
        self.wm = TieredWeightManager(
            params["layers"], cfg.num_layers, hbm_pct, overlap=runtime.overlap, device=self.device,
            ring=max(2, runtime.max_inflight_layers) if on_card else 0,
        )
        self.top = to_device({k: v for k, v in params.items() if k != "layers"}, self.device)
        # the streamed segment's KV lives in host memory when either phase's
        # plan says so (a prefill that stores host KV makes decode read it there)
        self.kv_host = pol.uses_host_kv(runtime) and self.wm.n_resident < cfg.num_layers
        self._cuda = self.device.type == "cuda"
        # K/V copies to the host not yet written into the host cache: (event,
        # layer, k, v, first row, last row)
        self._pending: List[Tuple[Any, int, torch.Tensor, torch.Tensor, int, int]] = []

    # -- caches ----------------------------------------------------------------

    def _init_caches(self, B: int, max_len: int):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        q = self.runtime.quant.kv_cache_dtype == "int8"
        n_res = self.wm.n_resident
        n_str = cfg.num_layers - n_res
        res = kvc.init_cache(cfg.replace(num_layers=n_res), B, max_len, dt, quantized=q,
                             device=self.device) if n_res else None
        st = None
        if n_str:
            # a host cache is allocated on the host, pinned for the card's copies
            dev = CPU if self.kv_host else self.device
            st = kvc.init_cache(cfg.replace(num_layers=n_str), B, max_len, dt, quantized=q, device=dev,
                                pin_memory=self.kv_host and self._cuda)
        return res, st

    # -- host KV traffic (policy 0) --------------------------------------------

    def _store(self, cache: kvc.KVCache, li: int, k: torch.Tensor, v: torch.Tensor, b0: int, b1: int):
        """Start the copy of fresh K/V (rows [b0, b1)) to the host; the host
        writes them into layer ``li`` of its cache in :meth:`_flush`."""
        if not self._cuda:
            self._pending.append((None, li, k, v, b0, b1))
            return
        kh = torch.empty_like(k, device=CPU, pin_memory=True).copy_(k, non_blocking=True)
        vh = torch.empty_like(v, device=CPU, pin_memory=True).copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._pending.append((done, li, kh, vh, b0, b1))

    def _flush(self, cache: kvc.KVCache) -> None:
        """Write every pending K/V copy into the host cache, each after its
        copy has landed. A plane streamed to the card earlier in the pass was
        copied before the K/V that follow it on the same stream, so it is no
        longer read when the host writes into it."""
        for done, li, k, v, b0, b1 in self._pending:
            if done is not None:
                done.synchronize()
            kvc.update_layer(_rows(kvc.index_layer_kv(cache.k, li), b0, b1),
                             _rows(kvc.index_layer_kv(cache.v, li), b0, b1), k, v, cache.length)
        self._pending = []

    def _plane_to_device(self, plane: Any) -> Any:
        """A host cache plane on the card (an asynchronous copy from pinned memory)."""
        if is_quantized_kv(plane):
            return QuantizedKV(*(t.to(self.device, non_blocking=True) for t in plane))
        return plane.to(self.device, non_blocking=True)

    # -- streamed segment ------------------------------------------------------

    def _sync(self) -> None:
        if not self.runtime.overlap and self._cuda:
            torch.cuda.synchronize(self.device)

    def _run_streamed(self, phase: str, plan: pol.Plan, x, cache: kvc.KVCache, ctx, positions):
        """Run the non-resident layers [n_res, L) per the phase's plan.

        ``cache`` is the streamed segment's own cache (its layer 0 is global
        layer n_res), in host memory when the plan keeps KV there; it is
        written in place. ``ctx`` is on the card: the prompt's context, or at
        decode the context INCLUDING the current token."""
        cfg, wm = self.cfg, self.wm
        n_res, L = wm.n_resident, cfg.num_layers
        prefill = phase == "prefill"
        layer_fn = T.decoder_layer_prefill if prefill else T.decoder_layer_decode
        B = x.shape[0]
        nm = max(1, self.runtime.num_minibatch) if prefill else 1
        mb = B // nm if nm > 1 and B % nm == 0 else B
        chunks = [(b0, b0 + mb) for b0 in range(0, B, mb)]

        def planes(li):
            return kvc.index_layer_kv(cache.k, li), kvc.index_layer_kv(cache.v, li)

        if plan.all_host:
            # policy 1: whole layers on the host over host weights; the
            # activations cross once each way
            xh, ctx_h, pos_h = x.to(CPU), _move(ctx, CPU), positions.to(CPU)
            for idx in range(n_res, L):
                kl, vl = planes(idx - n_res)
                xh, _, _ = layer_fn(cfg, wm.host_layer(idx), xh, kl, vl, cache.length,
                                    ctx_h, pos_h, host=True)
            return xh.to(self.device), cache

        core = T.attn_core_prefill if prefill else T.attn_core_decode
        ctx_h = _move(ctx, CPU) if plan.hybrid else None
        start = cache.length.to(self.device)  # the slot the card writes (policy-0 decode)
        wm.prefetch(n_res)
        for idx in range(n_res, L):
            wm.prefetch_after(idx)
            lp = wm.get_layer(idx)
            li = idx - n_res
            kl, vl = planes(li)
            if not self.kv_host:
                # policy-3 tail: streamed weights, attention and KV on the card
                parts = [layer_fn(cfg, lp, x[b0:b1], _rows(kl, b0, b1), _rows(vl, b0, b1), cache.length,
                                  _rows(ctx, b0, b1), positions[b0:b1])[0] for b0, b1 in chunks]
            elif plan.hybrid:
                # policies 2/4: linears on the card, attention on the host over host KV
                parts = []
                for b0, b1 in chunks:
                    q, k, v = T.attn_in(cfg, lp, x[b0:b1], positions[b0:b1])
                    out, _, _ = core(cfg, q.to(CPU), k.to(CPU), v.to(CPU), _rows(kl, b0, b1), _rows(vl, b0, b1),
                                     cache.length, _rows(ctx_h, b0, b1), host=True)
                    parts.append(T.attn_post_mlp(cfg, lp, x[b0:b1], out.to(self.device)))
            elif prefill:
                # policy 0 (or 3 over a host cache that the other phase's plan
                # asked for): attention on the card, K/V stored to the host
                parts = []
                for b0, b1 in chunks:
                    q, k, v = T.attn_in(cfg, lp, x[b0:b1], positions[b0:b1])
                    out = att.attend_prefill(q, k, v, _rows(ctx, b0, b1))
                    self._store(cache, li, k, v, b0, b1)
                    parts.append(T.attn_post_mlp(cfg, lp, x[b0:b1], out))
            else:
                # policy 0 decode: the layer's host KV plane streams in, the card
                # writes the token into that copy and attends
                q, k, v = T.attn_in(cfg, lp, x, positions)
                out, _, _ = core(cfg, q, k, v, self._plane_to_device(kl), self._plane_to_device(vl), start, ctx)
                self._store(cache, li, k, v, 0, B)
                parts = [T.attn_post_mlp(cfg, lp, x, out)]
            x = parts[0] if len(parts) == 1 else torch.cat(parts)
            self._sync()
        self._flush(cache)
        return x, cache

    # -- step-level passes -----------------------------------------------------

    def _prefill_hidden(self, tokens: np.ndarray, mask: np.ndarray, max_len: int):
        """The prompt through both segments' layers, each writing its cache:
        returns (hidden [B, S, H], resident cache, streamed cache), the caches'
        lengths not yet advanced."""
        cfg, dev = self.cfg, self.device
        res, st = self._init_caches(tokens.shape[0], max_len)
        tok, m = torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev)
        positions = T.prefill_positions(m)
        x = T.embed(cfg, self.top, tok, positions)
        ctx = att.prefill_attn_ctx(m, cfg.sliding_window, T.alibi_slopes(cfg, dev))
        if res is not None:
            x = T.prefill_layers(cfg, self.wm.resident, x, res, ctx, positions, self.wm.n_resident)
        if st is not None:
            x, st = self._run_streamed("prefill", self.prefill_plan, x, st, ctx, positions)
        return x, res, st

    def prefill_pass(self, tokens: np.ndarray, mask: np.ndarray, max_len: int):
        """Run the prompt through both segments. Returns (last-token logits
        [B, V] fp32, state), ``state`` being the {res, str} cache pair."""
        S = tokens.shape[1]
        x, res, st = self._prefill_hidden(tokens, mask, max_len)
        m = torch.from_numpy(mask)
        res = None if res is None else kvc.advance(res, m, S)
        st = None if st is None else kvc.advance(st, m, S)
        logits = T.lm_head(self.cfg, self.top, x[:, -1:, :])[:, 0, :]
        return logits, {"res": res, "str": st}

    def score_logprobs(self, tokens: np.ndarray, mask: np.ndarray, max_len: int) -> torch.Tensor:
        """Per-position next-token log-probs [B, S, V] fp32 with tiered weights
        (lm-eval scoring under streaming): the prompt pass over both segments,
        the head on every position."""
        x, _, _ = self._prefill_hidden(tokens, mask, max_len)
        return torch.log_softmax(T.lm_head(self.cfg, self.top, x).float(), dim=-1)

    def decode_pass(self, tok: torch.Tensor, pos: torch.Tensor, state):
        """One decode step over both segments: ``tok``/``pos`` [B] on the card.
        Returns (logits [B, V] fp32, state)."""
        cfg, dev = self.cfg, self.device
        res, st = state["res"], state["str"]
        c = res if res is not None else st  # the segments advance in lockstep
        m, ln = c.mask.to(dev), c.length.to(dev)
        x = T.embed(cfg, self.top, tok[:, None], pos[:, None])
        # two context conventions: the resident segment merges the fresh token
        # in the kernel (past-only context); the streamed layers write it first
        # and attend with a context that includes it
        # (a sliding window applies to the past-only context, whose slot mask
        # the inclusive one extends by the token's slot)
        slopes = T.alibi_slopes(cfg, dev)
        ctx_past = att.decode_attn_ctx(m, ln, cfg.sliding_window, slopes)
        ctx = att.decode_attn_ctx(ctx_past.slot_mask.index_fill(1, ln.long().reshape(1), True), ln + 1,
                                  slopes=slopes)
        B = tok.shape[0]
        if res is not None:
            x, k_new, v_new = T.decode_layers_scan(cfg, self.wm.resident, x, res.k, res.v, res.length,
                                                   ctx_past, pos[:, None], self.wm.n_resident)
            res = kvc.advance(res._replace(k=k_new, v=v_new), torch.ones((B, 1), dtype=torch.bool, device=dev), 1)
        if st is not None:
            x, st = self._run_streamed("decode", self.decode_plan, x, st, ctx, pos[:, None])
            st = kvc.advance(st, torch.ones((B, 1), dtype=torch.bool, device=st.mask.device), 1)
        return T.lm_head(cfg, self.top, x)[:, 0, :], {"res": res, "str": st}

    def generate(self, tokens: np.ndarray, mask: np.ndarray, gen: GenerationConfig, max_len: int,
                 lat: LatencyStats, generator: Optional[torch.Generator] = None):
        """Greedy or sampled generation, stepwise (each token read back to the
        host, as the reference's scheduler loop does), with the logits
        processors where ``gen`` asks for them (each token recorded in their
        state before the EOS pad, as the reference's loop does)."""
        from lia_tpu_torch.engine.engine import GenerationResult

        B, S = tokens.shape
        dev = self.device
        proc = sampling.processor_state(torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev), gen,
                                        self.cfg.vocab_size)

        def pick(logits, i):
            """Step i's token (i = 0: from the prompt), recorded in the processors' state."""
            if proc is not None:
                logits = sampling.process_logits(logits, gen, proc[0], i, history=proc[1], cur_len=S + i)
            tok = sampling.sample(logits, gen, generator)
            if proc is not None:
                sampling.update_seen(proc[0], tok)
                proc[1][:, S + i] = tok
            return tok

        t0 = time.perf_counter()
        logits, state = self.prefill_pass(tokens, mask, max_len)
        tok = pick(logits, 0)
        out = [tok.cpu().numpy()]
        lat.record(time.perf_counter() - t0)

        eos = gen.eos_token_id
        pos = torch.from_numpy(mask.sum(1).astype(np.int32)).to(dev)
        finished = tok == eos if eos is not None else torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(gen.max_new_tokens - 1):
            t0 = time.perf_counter()
            logits, state = self.decode_pass(tok, pos, state)
            tok = pick(logits, i + 1)
            if eos is not None:
                tok = torch.where(finished, torch.full_like(tok, gen.pad_token_id), tok)
                finished = finished | (tok == eos)
            out.append(tok.cpu().numpy())
            lat.record(time.perf_counter() - t0)
            pos = pos + 1
            if eos is not None and bool(finished.all()):
                break
        return GenerationResult(np.stack(out, axis=1), lat)

    # -- beam search -----------------------------------------------------------

    def reorder_state(self, state, beam_idx: torch.Tensor):
        """Gather both caches' batch rows by ``beam_idx`` (the beam shuffle of
        the expanded path), in place: O(cache) traffic a step, the host cache
        included (gathered on the host and copied back into its pinned
        planes). Host-KV plans take this path; plans with KV on the card take
        the grouped one (:meth:`beam_state_from_prefill`,
        :meth:`decode_pass_beam`, :meth:`reorder_state_beam`)."""
        return {k: None if c is None else kvc.beam_reorder(c, beam_idx) for k, c in state.items()}

    @property
    def tpu_kv_plans(self) -> bool:
        """Both phase plans keep KV on the card and attend there (policy 3
        streaming): the plans the grouped beam layout supports."""
        return not (
            self.kv_host
            or self.prefill_plan.all_host or self.prefill_plan.hybrid
            or self.decode_plan.all_host or self.decode_plan.hybrid
        )

    grouped_beam_ok = tpu_kv_plans

    def beam_state_from_prefill(self, state, nb: int, max_new_tokens: int):
        """Both prefilled segment caches (batch B0) as grouped beam caches: the
        prompt shared per group, fresh per-beam tails at B0 * nb rows."""
        if not self.grouped_beam_ok:
            raise NotImplementedError("grouped beam search needs plans that keep KV on the card; host-KV "
                                      "policies use the whole-cache path (reorder_state)")
        return {k: None if c is None else kvc.beam_cache_from_prefill(c, nb, max_new_tokens)
                for k, c in state.items()}

    def decode_pass_beam(self, tok: torch.Tensor, pos: torch.Tensor, state):
        """One grouped beam decode pass: ``tok``/``pos`` [B0*nb] on the card.
        The resident prefix runs over its beam cache as the resident engine
        does (one tail commit for all its layers); the streamed layers stream
        through the weight ring as in :meth:`decode_pass`, each attending over
        [group prompt | own tail | fresh] and writing its fresh K/V into its
        tail plane at ``tail_len``, which advances once, after the last layer.
        Returns (logits [B0*nb, V] fp32, state)."""
        cfg, wm = self.cfg, self.wm
        n_res, L = wm.n_resident, cfg.num_layers
        res, st = state["res"], state["str"]
        positions = pos[:, None]
        x = T.embed(cfg, self.top, tok[:, None], positions)
        if res is not None:
            x, res = T.beam_decode_layers_scan(cfg, wm.resident, x, res, positions, n_res)
        if st is not None:
            quantized = is_quantized_kv(st.tail_k)
            wm.prefetch(n_res)
            for idx in range(n_res, L):
                wm.prefetch_after(idx)
                lp = wm.get_layer(idx)
                li = idx - n_res
                q, k, v = T.attn_in(cfg, lp, x, positions)
                ks, vs, kf, vf = T.beam_fresh_kv(k, v, quantized, x.dtype)
                attn_out = att.attend_decode_beam(q, kf, vf, st, li, T.alibi_slopes(cfg, x.device))
                x = T.attn_post_mlp(cfg, lp, x, attn_out)
                kvc.write_token(st.tail_k, ks, li, st.tail_len)
                kvc.write_token(st.tail_v, vs, li, st.tail_len)
                self._sync()
            st = st._replace(tail_len=st.tail_len + 1)  # every layer wrote at tail_len
        return T.lm_head(cfg, self.top, x)[:, 0, :], {"res": res, "str": st}

    def reorder_state_beam(self, state, flat_src: torch.Tensor):
        """The beam shuffle under tiering: gather ONLY the generated tails of
        both segments, in place (O(tail) traffic, not O(cache))."""
        return {k: None if c is None else kvc.beam_tail_reorder(c, flat_src) for k, c in state.items()}

    # -- chunked verify pass: speculation under tiering -------------------------
    #
    # A verify pass runs C = k + 1 candidate tokens through every layer at
    # once, so each streamed layer's weights cross once per C candidates
    # instead of once per token. Plans that keep KV on the card only: the
    # chunk attends through flash_attention_cached, which the host tier has
    # no counterpart of.

    def ragged_state(self, state):
        """The prefill's state (one length for every row) with a length per
        row, [B]: speculation advances the rows unevenly."""
        return {key: None if c is None else c._replace(length=c.length.reshape(1).repeat(c.mask.shape[0]))
                for key, c in state.items()}

    def verify_logits(self, tokens: torch.Tensor, positions: torch.Tensor, state):
        """Run the C candidate tokens of each row (tokens/positions [B, C] on
        the card) through both segments over a ragged state: the resident
        prefix over its cache as the resident engine's verify does, then each
        streamed layer with its weights from the prefetch ring (one transfer
        for all C candidates), in :meth:`decode_pass`'s layer order. Each
        layer writes all C candidates into its plane at the row's length and
        attends over the valid slots and the chunk's. Returns (logits of every
        position [B, C, V] fp32, state); the masks and lengths advance by the
        accepted count in :meth:`accept_state`."""
        if not self.tpu_kv_plans:
            from lia_tpu_torch.engine.lookahead import HOST_PLANS

            raise NotImplementedError(HOST_PLANS)
        cfg, wm = self.cfg, self.wm
        n_res, L = wm.n_resident, cfg.num_layers
        res, st = state["res"], state["str"]
        C = tokens.shape[1]
        x = T.embed(cfg, self.top, tokens, positions)
        if res is not None:
            x = T.chunk_layers(cfg, wm.resident, x, res, res.length, kvc.chunk_slot_mask(res, C), positions, n_res)
        if st is not None:
            slot_mask = kvc.chunk_slot_mask(st, C)
            wm.prefetch(n_res)
            for idx in range(n_res, L):
                wm.prefetch_after(idx)
                lp = wm.get_layer(idx)
                li = idx - n_res
                x = T.decoder_layer_chunk(cfg, lp, x, kvc.index_layer_kv(st.k, li), kvc.index_layer_kv(st.v, li),
                                          st.length, slot_mask, positions)
                self._sync()
        return T.lm_head(cfg, self.top, x), {"res": res, "str": st}

    def verify_pass(self, tokens: torch.Tensor, positions: torch.Tensor, state, probs_gen=None):
        """:meth:`verify_logits` with the greedy head (the argmax of every
        position, [B, C] int32) or, given ``probs_gen``, the warped
        distributions [B, C, V] fp32 that sampled acceptance takes. Returns
        (that, state)."""
        logits, state = self.verify_logits(tokens, positions, state)
        return (sampling.greedy(logits) if probs_gen is None else sampling.warped_probs(logits, probs_gen)), state

    def accept_state(self, state, accept: torch.Tensor):
        """Advance both segments' masks and lengths by the accepted count [B]
        (the verify wrote all C candidates; only the first ``accept`` of them
        become valid)."""
        return {key: None if c is None else kvc.accept_ragged(c, accept) for key, c in state.items()}

    # -- continuous batching -----------------------------------------------------

    def init_serving_state(self, B: int, max_len: int):
        """The {res, str} cache pair of ``B`` serving slots, each row with its
        own length ([B], on its cache's device; the streamed cache in pinned
        host memory under host-KV plans)."""
        res, st = self._init_caches(B, max_len)
        return {key: None if c is None else c._replace(length=torch.zeros(B, dtype=torch.int32,
                                                                           device=c.mask.device))
                for key, c in (("res", res), ("str", st))}

    def insert_slot_state(self, state, seg_state, slot: int):
        """Copy a freshly prefilled one-row state (:meth:`prefill_pass`, the
        same max_len) into batch row ``slot`` of both caches, in place."""
        for key, c in state.items():
            if c is not None:
                kvc.insert_slot(c, seg_state[key], slot)
        return state

    def decode_pass_ragged(self, tok: torch.Tensor, pos: torch.Tensor, state, active: torch.Tensor):
        """One continuous-batching decode step over both segments: ``tok``,
        ``pos`` (logical positions) and ``active`` [B] on the card, each row at
        its own cache length. Inactive rows compute and write at their length
        too (fixed shapes), but their slot never becomes valid and their
        lengths do not move (:func:`lia_tpu_torch.ops.kv_cache.advance_ragged`).
        Returns (logits [B, V] fp32, state)."""
        cfg, dev = self.cfg, self.device
        res, st = state["res"], state["str"]
        c = res if res is not None else st  # the segments' lengths agree row by row
        m, ln = c.mask.to(dev), c.length.to(dev)
        positions = pos[:, None]
        x = T.embed(cfg, self.top, tok[:, None], positions)
        # as in decode_pass, but the inclusive context sets each row's own slot
        # (at its length) to the row's active flag
        slopes = T.alibi_slopes(cfg, dev)
        ctx_past = att.decode_attn_ctx(m, ln, cfg.sliding_window, slopes)
        own = ln.long().clamp(0, m.shape[1] - 1)[:, None]
        ctx = att.decode_attn_ctx(ctx_past.slot_mask.scatter(1, own, active[:, None]), ln + 1, slopes=slopes)
        if res is not None:
            x, k_new, v_new = T.decode_layers_scan(cfg, self.wm.resident, x, res.k, res.v, res.length,
                                                   ctx_past, positions, self.wm.n_resident)
            res = kvc.advance_ragged(res._replace(k=k_new, v=v_new), active)
        if st is not None:
            x, st = self._run_streamed("decode", self.decode_plan, x, st, ctx, positions)
            st = kvc.advance_ragged(st, active.to(st.mask.device))
        return T.lm_head(cfg, self.top, x)[:, 0, :], {"res": res, "str": st}

    def decode_pass_paged(self, tok: torch.Tensor, pos: torch.Tensor, k_pool, v_pool, block_table: torch.Tensor,
                          lengths: torch.Tensor, active: torch.Tensor):
        """One continuous-batching decode step over a paged pool [L,
        num_blocks, N_kv, block_size, D] that serves the resident and the
        streamed layers alike: ``tok``/``pos``/``lengths`` (past tokens)/
        ``active`` [B] and the block table [B, P] on the card. Every layer
        attends over its pages with the fresh token merged
        (``paged_decode_attention`` at its layer index); the streamed layers'
        weights come through the prefetch ring; all layers' fresh K/V are
        committed once, after the last layer
        (:func:`lia_tpu_torch.ops.paged.write_token_all_layers`). Returns
        (logits [B, V] fp32, k_pool, v_pool)."""
        if not self.tpu_kv_plans:
            raise NotImplementedError(PAGED_HOST_PLANS)
        from lia_tpu_torch.ops import paged as pg

        cfg, wm = self.cfg, self.wm
        n_res, L = wm.n_resident, cfg.num_layers
        positions = pos[:, None]
        x = T.embed(cfg, self.top, tok[:, None], positions)
        slopes = T.alibi_slopes(cfg, x.device)
        k_new, v_new = [], []
        wm.prefetch(n_res)
        for idx in range(L):
            if idx < n_res:
                lp = T.layer_params(wm.resident, idx)
            else:
                wm.prefetch_after(idx)
                lp = wm.get_layer(idx)
            q, k, v = T.attn_in(cfg, lp, x, positions)
            attn_out = pg.attend_decode_paged(q, k, v, k_pool, v_pool, idx, block_table, lengths, slopes)
            x = T.attn_post_mlp(cfg, lp, x, attn_out)
            k_new.append(k)
            v_new.append(v)
            if idx >= n_res:
                self._sync()
        pg.write_token_all_layers(k_pool, v_pool, torch.stack(k_new), torch.stack(v_new), block_table, lengths,
                                  active)
        return T.lm_head(cfg, self.top, x)[:, 0, :], k_pool, v_pool
