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

Beam search, ragged and paged serving, the verify pass and scoring under the
scheduler are not ported yet and raise.
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
    if isinstance(x, tuple):  # PrefillAttn / DecodeAttn: per-sequence tensors have a batch dim
        return type(x)(*[a[b0:b1] if isinstance(a, torch.Tensor) and a.dim() else a for a in x])
    return x[b0:b1]


def _unported(what: str, waits_for: str):
    raise NotImplementedError(f"{what} under the tiered scheduler is not ported yet (waits for {waits_for})")


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

    def prefill_pass(self, tokens: np.ndarray, mask: np.ndarray, max_len: int):
        """Run the prompt through both segments. Returns (last-token logits
        [B, V] fp32, state), ``state`` being the {res, str} cache pair."""
        cfg, dev = self.cfg, self.device
        S = tokens.shape[1]
        res, st = self._init_caches(tokens.shape[0], max_len)
        tok, m = torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev)
        positions = T.prefill_positions(m)
        x = T.embed(cfg, self.top, tok, positions)
        ctx = att.prefill_attn_ctx(m, cfg.sliding_window)
        if res is not None:
            x = T.prefill_layers(cfg, self.wm.resident, x, res, ctx, positions, self.wm.n_resident)
            res = kvc.advance(res, m, S)
        if st is not None:
            x, st = self._run_streamed("prefill", self.prefill_plan, x, st, ctx, positions)
            st = kvc.advance(st, torch.from_numpy(mask), S)
        logits = T.lm_head(cfg, self.top, x[:, -1:, :])[:, 0, :]
        return logits, {"res": res, "str": st}

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
        ctx_past = att.decode_attn_ctx(m, ln, cfg.sliding_window)
        ctx = att.decode_attn_ctx(ctx_past.slot_mask.index_fill(1, ln.long().reshape(1), True), ln + 1)
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
        host, as the reference's scheduler loop does)."""
        from lia_tpu_torch.engine.engine import GenerationResult

        B = tokens.shape[0]
        t0 = time.perf_counter()
        logits, state = self.prefill_pass(tokens, mask, max_len)
        tok = sampling.sample(logits, gen, generator)
        out = [tok.cpu().numpy()]
        lat.record(time.perf_counter() - t0)

        eos = gen.eos_token_id
        pos = torch.from_numpy(mask.sum(1).astype(np.int32)).to(self.device)
        finished = tok == eos if eos is not None else torch.zeros(B, dtype=torch.bool, device=self.device)
        for _ in range(gen.max_new_tokens - 1):
            t0 = time.perf_counter()
            logits, state = self.decode_pass(tok, pos, state)
            tok = sampling.sample(logits, gen, generator)
            if eos is not None:
                tok = torch.where(finished, torch.full_like(tok, gen.pad_token_id), tok)
                finished = finished | (tok == eos)
            out.append(tok.cpu().numpy())
            lat.record(time.perf_counter() - t0)
            pos = pos + 1
            if eos is not None and bool(finished.all()):
                break
        return GenerationResult(np.stack(out, axis=1), lat)

    # -- passes not ported yet -------------------------------------------------

    def init_serving_state(self, *args, **kwargs):
        _unported("ragged serving", "ROADMAP A8 and B6 flash_attention_cached")

    def insert_slot_state(self, *args, **kwargs):
        _unported("ragged serving", "ROADMAP A8 and B6 flash_attention_cached")

    def decode_pass_ragged(self, *args, **kwargs):
        _unported("ragged serving", "ROADMAP A8 and B6 flash_attention_cached")

    def decode_pass_paged(self, *args, **kwargs):
        _unported("paged serving", "B5 paged_decode_attention")

    def reorder_state(self, *args, **kwargs):
        _unported("beam search", "B9 decode_beam_attention and B10 decode_beam_attention_int8")

    def beam_state_from_prefill(self, *args, **kwargs):
        _unported("beam search", "B9 decode_beam_attention and B10 decode_beam_attention_int8")

    def decode_pass_beam(self, *args, **kwargs):
        _unported("beam search", "B9 decode_beam_attention and B10 decode_beam_attention_int8")

    def reorder_state_beam(self, *args, **kwargs):
        _unported("beam search", "B9 decode_beam_attention and B10 decode_beam_attention_int8")

    def ragged_state(self, *args, **kwargs):
        _unported("the chunked verify pass", "B6 flash_attention_cached")

    def verify_pass(self, *args, **kwargs):
        _unported("the chunked verify pass", "B6 flash_attention_cached")

    def accept_state(self, *args, **kwargs):
        _unported("the chunked verify pass", "B6 flash_attention_cached")

    def score_logprobs(self, *args, **kwargs):
        _unported("scoring", "the engine's scoring, ROADMAP A7")
