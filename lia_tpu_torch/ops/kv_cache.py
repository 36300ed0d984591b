"""Preallocated KV cache (port of ``lia_tpu/ops/kv_cache.py``: the slab cache
and the grouped beam cache).

Layout as in the reference: a stacked ``[L, B, N_kv, S_max, D]`` cache, head-major
so that each head's ``[S_max, D]`` plane is contiguous, plus a ``[B, S_max]`` slot
validity mask and a scalar length.

Unlike the reference, whose arrays are immutable (XLA aliases the buffer under
donation), every write here is **in place**: :func:`update_layer`,
:func:`write_token_all`, :func:`write_token`, :func:`advance`,
:func:`advance_ragged`, :func:`accept_ragged`, :func:`rewind_ragged`,
:func:`insert_slot` and the beam reorders modify the
cache tensors they are given, and return them (or the cache) only for symmetry
with the reference. A reorder gathers into a temporary and copies it back, so
every buffer keeps its address (and a pinned host cache stays pinned). ``length`` is an int32 tensor
on the cache's device, 0-dim for an aligned batch or [B] for continuous
batching (each row its own length), and write offsets are computed from it on
the device, so a decode step never syncs with the host.

The tiered scheduler keeps the streamed layers' cache in host memory under
policies 0, 1, 2 and 4 (``init_cache(..., device="cpu", pin_memory=True)``:
pinned when the accelerator is CUDA, so its planes move with asynchronous
copies); every function here works on host tensors as on device ones.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from lia_tpu_torch.config import ModelConfig
from lia_tpu_torch.ops.quant import QuantizedKV, is_quantized_kv, quantize_kv

Offset = Union[int, torch.Tensor]


class KVCache(NamedTuple):
    """Stacked per-layer KV cache. ``k``/``v``: [L, B, N_kv, S_max, D] (head-major),
    tensors or :class:`QuantizedKV`.

    ``length`` is the number of positions written (the same for every sequence:
    prompts are left-padded to a common bucket). ``mask``: [B, S_max] bool, True
    where a real (non-pad) token occupies the slot.
    """

    k: Any
    v: Any
    length: torch.Tensor  # 0-dim int32
    mask: torch.Tensor  # [B, S_max] bool


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    dtype=torch.bfloat16,
    quantized: bool = False,
    device=None,
    pin_memory: bool = False,
) -> KVCache:
    """Zeroed cache. ``quantized=True`` stores INT8 planes + per-token f32 scales.
    ``pin_memory=True`` allocates a host cache in page-locked memory (``device``
    must be the CPU)."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device, pin_memory=pin_memory)

    def plane():
        if quantized:
            return QuantizedKV(zeros(shape, torch.int8), zeros(shape[:-1], torch.float32))
        return zeros(shape, dtype)

    return KVCache(
        k=plane(),
        v=plane(),
        length=zeros((), torch.int32),
        mask=zeros((batch, max_len), torch.bool),
    )


def index_layer_kv(plane: Any, idx: int) -> Any:
    """Layer ``idx`` of a stacked K or V plane, as a view (writes go through)."""
    if is_quantized_kv(plane):
        return QuantizedKV(plane.q[idx], plane.s[idx])
    return plane[idx]


def set_layer_kv(plane: Any, layer_plane: Any, idx: int) -> Any:
    """Write layer ``idx`` back into a stacked K or V plane, in place. A view
    from :func:`index_layer_kv` already wrote through, and is not copied."""
    pairs = zip(plane, layer_plane) if is_quantized_kv(plane) else [(plane, layer_plane)]
    for full, layer in pairs:
        dst = full[idx]
        if dst.data_ptr() != layer.data_ptr():
            dst.copy_(layer)
    return plane


def _slots(start: Offset, n: int, size: int, device) -> torch.Tensor:
    """Slot indices ``start .. start+n-1`` on ``device``: an int64 [n] tensor for a
    uniform start, [B, n] for a per-row [B] start. The start is clamped to
    ``[0, size - n]``, as the reference's ``dynamic_update_slice`` clamps it."""
    ar = torch.arange(n, device=device)
    if isinstance(start, torch.Tensor):
        st = start.to(device=device, dtype=torch.int64).clamp(0, size - n)
        return st[:, None] + ar if st.ndim else st + ar
    return ar + min(max(int(start), 0), size - n)


def _write_plane(plane: torch.Tensor, new: torch.Tensor, start: Offset, dim: int) -> None:
    """``plane[..., start:start+n, ...] = new`` along ``dim``, in place. A [B]
    start gives row b (the axis two before the slot axis) its own offset."""
    idx = _slots(start, new.shape[dim], plane.shape[dim], plane.device)
    if idx.ndim == 1:
        plane.index_copy_(dim, idx, new)
        return
    # one index_put_ of rows x slots (the heads between them whole): on host
    # tensors a scatter_ over the expanded index took ~1000x as long
    rows = torch.arange(idx.shape[0], device=plane.device)[:, None]
    plane[(slice(None),) * (dim - 2) + (rows, slice(None), idx)] = new.movedim((dim - 2, dim), (0, 1))


def _write(plane: Any, new: Any, start: Offset, dim: int) -> Any:
    """Copy ``new`` into ``plane`` along the slot axis ``dim`` at ``start``, in place.
    A quantized plane quantizes the fresh values per token on write."""
    if is_quantized_kv(plane):
        newq = new if is_quantized_kv(new) else quantize_kv(new)
        _write_plane(plane.q, newq.q, start, dim)
        _write_plane(plane.s, newq.s, start, dim)
        return plane
    _write_plane(plane, new.to(plane.dtype), start, dim)
    return plane


def update_layer(
    k_layer: Any,  # [B, N_kv, S_max, D] (head-major; tensor or QuantizedKV)
    v_layer: Any,
    new_k: Any,  # [B, N_kv, S_new, D] (head-major)
    new_v: Any,
    start: Offset,  # uniform write offset, or [B] (one per row)
):
    """Write new K/V at [start : start+S_new] of one layer, in place."""
    return _write(k_layer, new_k, start, 2), _write(v_layer, new_v, start, 2)


def write_token(plane_full: Any, new: Any, layer_idx: int, start: Offset) -> Any:
    """Write one layer's fresh K or V [B, N_kv, S_new, D] into layer
    ``layer_idx`` of the stacked cache [L, B, N_kv, S_max, D] at ``start``
    (uniform or [B]), in place: only the S_new slots move."""
    _write(index_layer_kv(plane_full, layer_idx), new, start, 2)
    return plane_full


def write_token_all(plane_full: Any, new_stack: Any, start: Offset) -> Any:
    """Write ONE decode step's fresh K or V for ALL layers at once, in place.

    ``plane_full``: [L, B, N_kv, S_max, D] (tensor or QuantizedKV);
    ``new_stack``: [L, B, N_kv, 1, D] (tensor or QuantizedKV); ``start`` uniform
    or [B] (continuous batching: each row writes at its own length)."""
    return _write(plane_full, new_stack, start, 3)


def advance(cache: KVCache, new_mask: torch.Tensor, n_new: int) -> KVCache:
    """Mark ``n_new`` slots from ``cache.length`` with ``new_mask`` ([B, n_new] bool),
    in place, and return the cache with its length advanced."""
    idx = _slots(cache.length, n_new, cache.mask.shape[1], cache.mask.device)
    cache.mask.index_copy_(1, idx, new_mask.to(device=cache.mask.device, dtype=torch.bool))
    return cache._replace(length=cache.length + n_new)


def advance_ragged(cache: KVCache, active: torch.Tensor) -> KVCache:
    """Per-slot advance for continuous batching (``cache.length`` is [B]): each
    row's just-written slot takes its ``active`` flag, in place, and only
    active rows' lengths grow."""
    idx = _slots(cache.length, 1, cache.mask.shape[1], cache.mask.device)
    cache.mask.scatter_(1, idx, active.to(torch.bool)[:, None])
    return cache._replace(length=cache.length + active.to(cache.length.dtype))


def chunk_slot_mask(cache: KVCache, C: int) -> torch.Tensor:
    """The validity a speculative verify attends over: ``cache.mask`` with each
    row's C slots from its length set (a new mask; the cache's is left as it
    is). The slots are clamped into the plane as the chunk's write is."""
    B, S_max = cache.mask.shape
    idx = _slots(cache.length, C, S_max, cache.mask.device)
    return cache.mask.scatter(1, idx.expand(B, C), True)


def accept_ragged(cache: KVCache, accept: torch.Tensor) -> KVCache:
    """After a verify that wrote C chunk slots per row: mark only each row's
    first ``accept`` [B] of them valid (in place) and advance its length by
    as many. The rejected slots stay invalid until a later write."""
    pos = torch.arange(cache.mask.shape[1], device=cache.mask.device)[None, :]
    lo = cache.length[:, None]
    cache.mask.logical_or_((pos >= lo) & (pos < lo + accept[:, None]))
    return cache._replace(length=cache.length + accept.to(cache.length.dtype))


def rewind_ragged(cache: KVCache, new_length: torch.Tensor) -> KVCache:
    """Drop every slot at or past each row's ``new_length`` [B] (in place) and
    set the lengths to it: the draft cache's rewind to the verified prefix
    (validity is contiguous, so the cut is a single bound per row)."""
    pos = torch.arange(cache.mask.shape[1], device=cache.mask.device)[None, :]
    cache.mask.logical_and_(pos < new_length[:, None])
    return cache._replace(length=new_length.to(cache.length.dtype))


def insert_slot(cache: KVCache, seg: KVCache, slot: int) -> KVCache:
    """Copy a freshly prefilled one-sequence cache ``seg`` (batch 1, the same
    S_max) into batch row ``slot``, in place: its planes (an INT8 cache's codes
    and scales), its mask, and its scalar length as this row's length."""
    for big, small in ((cache.k, seg.k), (cache.v, seg.v)):
        pairs = zip(big, small) if is_quantized_kv(big) else [(big, small)]
        for b, s_ in pairs:
            b[:, slot].copy_(s_[:, 0])
    cache.mask[slot].copy_(seg.mask[0])
    cache.length[slot].copy_(seg.length)
    return cache


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


def _gather_(plane: Any, idx: torch.Tensor, dim: int) -> None:
    """Rows ``idx`` of ``plane`` (a tensor or each part of a QuantizedKV) along
    ``dim``, in place: gathered into a temporary, then copied back, so the
    buffer keeps its address, and a pinned host tensor stays pinned (an
    index_select of one is pageable)."""
    for t in (plane if is_quantized_kv(plane) else (plane,)):
        t.copy_(t.index_select(dim, idx.to(t.device)))


def beam_reorder(cache: KVCache, beam_idx: torch.Tensor) -> KVCache:
    """Reorder the batch axis by ``beam_idx`` [B] (the beam-search hypothesis
    shuffle), in place: the whole cache (planes and mask), O(cache) traffic a
    step. The expanded beam path and the scheduler's host-KV plans use it; the
    grouped path gathers only the generated tail (:func:`beam_tail_reorder`)."""
    _gather_(cache.k, beam_idx, 1)
    _gather_(cache.v, beam_idx, 1)
    _gather_(cache.mask, beam_idx, 0)
    return cache


class BeamKVCache(NamedTuple):
    """Grouped beam-search cache: the prompt's KV is stored ONCE per input group
    and shared (read-only) by its ``nb`` beams; only the generated tail is
    per-beam, so the per-step shuffle gathers the tail alone.

    ``prompt_k``/``prompt_v``: [L, B0, N_kv, S_p, D] (tensor or QuantizedKV),
    the prefilled slab itself; ``prompt_len``: 0-dim int32 (the bucketed
    prompt length); ``prompt_mask``: [B0, S_p] validity (left-padded prompts);
    ``tail_k``/``tail_v``: [L, B0 * nb, N_kv, T_max, D]; ``tail_len``: 0-dim
    int32, generated tokens committed so far (tail slots [0, tail_len) are
    valid for every beam); ``nb``: the beam width, a plain field.
    """

    prompt_k: Any
    prompt_v: Any
    prompt_len: torch.Tensor
    prompt_mask: torch.Tensor
    tail_k: Any
    tail_v: Any
    tail_len: torch.Tensor
    nb: int


def beam_cache_from_prefill(cache: KVCache, nb: int, max_new_tokens: int) -> BeamKVCache:
    """A grouped beam cache from a group-level prefill cache (batch B0): the
    prefilled slab becomes the shared prompt as it is (no copy), and a zeroed
    tail of B0 * nb rows is allocated beside it. Tails round to 32 slots (bf16)
    or 128 (int8), the reference's buckets, so caches convert one-to-one."""
    quantized = is_quantized_kv(cache.k)
    bucket = 128 if quantized else 32
    t_max = -(-max_new_tokens // bucket) * bucket
    L, B0, Nkv, _, D = cache.k.shape
    shape = (L, B0 * nb, Nkv, t_max, D)
    dev = cache.mask.device

    def tail():
        if quantized:
            return QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                               torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        return torch.zeros(shape, dtype=cache.k.dtype, device=dev)

    return BeamKVCache(
        prompt_k=cache.k, prompt_v=cache.v, prompt_len=cache.length, prompt_mask=cache.mask,
        tail_k=tail(), tail_v=tail(), tail_len=torch.zeros((), dtype=torch.int32, device=dev), nb=nb,
    )


def beam_tail_reorder(cache: BeamKVCache, flat_src: torch.Tensor) -> BeamKVCache:
    """The beam shuffle over the grouped cache: gather ONLY the generated tail
    by ``flat_src`` [B0 * nb], in place. ``flat_src`` stays within each group
    (``flat_src[b] // nb == b // nb``), so the shared prompt needs no touch."""
    _gather_(cache.tail_k, flat_src, 1)
    _gather_(cache.tail_v, flat_src, 1)
    return cache


def beam_commit_token(cache: BeamKVCache, k_stack: Any, v_stack: Any) -> BeamKVCache:
    """Commit one decode step's fresh K/V for all layers ([L, B, N_kv, 1, D],
    tensors or QuantizedKV) into the tail at ``tail_len`` (in place), and
    advance ``tail_len``: the beam analog of :func:`write_token_all`."""
    write_token_all(cache.tail_k, k_stack, cache.tail_len)
    write_token_all(cache.tail_v, v_stack, cache.tail_len)
    return cache._replace(tail_len=cache.tail_len + 1)
