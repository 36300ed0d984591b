"""Preallocated KV cache (port of ``lia_tpu/ops/kv_cache.py``, the slab cache).

Layout as in the reference: a stacked ``[L, B, N_kv, S_max, D]`` cache, head-major
so that each head's ``[S_max, D]`` plane is contiguous, plus a ``[B, S_max]`` slot
validity mask and a scalar length.

Unlike the reference, whose arrays are immutable (XLA aliases the buffer under
donation), every write here is **in place**: :func:`update_layer`,
:func:`write_token_all`, :func:`advance`, :func:`advance_ragged` and
:func:`insert_slot` modify the cache tensors they are given, and return them (or
the cache) only for symmetry with the reference. ``length`` is an int32 tensor
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
    shape = [1] * new.dim()
    shape[dim - 2], shape[dim] = idx.shape
    plane.scatter_(dim, idx.view(shape).expand(new.shape), new)


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
