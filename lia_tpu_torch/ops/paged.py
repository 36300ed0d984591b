"""Paged KV cache and paged attention (port of ``lia_tpu/ops/paged.py``).

Layout as in the reference: the pool is a block array ``[num_blocks, N_kv,
block_size, D]`` per layer, stacked ``[L, num_blocks, N_kv, block_size, D]`` for
serving (head-major inside a block); each sequence owns a block-table row of
block ids, and slot ``t`` of sequence ``b`` lives at ``(table[b, t // bs], :,
t % bs, :)``. Block 0 is the null page: the allocator never hands it out, and
inactive rows and positions past a sequence's length write there.

Every write is **in place** and is one vectorized ``index_put_`` per plane
(:func:`reshape_and_cache`, :func:`write_prompt_paged`,
:func:`write_prompt_all_layers`, :func:`write_token_all_layers`,
:func:`write_chunk_all_layers`); reads are one
gather per plane (:func:`gather_sequence`, :func:`seed_prefix_cache`).

The front doors :func:`paged_attention` and :func:`attend_chunk_paged` (the
reference's :func:`attend_decode_paged` at one query a row) go through the
``paged_decode_attention`` kernel wrapper
(:mod:`lia_tpu_torch.ops.cuda_attention`): the CUDA kernel, which walks the
block table itself, for a CUDA tensor; its plain version for a CPU tensor.
:func:`paged_attention_gather` and :func:`attend_decode_paged_gather` are the
reference's gather-then-attend golden paths, kept as the other side of the
tests; no serving path calls them. :func:`verify_step_paged` runs C tokens
a row through every layer and commits them with
:func:`write_chunk_all_layers`: C = k + 1 is speculative decoding's verify,
C = 1 a decode step (:func:`decode_step_paged`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from lia_tpu_torch.config import ModelConfig
from lia_tpu_torch.ops import attention as att
from lia_tpu_torch.ops import cuda_attention as ca
from lia_tpu_torch.ops.kv_cache import KVCache


class PagedKVCache(NamedTuple):
    """One layer's paged pool. ``k``/``v``: [num_blocks, N_kv, block_size, D]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


def init_paged_cache(
    cfg: ModelConfig, num_blocks: int, block_size: int = 16, dtype=torch.bfloat16, device=None
) -> PagedKVCache:
    shape = (num_blocks, cfg.num_kv_heads, block_size, cfg.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def _pages(row: torch.Tensor, page_idx: torch.Tensor) -> torch.Tensor:
    """``row[page_idx]`` with the index clamped into the row (entries past it
    belong to invalid positions, which the callers send to the null page)."""
    return row[page_idx.clamp(0, row.shape[-1] - 1)]


def slot_mapping(block_table: torch.Tensor, positions: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat pool slot (block_id * bs + offset) of each sequence's write position:
    block_table [B, max_blocks], positions [B] → [B]."""
    blk = block_table.gather(1, (positions // block_size).long()[:, None])[:, 0]
    return blk * block_size + positions % block_size


def reshape_and_cache(k_new, v_new, cache: PagedKVCache, slots: torch.Tensor) -> PagedKVCache:
    """Scatter one token per sequence (k/v [B, N_kv, 1, D]) into the pool at the
    flat ``slots`` [B], in place (reshape_and_cache parity)."""
    bs = cache.block_size
    blk, off = (slots // bs).long(), (slots % bs).long()
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        pool[blk, :, off, :] = new[:, :, 0, :].to(pool.dtype)
    return cache


def write_prompt_paged(cache: PagedKVCache, k_seq, v_seq, block_table_row, length) -> PagedKVCache:
    """Write a freshly prefilled sequence's first ``length`` tokens (k/v [N_kv,
    S, D], from slot 0) into its pages, in place; positions past ``length`` go
    to the null page 0."""
    S = k_seq.shape[1]
    bs = cache.block_size
    pos = torch.arange(S, device=k_seq.device)
    blk = torch.where(pos < length, _pages(block_table_row.long(), pos // bs), 0)
    off = pos % bs
    for pool, seq in ((cache.k, k_seq), (cache.v, v_seq)):
        pool[blk, :, off, :] = seq.transpose(0, 1).to(pool.dtype)
    return cache


def gather_sequence(cache: PagedKVCache, block_table_row) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence's K/V as head-major [N_kv, max_blocks * bs, D]."""
    def gather(pool):
        pages = pool[block_table_row.long()]  # [mb, H, bs, D]
        mb, H, bs, D = pages.shape
        return pages.transpose(0, 1).reshape(H, mb * bs, D)

    return gather(cache.k), gather(cache.v)


def write_prompt_all_layers(k_pool, v_pool, seg_k, seg_v, block_table_row, length, start=0):
    """Admission write: ONE index_put per plane commits every layer's prompt KV
    (seg k/v [L, N_kv, S, D], position 0 at slot 0) into the sequence's pages,
    in place. Positions outside ``[start, length)`` go to the null page 0
    (``start`` > 0: a prefix-cache admission leaves the shared pages alone)."""
    L, _, S, _ = seg_k.shape
    bs = k_pool.shape[3]
    pos = torch.arange(S, device=seg_k.device)
    valid = (pos >= start) & (pos < length)
    blk = torch.where(valid, _pages(block_table_row.to(seg_k.device).long(), pos // bs), 0)
    off = pos % bs
    l_idx = torch.arange(L, device=seg_k.device)[:, None]
    for pool, seg in ((k_pool, seg_k), (v_pool, seg_v)):
        pool[l_idx, blk[None, :], :, off[None, :], :] = seg.transpose(1, 2).to(pool.dtype)
    return k_pool, v_pool


def seed_prefix_cache(k_pool, v_pool, block_table_row, base, bucket: int) -> KVCache:
    """Gather a cached prefix chain into a contiguous one-sequence cache of
    ``bucket`` slots (prefix-cache admission): slots [0, base) hold the KV of
    the pages ``block_table_row`` covers and are marked valid, the length is
    ``base``; :func:`lia_tpu_torch.models.transformer.prefill_chunk` then runs
    only the prompt's suffix against it."""
    L, nb, H, bs, D = k_pool.shape
    Pb = -(-bucket // bs)  # pages covering the seg
    row = block_table_row[:Pb].to(k_pool.device).long()

    def gather(pool):
        pages = pool[:, row]  # [L, Pb, H, bs, D]
        seq = pages.transpose(1, 2).reshape(L, H, Pb * bs, D)
        return seq[:, None, :, :bucket].contiguous()  # [L, 1, H, bucket, D]

    length = torch.as_tensor(base, dtype=torch.int32, device=k_pool.device)
    mask = (torch.arange(bucket, device=k_pool.device) < length)[None]
    return KVCache(k=gather(k_pool), v=gather(v_pool), length=length, mask=mask)


def write_token_all_layers(k_pool, v_pool, k_stack, v_stack, block_table, lengths, active):
    """Decode-step write: every layer's fresh token (k/v stacks [L, B, N_kv,
    1, D]) at each row's ``lengths`` [B], in place, inactive rows to the null
    page: :func:`write_chunk_all_layers` at C = 1 (the paged analog of
    :func:`lia_tpu_torch.ops.kv_cache.write_token_all`)."""
    return write_chunk_all_layers(k_pool, v_pool, k_stack, v_stack, block_table, lengths, active)


def write_chunk_all_layers(k_pool, v_pool, k_stack, v_stack, block_table, lengths, active):
    """Speculative verify's write: ONE index_put per plane commits every
    layer's C chunk tokens (k/v stacks [L, B, N_kv, C, D]) at positions
    [lengths_b, lengths_b + C) of each row, in place; inactive rows write to
    the null page. A chunk may straddle a page boundary; a position past the
    table clamps to its last page, as the reference's clip does. The rejected
    tail of a chunk is dead past the advanced length until a later write."""
    L, B, _, C, _ = k_stack.shape
    bs = k_pool.shape[3]
    pos = lengths.long()[:, None] + torch.arange(C, device=k_stack.device)[None, :]  # [B, C]
    page_idx = (pos // bs).clamp(0, block_table.shape[1] - 1)
    blk = block_table.long().gather(1, page_idx)
    blk = torch.where(active[:, None], blk, 0)
    off = pos % bs
    l_idx = torch.arange(L, device=k_stack.device)[:, None, None]
    for pool, stack in ((k_pool, k_stack), (v_pool, v_stack)):
        pool[l_idx, blk[None], :, off[None], :] = stack.permute(0, 1, 3, 2, 4).to(pool.dtype)  # [L, B, C, H, D]
    return k_pool, v_pool


def paged_attention(q, cache: PagedKVCache, block_table, lengths, scale: Optional[float] = None):
    """single_query_cached_kv_attention parity: decode attention (q [B, 1, N, D])
    over one layer's paged pool, no fresh token: the ``paged_decode_attention``
    kernel (plain version on the CPU) over a one-layer stack."""
    return ca.paged_decode_attention(q, cache.k[None], cache.v[None], 0, block_table, lengths, scale=scale)


def paged_attention_gather(q, cache: PagedKVCache, block_table, lengths, scale: Optional[float] = None):
    """The reference's golden path of :func:`paged_attention`: gather each
    sequence's pages, then the masked golden attention."""
    ks, vs = zip(*(gather_sequence(cache, row) for row in block_table))
    ks, vs = torch.stack(ks), torch.stack(vs)  # [B, N_kv, S_virtual, D]
    pos = torch.arange(ks.shape[2], device=q.device)
    mask = pos[None, :] < torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
    return att.attend(q, ks, vs, mask[:, None, :].expand(q.shape[0], 1, -1), scale=scale)


def attend_chunk_paged(q, k_fresh, v_fresh, k_pool, v_pool, layer_idx: int, block_table, lengths,
                       alibi_slopes=None):
    """Paged attention of C >= 1 queries a row (q [B, C, N, D]) over layer
    ``layer_idx`` of the stacked pool, ``lengths`` [B] past tokens, with the
    chunk's own keys (k/v [B, N_kv, C, D], not yet in the pool) merged
    causally in the kernel: row c sees the pages and chunk keys 0..c. C = 1
    is a decode step's fresh token; C = k + 1 a speculative verify. ALiBi
    families pass their slopes: a key's position is its logical index in the
    row, chunk key c at ``lengths + c`` (paged storage holds only real
    tokens), as in the reference."""
    return ca.paged_decode_attention(
        q, k_pool, v_pool, layer_idx, block_table, lengths, k_fresh.to(q.dtype), v_fresh.to(q.dtype),
        slopes=alibi_slopes,
    )


attend_decode_paged = attend_chunk_paged  # the reference's name for C = 1


def attend_decode_paged_gather(q, k_fresh, v_fresh, k_pool, v_pool, layer_idx: int, block_table, lengths,
                               alibi_slopes=None):
    """The reference's golden path of :func:`attend_decode_paged`: gather the
    layer's pages, append the fresh token, masked golden attention (with
    ``alibi_slopes``, the bias at each key's logical index, the fresh token
    at ``lengths``)."""
    cache = PagedKVCache(k_pool[layer_idx], v_pool[layer_idx])
    ks, vs = zip(*(gather_sequence(cache, row) for row in block_table))
    ks = torch.cat([torch.stack(ks), k_fresh.to(k_pool.dtype)], dim=2)
    vs = torch.cat([torch.stack(vs), v_fresh.to(v_pool.dtype)], dim=2)
    B, S = block_table.shape[0], ks.shape[2] - 1
    pos = torch.arange(S, device=q.device)
    mask = torch.cat([pos[None, :] < lengths[:, None], torch.ones(B, 1, dtype=torch.bool, device=q.device)], 1)
    bias = None
    if alibi_slopes is not None:
        bias = att.alibi_bias(alibi_slopes, torch.cat([pos[None, :].expand(B, S), lengths[:, None]], dim=1))
    return att.attend(q, ks, vs, mask[:, None, :], bias=bias)


def decode_step_paged(cfg: ModelConfig, params, tokens, logical_pos, k_pool, v_pool, block_table, lengths,
                      active):
    """One ragged decode step over the paged pool (continuous batching):
    tokens [B, 1], logical_pos / lengths (past tokens) / active [B], the block
    table int32 [B, P] on the pool's device; :func:`verify_step_paged` at
    C = 1. Returns (logits [B, V] fp32, k_pool, v_pool)."""
    logits, k_pool, v_pool = verify_step_paged(cfg, params, tokens, logical_pos[:, None], k_pool, v_pool,
                                               block_table, lengths, active)
    return logits[:, 0, :], k_pool, v_pool


def verify_step_paged(cfg: ModelConfig, params, tokens, positions, k_pool, v_pool, block_table, lengths, active):
    """C tokens a row (tokens/positions [B, C]) through every layer over the
    paged pool: each layer attends over its pages and the chunk's causal
    triangle (:func:`attend_chunk_paged`, ``paged_decode_attention`` at C
    queries); one :func:`write_chunk_all_layers` then commits every layer's
    chunk K/V, in place. ``lengths`` [B] count past tokens. At C = k + 1 it
    is speculative decoding's verify (the paged analog of
    :func:`lia_tpu_torch.models.transformer.verify_chunk`): the caller
    advances the lengths by the accepted count only. Returns (logits [B, C,
    V] fp32, k_pool, v_pool)."""
    from lia_tpu_torch.models import transformer as T

    T.check_supported(cfg)
    x = T.embed(cfg, params, tokens, positions)
    slopes = T.alibi_slopes(cfg, x.device)
    k_new, v_new = [], []
    for idx in range(cfg.num_layers):
        lp = T.layer_params(params["layers"], idx)
        q, k, v = T.attn_in(cfg, lp, x, positions)
        attn_out = attend_chunk_paged(q, k, v, k_pool, v_pool, idx, block_table, lengths, slopes)
        x = T.attn_post_mlp(cfg, lp, x, attn_out)
        k_new.append(k)
        v_new.append(v)
    write_chunk_all_layers(k_pool, v_pool, torch.stack(k_new), torch.stack(v_new), block_table, lengths, active)
    return T.lm_head(cfg, params, x), k_pool, v_pool
