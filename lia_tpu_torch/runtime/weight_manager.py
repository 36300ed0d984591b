"""Tiered weight manager: a device-resident prefix and host-streamed layers
(port of ``lia_tpu/runtime/weight_manager.py``), built the CUDA way.

LIA keeps the first ``gpu_percentage``% of layers on the GPU and streams the
rest from pinned host memory on dedicated CUDA streams, double-buffered
(lia/modeling_opt.py:90-318). Here:

- **Resident prefix.** The first ``n_resident = L * hbm_percentage // 100``
  layers go onto the device once, stacked, as :func:`to_device` places them.
- **Packed host buffers.** Each streamed layer is copied once, from the
  given tree, into one contiguous byte buffer (pinned when the device is
  CUDA), every leaf at a 256-byte aligned offset in the memory order
  :func:`to_host` gives it for the device (so int8 × int8 codes are
  column-major for the card). These buffers are the only host copy the
  manager keeps: the host tier (policy 1) reads typed views of them, and one
  layer is one host → device copy whose typed views give the leaves back, at
  no cost.
- **Device ring.** ``ring`` device buffers of one layer's size (the
  scheduler asks for ``max(2, max_inflight_layers)``, or none when no phase
  runs a streamed layer on the card). :meth:`prefetch` copies a layer into
  its ring slot on a copy stream, after that stream has waited on an event
  marking the slot's last reader as enqueued on the compute stream;
  :meth:`prefetch_after` keeps ``ring - 1`` layers in flight ahead of the one
  computing; :meth:`get_layer` makes the compute stream wait on the copy's
  completion event and returns views into the slot. ``overlap=False``
  copies only when a layer is asked for, and synchronizes after the copy,
  as the reference's ``--no-overlap`` does.
- On the CPU (the tests) the same ring runs with plain copies and no streams.

The manager sees only a stacked ``[L, ...]`` subtree and hands out per-layer
subtrees. It never keeps a streamed layer resident: if a buffer cannot be
pinned, it raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from lia_tpu_torch.models.transformer import layer_params
from lia_tpu_torch.ops.quant import is_quantized
from lia_tpu_torch.utils.checkpoint import to_device, to_host

ALIGN = 256  # byte alignment of every leaf in a packed layer


def slice_layer(stacked: Dict[str, Any], idx: int) -> Dict[str, Any]:
    """Layer ``idx``'s subtree of the stacked tree, as views."""
    return layer_params(stacked, idx)


def tree_tensors(tree: Any) -> List[torch.Tensor]:
    """The tree's tensors in a fixed order (dict order; a record's q, s, z)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if is_quantized(tree):
        return [t for t in (tree.q, tree.s, tree.z) if t is not None]
    return [tree]


def _rebuild(tree: Any, it) -> Any:
    """``tree``'s structure with its tensors taken, in :func:`tree_tensors` order, from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if is_quantized(tree):
        return tree.map(lambda _: next(it))
    return next(it)


def stacked_prefix(tree: Any, n: int) -> Any:
    """The first ``n`` layers of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: stacked_prefix(v, n) for k, v in tree.items()}
    if is_quantized(tree):
        return tree.map(lambda t: t[:n])
    return tree[:n]


def _memory_order(t: torch.Tensor) -> Tuple[int, ...]:
    """A permutation of ``t``'s dims under which it is contiguous (its memory
    order); the identity where there is none (the leaf is then re-laid
    row-major)."""
    perm = tuple(sorted(range(t.dim()), key=lambda d: -t.stride(d)))
    return perm if t.permute(perm).is_contiguous() else tuple(range(t.dim()))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TieredWeightManager:
    """Owns the resident prefix, the packed host layers and the device ring."""

    def __init__(
        self,
        layers: Dict[str, Any],  # stacked [L, ...] tree, anywhere; not kept
        num_layers: int,
        hbm_percentage: int = 100,
        overlap: bool = True,
        device=None,
        ring: int = 2,
    ):
        self.num_layers = num_layers
        self.n_resident = min(num_layers, num_layers * hbm_percentage // 100)
        self.overlap = overlap
        self.device = torch.device("cuda" if device is None else device)
        self._cuda = self.device.type == "cuda"
        self._total_bytes = sum(_nbytes(t) for t in tree_tensors(layers))
        self.resident = (
            to_device(stacked_prefix(layers, self.n_resident), self.device)
            if self.n_resident else None
        )
        self.layer_bytes = 0
        self._packed: List[torch.Tensor] = []
        self._host_views: List[Dict[str, Any]] = []
        self._ring: List[torch.Tensor] = []
        self._views: List[Dict[str, Any]] = []
        self._inflight: Dict[int, Tuple[int, Any]] = {}  # layer -> (ring slot, copy-done event)
        self._copies: List[Tuple[Any, Any]] = []  # (start, done) events of each copy
        self._copy_stream = None
        if self.n_resident < num_layers:
            self._build(layers, ring)

    # -- set-up ----------------------------------------------------------------

    def _build(self, layers: Dict[str, Any], ring: int) -> None:
        first = to_host(slice_layer(layers, self.n_resident), self.device)
        specs = []  # (byte offset, dtype, shape in memory order, permutation)
        off = 0
        for t in tree_tensors(first):
            perm = _memory_order(t)
            specs.append((off, t.dtype, tuple(t.shape[d] for d in perm), perm))
            off += -(-_nbytes(t) // ALIGN) * ALIGN
        self.layer_bytes = off
        for idx in range(self.n_resident, self.num_layers):
            buf = torch.empty(off, dtype=torch.uint8, pin_memory=self._cuda)
            if self._cuda and not buf.is_pinned():
                raise RuntimeError("could not pin a streamed layer's host buffer")
            leaves = tree_tensors(to_host(slice_layer(layers, idx), self.device))
            if len(leaves) != len(specs):
                raise ValueError(f"layer {idx} has {len(leaves)} tensors, layer {self.n_resident} {len(specs)}")
            for t, view in zip(leaves, self._typed_views(buf, specs)):
                if t.shape != view.shape or t.dtype != view.dtype:
                    raise ValueError(f"layer {idx}: a tensor of {tuple(t.shape)} {t.dtype} where "
                                     f"layer {self.n_resident} has {tuple(view.shape)} {view.dtype}")
                view.copy_(t)
            self._packed.append(buf)
            self._host_views.append(_rebuild(first, iter(self._typed_views(buf, specs))))
        n_slots = min(ring, self.num_layers - self.n_resident)
        self._ring = [torch.empty(off, dtype=torch.uint8, device=self.device) for _ in range(n_slots)]
        self._views = [_rebuild(first, iter(self._typed_views(r, specs))) for r in self._ring]
        if self._cuda and self._ring:
            self._copy_stream = torch.cuda.Stream(self.device)
            for r in self._ring:  # the allocator keeps a freed slot until the copy stream is done with it
                r.record_stream(self._copy_stream)

    @staticmethod
    def _typed_views(buf: torch.Tensor, specs) -> List[torch.Tensor]:
        """The leaves as views of a packed byte buffer, in their logical shapes."""
        out = []
        for off, dtype, mshape, perm in specs:
            n = 1
            for d in mshape:
                n *= d
            nb = n * torch.empty((), dtype=dtype).element_size()
            inv = [0] * len(perm)
            for i, d in enumerate(perm):
                inv[d] = i
            out.append(buf[off : off + nb].view(dtype).view(mshape).permute(inv))
        return out

    # -- streaming -------------------------------------------------------------

    def _issue(self, idx: int) -> None:
        """Copy streamed layer ``idx`` into its ring slot (on the copy stream)."""
        j = idx - self.n_resident
        slot = j % len(self._ring)
        for other, (s, _) in self._inflight.items():
            if s == slot:
                raise RuntimeError(f"ring slot {slot} still holds layer {other}, not yet taken")
        dst, src = self._ring[slot], self._packed[j]
        if not self._cuda:
            dst.copy_(src)
            self._inflight[idx] = (slot, None)
            return
        cs = self._copy_stream
        # every reader of the slot's previous layer is enqueued on the compute
        # stream by now: the copy waits for them to finish
        cs.wait_stream(torch.cuda.current_stream(self.device))
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(cs):
            start.record(cs)
            dst.copy_(src, non_blocking=True)
            done.record(cs)
        self._copies.append((start, done))
        self._inflight[idx] = (slot, done)
        if not self.overlap:
            cs.synchronize()

    def prefetch(self, idx: int) -> None:
        """Start the host → device copy of layer ``idx`` (the reference's load_layer).

        Layer ``idx`` takes the ring slot of layer ``idx - ring size``; every
        use of that layer must be enqueued before this call. A no-op for
        resident layers, layers past the end, layers already in flight, and
        with ``overlap=False``."""
        if not self.overlap or idx >= self.num_layers or idx < self.n_resident or idx in self._inflight:
            return
        self._issue(idx)

    def prefetch_after(self, idx: int) -> None:
        """Keep the ``ring - 1`` layers after ``idx`` in flight, to be called
        before layer ``idx`` is taken: each takes the slot of a layer whose
        every use is enqueued by then (the ``max_inflight_layers`` window)."""
        for a in range(idx + 1, idx + len(self._ring)):
            self.prefetch(a)

    def get_layer(self, idx: int) -> Dict[str, Any]:
        """Layer ``idx``'s device parameters: views of the resident prefix, or of
        the ring slot its copy landed in (the compute stream waits for the copy)."""
        if idx < self.n_resident:
            return slice_layer(self.resident, idx)
        if not self._ring:
            raise RuntimeError(f"layer {idx} asked for on the device, but the manager was built with no ring")
        if idx not in self._inflight:
            self._issue(idx)
        slot, done = self._inflight.pop(idx)
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return self._views[slot]

    def host_layer(self, idx: int) -> Dict[str, Any]:
        """Streamed layer ``idx``'s parameters in host memory (views of its
        packed buffer), for the host tier."""
        return self._host_views[idx - self.n_resident]

    # -- reporting -------------------------------------------------------------

    def copy_stats(self) -> Dict[str, float]:
        """Copies since the last call: their count, bytes and copy-stream time
        (CUDA events around each copy on the copy stream); resets the record."""
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
        ms = sum(s.elapsed_time(d) for s, d in self._copies)
        n = len(self._copies)
        self._copies = []
        return {"copies": n, "bytes": float(n * self.layer_bytes), "copy_ms": ms}

    def memory_report(self) -> Dict[str, float]:
        total = self._total_bytes
        res = total * self.n_resident / max(self.num_layers, 1)
        return {
            "layer_bytes_total": float(total),
            "resident_bytes": float(res),
            "resident_layers": float(self.n_resident),
            "streamed_layers": float(self.num_layers - self.n_resident),
            "hbm_resident_frac": float(res / total) if total else 1.0,
            "streamed_layer_bytes": float(self.layer_bytes),  # one packed layer, padded
            "ring_bytes": float(len(self._ring) * self.layer_bytes),
        }

    def close(self) -> None:
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
        self._inflight.clear()
        self._copies = []
