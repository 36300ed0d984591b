"""The port's kernel-route gates (port of the two gates of ``lia_tpu/ops/dispatch.py``).

Two routes of the reference run a kernel only behind a gate that is off by
default, and so do the port's:

- :func:`stacked_w4a8_enabled`: the decode loop hands each layer's
  ``woq_int4_dyn`` / ``woq_int4z_dyn`` weights to the W4A8 kernel as a
  :class:`~lia_tpu_torch.ops.quant.QuantizedWeightRef` over the whole stack,
  whose layer index the kernel reads from device memory
  (:func:`lia_tpu_torch.ops.cuda_matmul.w4a8_matmul_stacked`);
- :func:`fused_mlp_enabled`: a pre-norm layer whose MLP fits the kernel runs
  norm, up-projection, activation, down-projection and residual in one launch
  (:func:`lia_tpu_torch.ops.cuda_mlp.fused_mlp`).

The reference turned both off after model-level results on its own hardware;
those results say nothing of this card, and the gates stay off here so the
default paths launch what they launched before. The reference's other terms
(``use_pallas``, a tensor-parallel mesh) have no counterpart: the port always
runs its kernels and has no mesh yet.
"""

from __future__ import annotations

_STACKED_W4A8 = False
_FUSED_MLP = False


def set_stacked_w4a8(v: bool) -> None:
    global _STACKED_W4A8
    _STACKED_W4A8 = bool(v)


def stacked_w4a8_enabled() -> bool:
    """Stacked-weight W4A8 route of the decode loop; default off."""
    return _STACKED_W4A8


def set_fused_mlp(v: bool) -> None:
    global _FUSED_MLP
    _FUSED_MLP = bool(v)


def fused_mlp_enabled() -> bool:
    """One-launch fused MLP route; default off."""
    return _FUSED_MLP
