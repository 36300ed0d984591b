"""The GPTQ algorithm: Hessian-guided, error-compensated rounding (port of
``lia_tpu/ops/gptq.py``).

:mod:`lia_tpu_torch.utils.gptq` reads checkpoints that AutoGPTQ made; this
module makes GPTQ weights itself from calibration prompts, on the tree's
device (the card by default, the CPU in tests):

- **Hessians**: each layer runs once over the calibration batch
  (:func:`lia_tpu_torch.ops.smoothquant.tapped_layer`, the flash prefill
  kernel on the card), and the Gram matrices ``XᵀX`` of its four linear
  inputs are taken in fp32 over the real positions, one layer alive at a
  time.
- **The solver** (:func:`gptq_quantize_matrix`) runs in float64 on the
  weights' device with the reference's numpy arithmetic: dead channels,
  ``percdamp``, act-order with static groups, the upper Cholesky factor of
  H⁻¹ (``torch.linalg.inv``, ``torch.linalg.cholesky_ex``, with the
  reference's heavier damping where the factorisation fails, as numpy's
  ``LinAlgError``), the group-aligned block walk and the lazy update of the
  rows below a block. Its row walk launches a few small operations a row:
  on the card it is bound by host time.
- **Sequential propagation**: layer *l*'s Hessians come from the hidden
  stream through the already-quantized layers 0..l-1, so later layers
  compensate earlier layers' error.

The walk treats each output column on its own, so the weights that share a
Hessian (wq|wk|wv; w1|wg) are solved as one ``[K, ΣN]`` matrix and split
after: the same codes as solving each alone, in a third of the row steps.
Output formats are the port's own (:mod:`lia_tpu_torch.ops.quant`):
``woq_int4z`` (asymmetric per-group zero-points, global half-split packing)
for 4 bits, ``woq_int8`` (symmetric) for 8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lia_tpu_torch.config import ModelConfig
from lia_tpu_torch.models import transformer as T
from lia_tpu_torch.ops.quant import true_div

__all__ = ["gptq_quantize_matrix", "gptq_quantize_params"]

# Each Hessian (0: q/k/v input, 1: wo input, 2: MLP input, 3: w2 input) and the
# weights it feeds, solved together.
SHARED_SOLVES = (
    (0, "attn", ("wq", "wk", "wv")),
    (1, "attn", ("wo",)),
    (2, "mlp", ("w1", "wg")),
    (3, "mlp", ("w2",)),
)


def _group_params(slab: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric (4-bit) or symmetric (8-bit) parameters of one group slab
    ``[g, N]``: (scale [N], zero [N]); the symmetric zero is 0 and its codes
    lie in [-127, 127]."""
    if bits == 4:
        qmax = 15.0
        wmin = torch.clamp(slab.amin(dim=0), max=0.0)
        wmax = torch.clamp(slab.amax(dim=0), min=0.0)
        scale = true_div(wmax - wmin, qmax)
        scale = torch.where(scale <= 1e-12, 1.0, scale)
        zero = torch.clamp(torch.round(-wmin / scale), 0.0, qmax)
        return scale, zero
    scale = torch.clamp(true_div(slab.abs().amax(dim=0), 127.0), min=1e-12)
    return scale, torch.zeros_like(scale)


def _quant_row(row: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, bits: int):
    """Round one in-channel row to the grid: (codes, dequantized)."""
    if bits == 4:
        q = torch.clamp(torch.round(row / scale) + zero, 0.0, 15.0)
        return q, (q - zero) * scale
    q = torch.clamp(torch.round(row / scale), -127.0, 127.0)
    return q, q * scale


def _upper_cholesky(Hinv: torch.Tensor) -> torch.Tensor:
    """U with ``Hinv = UᵀU``; where the factorisation fails (numpy's
    ``LinAlgError``: a leading minor not positive), once more after adding
    ``1e-6 · max(1, max |diag|)`` to the diagonal."""
    L, info = torch.linalg.cholesky_ex(Hinv)
    if int(info) != 0:
        K = Hinv.shape[0]
        Hinv = Hinv + torch.eye(K, dtype=Hinv.dtype, device=Hinv.device) * (
            1e-6 * max(float(Hinv.diagonal().abs().max()), 1.0))
        L, info = torch.linalg.cholesky_ex(Hinv)
        if int(info) != 0:
            raise torch.linalg.LinAlgError(f"GPTQ: H^-1 is not positive definite (minor {int(info)})")
    return L.T


def gptq_quantize_matrix(
    w,
    H,
    bits: int = 4,
    group_size: int = -1,
    percdamp: float = 0.01,
    actorder: bool = False,
):
    """GPTQ-quantize one weight ``[K, N]`` (``x @ w``: rows are in-channels,
    the Hessian's axis) against the input Gram matrix ``H`` ``[K, K]``, in
    float64 on ``w``'s device (numpy inputs on the CPU).

    Damp H's diagonal, take the upper Cholesky factor U of H⁻¹, then walk the
    in-channels in order: round each row to the grid and push its scaled
    residual ``(w_i − q_i) / U_ii`` into the rows not yet quantized through
    U's row, so later rounding absorbs earlier error. ``H = I`` is plain
    round to nearest. ``actorder`` walks rows by decreasing Hessian diagonal
    with STATIC per-group parameters (taken from the original slabs up
    front), so groups stay contiguous in the original order.

    Returns (codes [K, N] float64 — biased [0, 15] for 4 bits, signed
    [-127, 127] for 8; scales [ng, N] fp32; zeros [ng, N] fp32)."""
    dev = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    w = torch.as_tensor(w, device=dev).to(torch.float64).clone()
    H = torch.as_tensor(H, device=dev).to(torch.float64).clone()
    K, N = w.shape
    g = K if group_size <= 0 or group_size >= K else int(group_size)
    if K % g:
        raise ValueError(f"in-dim {K} not divisible by group size {g}")
    ng = K // g
    ar = torch.arange(K, device=dev)

    dead = H.diagonal() == 0
    if bool(dead.any()):
        idx = dead.nonzero()[:, 0]
        H[idx, idx] = 1.0
        w[idx, :] = 0.0
    mean_diag = float(H.diagonal().mean())
    H[ar, ar] += percdamp * max(mean_diag, 1e-12)

    if actorder:
        perm = torch.argsort(-H.diagonal(), stable=True)
        inv_perm = torch.argsort(perm)
        w = w[perm]
        H = H[perm][:, perm]

    Hinv = torch.linalg.inv(H)
    Hinv = (Hinv + Hinv.T) * 0.5
    U = _upper_cholesky(Hinv)

    scales = torch.zeros((ng, N), dtype=torch.float64, device=dev)
    zeros = torch.zeros((ng, N), dtype=torch.float64, device=dev)
    codes = torch.zeros((K, N), dtype=torch.float64, device=dev)

    if actorder:
        # static groups: the parameters from the original (unpermuted) slabs
        w0 = w[inv_perm]
        for gi in range(ng):
            scales[gi], zeros[gi] = _group_params(w0[gi * g : (gi + 1) * g], bits)
        row_group = (perm // g).tolist()

    # blocks aligned to groups, so a group's parameters come from rows that
    # took every earlier block's update
    B = g if (not actorder and 1 < g <= 256) else min(128, K)
    i1 = 0
    while i1 < K:
        i2 = min(i1 + B, K)
        W1 = w[i1:i2].clone()
        Err1 = torch.zeros_like(W1)
        U1 = U[i1:i2, i1:i2]
        for i in range(i2 - i1):
            r = i1 + i
            if actorder:
                gi = row_group[r]
            else:
                gi = r // g
                if r % g == 0:
                    scales[gi], zeros[gi] = _group_params(w[r : r + g], bits)
            q, deq = _quant_row(W1[i], scales[gi], zeros[gi], bits)
            codes[r] = q
            err = (W1[i] - deq) / U1[i, i]
            if i + 1 < i2 - i1:
                W1[i + 1 :] -= torch.outer(U1[i, i + 1 :], err)
            Err1[i] = err
        w[i1:i2] = W1
        if i2 < K:
            w[i2:] -= U[i1:i2, i2:].T @ Err1
        i1 = i2

    if actorder:
        codes = codes[inv_perm]
    return codes, scales.float(), zeros.float()


def _to_quantized_weight(codes: torch.Tensor, s: torch.Tensor, z: torch.Tensor, bits: int):
    """(codes, scales, zeros) of one layer → the format's raw tensors: 4 bits
    → half-split packed uint8 and the zeros; 8 bits → int8, no zeros."""
    K = codes.shape[0]
    if bits == 4:
        b = codes.to(torch.uint8)
        return (b[: K // 2] & 0xF) | (b[K // 2 :] << 4), s, z
    return codes.to(torch.int8), s, None


def _gram(a: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked ``XᵀX`` of a linear's input ``[B, S, K]`` over real positions (fp32)."""
    af = (a.float() * valid).reshape(-1, a.shape[-1])
    return af.T @ af


@torch.inference_mode()
def gptq_quantize_params(
    cfg: ModelConfig,
    params,
    prompts: Sequence[Sequence[int]],
    bits: int = 4,
    group_size: int = 128,
    percdamp: float = 0.01,
    actorder: bool = False,
    pad_id: Optional[int] = None,
):
    """GPTQ over every decoder linear, layer after layer, on the tree's
    device: take layer *l*'s four Hessians from the hidden stream, solve its
    seven weights (three shared solves and two single ones), then run the
    layer again with its quantized weights to make layer *l+1*'s inputs.
    Embeddings, norms, biases and the head stay as they are. Returns the
    tree with stacked :class:`~lia_tpu_torch.ops.quant.QuantizedWeight`
    leaves (``woq_int4z`` for 4 bits, ``woq_int8`` for 8)."""
    from lia_tpu_torch.ops.quant import QuantizedWeight
    from lia_tpu_torch.ops.smoothquant import Calibration, _refuse_moe, tapped_layer

    if bits not in (4, 8):
        raise ValueError(f"unsupported GPTQ bit-width {bits}")
    _refuse_moe(cfg, "GPTQ calibration")
    cal = Calibration(cfg, params, prompts, cfg.pad_token_id if pad_id is None else pad_id)
    valid = cal.valid.float()
    fmt = "woq_int4z" if bits == 4 else "woq_int8"

    def eff_group(K: int) -> int:
        # per-channel where groups would straddle the half-split packing's
        # halves (the zero-point kernel takes whole groups a half)
        if bits == 4 and 0 < group_size < K and (K // 2) % group_size != 0:
            return -1
        return group_size

    layers = params["layers"]
    x = cal.embed(cfg, params)
    per_layer = []
    for l in range(cfg.num_layers):
        lp = T.layer_params(layers, l)
        _, acts = tapped_layer(cfg, lp, x, cal)
        hessians = [_gram(a, valid).double() for a in acts]
        del acts
        q_lp = {grp: dict(v) for grp, v in lp.items()}
        recs = {}
        for hi, grp, names in SHARED_SOLVES:
            names = [n for n in names if n in lp.get(grp, {})]
            if not names:
                continue
            ws = [lp[grp][n] for n in names]
            K = ws[0].shape[0]
            codes, s, z = gptq_quantize_matrix(
                torch.cat([w.float() for w in ws], dim=1), hessians[hi], bits=bits,
                group_size=eff_group(K), percdamp=percdamp, actorder=actorder,
            )
            col = 0
            for n, w in zip(names, ws):
                part = slice(col, col + w.shape[1])
                col += w.shape[1]
                qarr, sn, zn = _to_quantized_weight(codes[:, part], s[:, part].contiguous(),
                                                    z[:, part].contiguous(), bits)
                recs[(grp, n)] = (qarr, sn, zn)
                q_lp[grp][n] = QuantizedWeight(qarr, sn, fmt, zn)
        del hessians
        per_layer.append(recs)
        # the next layer's inputs come through the QUANTIZED layer
        x = tapped_layer(cfg, q_lp, x, cal)[0]

    out = dict(params)
    new_layers = {g: dict(v) for g, v in layers.items()}
    for grp, wn in per_layer[0]:
        parts = [per_layer[l][(grp, wn)] for l in range(cfg.num_layers)]
        qs, ss = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
        zs = torch.stack([p[2] for p in parts]) if bits == 4 else None
        new_layers[grp][wn] = QuantizedWeight(qs, ss, fmt, zs)
    out["layers"] = new_layers
    return out
