"""Weight and KV-cache quantization (port of ``lia_tpu/ops/quant.py``).

**Weights.** A quantized weight is a :class:`QuantizedWeight` record: codes
``q``, grouped scales ``s`` ``[..., ng, N]``, a format tag ``fmt`` (one of
:data:`QUANT_FORMATS`) and, for the asymmetric and static formats, ``z``.
int4 and NF4 codes are packed two per byte with the reference's GLOBAL
half-split: byte ``r`` of a ``[K/2, N]`` weight holds row ``r`` in its low
nibble and row ``K/2 + r`` in its high nibble. The quantizers take a tensor,
quantized on its own device a layer at a time (the card quantizes a tree
without copying it to the host), or a numpy array, quantized as a CPU
tensor. They divide in fp32 and round half to even (``torch.round``, as the
reference's numpy quantizers use ``np.rint``), so their codes and scales are
bit-equal to the reference's for equal inputs.

:func:`quantized_matmul` dispatches by format:

- ``woq_int8_dyn`` / ``static_int8``: int8 activations × int8 weights with
  exact int32 sums, rescaled in fp32 (plain XLA dots in the reference; on the
  card ``torch._int_mm``, see :func:`_int8_dot`);
- ``woq_int4_dyn`` / ``woq_int4z_dyn``: the W4A8 kernel
  (:func:`lia_tpu_torch.ops.cuda_matmul.w4a8_matmul`), or its stacked entry
  (:func:`~lia_tpu_torch.ops.cuda_matmul.w4a8_matmul_stacked`) for a
  :class:`QuantizedWeightRef`, one layer of a stack;
- ``woq_int8`` / ``woq_int4`` / ``woq_nf4``: the weight-only kernel
  (:func:`~lia_tpu_torch.ops.cuda_matmul.woq_matmul`), ``woq_int4z``
  its zero-point form (:func:`~lia_tpu_torch.ops.cuda_matmul.woq4z_matmul`);
- any shape the kernels cannot take: ``dequantize`` to bf16, then one
  matmul with fp32 accumulation, as the reference's last branch.

The reference's Mosaic tiling rules (``_w4a8_blocks``, ``_pallas_woq_viable``)
are not carried over: a kernel runs for every shape its math allows (see
:func:`_kernel_takes`). The tensor-parallel matmul is not ported yet.

**KV cache.** One symmetric scale per token per head: codes int8
``[..., S, D]``, scales f32 ``[..., S]``, bit-equal to the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from lia_tpu_torch.config import ModelConfig, QuantConfig

QUANT_FORMATS = (
    "woq_int8", "woq_int8_dyn", "woq_int4", "woq_int4_dyn", "woq_int4z",
    "woq_int4z_dyn", "woq_nf4", "static_int8"
)

# NF4 codebook (QLoRA "normal float": quantiles of N(0,1) scaled to [-1, 1]).
NF4_CODEBOOK = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    np.float32,
)
_NF4_BOUNDARIES = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2.0


class QuantizedWeight(NamedTuple):
    """Quantized ``[..., K, N]`` weight: codes ``q`` (int8 ``[..., K, N]``, or
    uint8 ``[..., K/2, N]`` half-split nibbles), f32 scales ``s`` ``[..., ng, N]``,
    the format tag and ``z``: per-group zero-points ``[..., ng, N]`` for
    ``woq_int4z*`` (raw codes, ``w = (c - z) * s``), the static per-tensor
    activation scale ``[...]`` for ``static_int8``, else None."""

    q: torch.Tensor
    s: torch.Tensor
    fmt: str
    z: Optional[torch.Tensor] = None

    def map(self, fn) -> "QuantizedWeight":
        """The record with ``fn`` applied to each of its tensors."""
        return QuantizedWeight(fn(self.q), fn(self.s), self.fmt, None if self.z is None else fn(self.z))


class QuantizedWeightRef(NamedTuple):
    """Layer ``idx`` of a STACKED quantized record (``q`` ``[L, ...]``), kept
    whole so the stacked W4A8 kernel reads the layer's codes, scales and
    zero-points in place at the index ``layer`` holds in device memory (a 0-d
    int32 tensor on the stack's device, equal to ``idx``). A captured decode
    step can then replay its layer loop without a host-side index."""

    q: torch.Tensor
    s: torch.Tensor
    fmt: str
    z: Optional[torch.Tensor]
    idx: int
    layer: torch.Tensor

    def sliced(self) -> QuantizedWeight:
        """The layer's record as views into the stack (the per-layer path)."""
        return QuantizedWeight(self.q[self.idx], self.s[self.idx], self.fmt,
                               None if self.z is None else self.z[self.idx])


def is_quantized(w: Any) -> bool:
    return isinstance(w, (QuantizedWeight, QuantizedWeightRef))


_STACKED_KERNEL_FMTS = ("woq_int4_dyn", "woq_int4z_dyn")


def stackable_ref(rec: Any) -> bool:
    """Whether the decode loop, with the stacked-W4A8 gate on, addresses this
    stacked record through a :class:`QuantizedWeightRef`: a ``[L, K/2, N]``
    ``woq_int4_dyn`` or ``woq_int4z_dyn`` record."""
    return isinstance(rec, QuantizedWeight) and rec.fmt in _STACKED_KERNEL_FMTS and rec.q.ndim == 3


def stacked_ref(rec: QuantizedWeight, idx: int, layers: torch.Tensor) -> QuantizedWeightRef:
    """Layer ``idx`` of ``rec`` as a reference; ``layers`` is a device
    ``arange(L)`` (int32) whose entry ``idx`` the kernel reads."""
    L = rec.q.shape[0]
    if not 0 <= idx < L:
        raise IndexError(f"layer {idx} outside a stack of {L}")
    return QuantizedWeightRef(rec.q, rec.s, rec.fmt, rec.z, idx, layers[idx])


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded, as numpy divides. On the card, dividing by
    a Python number multiplies by its reciprocal, up to one ulp off, which
    moves a scale's rounding and, where the grid meets a tie, a code or a
    zero-point; a divisor on the tensor's device keeps the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _tensor(w) -> torch.Tensor:
    """A tensor as it is; a numpy (or array-like) weight as an fp32 CPU tensor."""
    if isinstance(w, torch.Tensor):
        return w
    return torch.from_numpy(np.require(w, np.float32, "W"))


# ---------------------------------------------------------------------------
# Quantize (at load time, on the weight's device)
# ---------------------------------------------------------------------------


def _pack_halves(codes):
    """Codes ``[..., K, N]`` in 0..15 → half-split bytes ``[..., K/2, N]``."""
    K = codes.shape[-2]
    return (codes[..., : K // 2, :] & 0xF) | (codes[..., K // 2 :, :] << 4)


def _weight_formats(qc: QuantConfig):
    """(int8 format, int4 format) of ``qc``'s activation mode."""
    if qc.act_quant != "dynamic":
        return "woq_int8", "woq_int4"
    if qc.weight_dtype == "int8":
        return "woq_int8_dyn", "woq_int4"
    if qc.weight_dtype == "int4":
        return "woq_int8", "woq_int4_dyn"
    # NF4 codebook values are not integers: no int8 product exists
    raise ValueError("act_quant='dynamic' needs int8 or int4 weights")


def _quantize_slab(w: torch.Tensor, weight_dtype: str, g: int):
    """One ``[K, N]`` weight (fp32, on its device) → (codes, scales ``[K/g, N]``):
    the reference's numpy arithmetic (fp32 division, round half to even)."""
    K, N = w.shape
    wg = w.reshape(K // g, g, N)
    if weight_dtype == "nf4":
        scale = torch.clamp(wg.abs().amax(dim=-2, keepdim=True), min=1e-8)
        bounds = torch.from_numpy(_NF4_BOUNDARIES).to(w.device)
        codes = torch.searchsorted(bounds, (wg / scale).contiguous()).to(torch.uint8).reshape(K, N)
        return _pack_halves(codes), scale.squeeze(-2)
    qmax = 127.0 if weight_dtype == "int8" else 7.0
    scale = torch.clamp(true_div(wg.abs().amax(dim=-2, keepdim=True), qmax), min=1e-8)
    q = torch.round(wg / scale).clamp_(-qmax - 1, qmax).to(torch.int8).reshape(K, N)
    if weight_dtype == "int4":  # biased nibbles in [0, 15]
        return _pack_halves((q + 8).to(torch.uint8)), scale.squeeze(-2)
    return q, scale.squeeze(-2)


def _per_layer(w: torch.Tensor, fn, rows: int, dtype):
    """``fn`` over each ``[K, N]`` slab of ``w`` ``[..., K, N]`` (one slab's fp32
    copy at a time, so a stacked tree quantizes within one layer's working
    memory): codes ``[..., rows, N]`` of ``dtype`` and the scales ``fn`` gives."""
    *lead, K, N = w.shape
    flat = w.detach().reshape(-1, K, N)
    q = s = None
    for i in range(flat.shape[0]):
        qi, si = fn(flat[i].float())
        if q is None:
            q = torch.empty((flat.shape[0], rows, N), dtype=dtype, device=w.device)
            s = torch.empty((flat.shape[0], *si.shape), dtype=torch.float32, device=w.device)
        q[i], s[i] = qi, si
    return q.reshape(*lead, rows, N), s.reshape(*lead, *s.shape[1:])


def quantize_weight(w, qc: QuantConfig) -> QuantizedWeight:
    """Quantize ``[..., in, out]`` symmetric per-(group, out-channel); group_size
    -1 is one group over the whole ``in`` axis (per-out-channel scales). A
    tensor is quantized on its device, a numpy array as a CPU tensor."""
    *lead, K, N = w.shape
    g = K if qc.group_size <= 0 else qc.group_size
    if K % g:
        raise ValueError(f"in-dim {K} not divisible by group size {g}")
    ng = K // g
    fmt8, fmt4 = _weight_formats(qc)
    if fmt8 == "woq_int8_dyn" and ng != 1:
        raise ValueError("act_quant='dynamic' with int8 needs per-channel scales (group_size=-1): "
                         "the int32 dot sums the whole K axis")
    if qc.weight_dtype not in ("int8", "int4", "nf4"):
        raise ValueError(qc.weight_dtype)
    fmt = {"int8": fmt8, "int4": fmt4, "nf4": "woq_nf4"}[qc.weight_dtype]
    packed = qc.weight_dtype != "int8"
    q, s = _per_layer(_tensor(w), lambda x: _quantize_slab(x, qc.weight_dtype, g), K // 2 if packed else K,
                      torch.uint8 if packed else torch.int8)
    return QuantizedWeight(q, s, fmt)


def retag_dynamic_act(params):
    """Every int4 record of a tree in its dynamic-activation form
    (``woq_int4 → woq_int4_dyn``, ``woq_int4z → woq_int4z_dyn``): the payload is
    the same, only the matmul changes (int8 activations, the W4A8 kernel).
    Runs a GPTQ tree on the W4A8 path."""
    remap = {"woq_int4": "woq_int4_dyn", "woq_int4z": "woq_int4z_dyn"}
    if isinstance(params, dict):
        return {k: retag_dynamic_act(v) for k, v in params.items()}
    if is_quantized(params) and params.fmt in remap:
        if params.fmt == "woq_int4z" and params.z is None:
            return params  # malformed asymmetric record: left on the dequantize path
        return params._replace(fmt=remap[params.fmt])
    return params


def _static_slab(w: torch.Tensor):
    s = torch.clamp(true_div(w.abs().amax(dim=-2, keepdim=True), 127.0), min=1e-8)
    return torch.round(w / s).clamp_(-128, 127).to(torch.int8), s


def quantize_weight_static(w, act_amax) -> QuantizedWeight:
    """W8A8 static quantization of ``[..., K, N]``: symmetric per-out-channel
    int8 weights; ``z = act_amax / 127`` is the static activation scale, one
    per leading index. A tensor is quantized on its device (``act_amax`` with
    it), a numpy array as a CPU tensor."""
    *lead, K, N = w.shape
    w = _tensor(w)
    q, s = _per_layer(w, _static_slab, K, torch.int8)
    amax = _tensor(act_amax).to(device=w.device, dtype=torch.float32)
    act_scale = torch.clamp(true_div(amax, 127.0), min=1e-8).expand(tuple(lead)).clone()
    return QuantizedWeight(q, s, "static_int8", act_scale)


# The activation maximum (collect_act_scales' tap) that sets each decoder
# linear's static scale.
STATIC_TAPS = {
    ("attn", "wq"): "qkv", ("attn", "wk"): "qkv", ("attn", "wv"): "qkv",
    ("attn", "wo"): "wo_in",
    ("mlp", "w1"): "mlp_in", ("mlp", "wg"): "mlp_in",
    ("mlp", "w2"): "w2_in",
}


def quantize_params_static(cfg: ModelConfig, params: Dict[str, Any], act_scales: Dict[str, Any]):
    """Static-INT8 (W8A8) quantization of every decoder-layer linear
    (``[L, K, N]``), on the tree's device. ``act_scales``: the per-channel
    activation maxima of :func:`lia_tpu_torch.ops.smoothquant.collect_act_scales`,
    reduced here to one static per-tensor scale per (layer, linear).
    Embeddings, norms, biases and the head stay as they are."""
    out = dict(params)
    new_layers: Dict[str, Any] = {}
    for grp_name, grp in params["layers"].items():
        new_grp: Dict[str, Any] = {}
        for k, v in grp.items():
            obs = STATIC_TAPS.get((grp_name, k))
            if obs is not None and not is_quantized(v) and v.ndim == 3:
                amax = _tensor(act_scales[obs]).float().amax(dim=-1)  # [L]
                new_grp[k] = quantize_weight_static(v, amax)
            else:
                new_grp[k] = v
        new_layers[grp_name] = new_grp
    out["layers"] = new_layers
    return out


def _quantize_layer_tree(layers: Dict[str, Any], qc: QuantConfig) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for grp_name, grp in layers.items():
        out[grp_name] = {
            # [L, K, N] dense linears and [L, E, K, N] experts; the router stays fp
            k: quantize_weight(v, qc) if k.startswith("w") and v.ndim in (3, 4) else v
            for k, v in grp.items()
        }
    return out


def quantize_params(cfg: ModelConfig, params: Dict[str, Any], qc: QuantConfig):
    """Quantize every decoder-layer matmul weight (stacked ``[L, in, out]``)
    and, with ``qc.quant_lm_head``, the lm_head (a transposed copy for tied
    embeddings). Embeddings, norms and biases stay in their type."""
    if cfg.encoder_decoder or "enc" in params or "output" in params:
        raise NotImplementedError(f"{cfg.family}: quantizing this family's tree is not ported yet")
    out = dict(params)
    if "layers" in params:
        out["layers"] = _quantize_layer_tree(params["layers"], qc)
    if not qc.quant_lm_head:
        return out
    if "lm_head" in out and not is_quantized(out["lm_head"]) and out["lm_head"].ndim == 2:
        w = out["lm_head"]
        if qc.weight_dtype == "int4":
            out["lm_head"] = quantize_head_2d(w, qc)
        else:
            K = w.shape[0]
            g = qc.group_size if qc.group_size > 0 else K
            if K % g == 0:
                out["lm_head"] = quantize_weight(w, qc)
    elif "lm_head" not in out and "embed_tokens" in out and cfg.tie_embeddings:
        out["lm_head"] = quantize_tied_head(out["embed_tokens"], qc)
    return out


def quantize_tied_head(embed, qc: QuantConfig) -> QuantizedWeight:
    """Quantized transposed ``[E, V]`` head copy for tied embeddings; the fp
    table stays for the token gather."""
    return quantize_head_2d(_tensor(embed).detach().T, qc)


def head_config(E: int, V: int, qc: QuantConfig):
    """(QuantConfig, padded vocab) of an ``[E, V]`` head: int4 needs E % 256
    and whole groups per packed half, and then pads V to a multiple of 128
    (OPT: 50272 → 50304); otherwise the head takes per-channel int8."""
    g = qc.group_size
    use_int4 = (
        qc.weight_dtype == "int4"
        and E % 256 == 0
        and (g <= 0 or ((E // 2) % g == 0 and (8 * g) % 128 == 0))
    )
    hqc = QuantConfig(
        weight_dtype="int4" if use_int4 else "int8",
        group_size=g if use_int4 else -1,
        sym=qc.sym,
        act_quant=qc.act_quant,
    )
    return hqc, V + (-V % 128 if use_int4 else 0)


def quantize_head_2d(w, qc: QuantConfig) -> QuantizedWeight:
    """Quantize an ``[E, V]`` head as :func:`head_config` says; the pad columns
    are exact zeros, and :func:`lia_tpu_torch.models.transformer.lm_head`
    slices them off."""
    E, V = w.shape
    hqc, Vp = head_config(E, V, qc)
    if Vp > V:
        w = torch.nn.functional.pad(_tensor(w), (0, Vp - V))
    return quantize_weight(w, hqc)


# ---------------------------------------------------------------------------
# Dequantize and the quantized matmul
# ---------------------------------------------------------------------------


def unpack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Half-split packed bytes ``[..., K/2, N]`` → codes ``[..., K, N]`` (int32, 0..15)."""
    q = q.to(torch.int32)
    return torch.cat([q & 0xF, (q >> 4) & 0xF], dim=-2)


def dequantize(rec: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """The fp weight ``[..., K, N]``: codes times scales in fp32, cast once to ``dtype``."""
    if rec.fmt == "woq_nf4":
        qi = torch.from_numpy(NF4_CODEBOOK).to(rec.q.device)[unpack_nibbles(rec.q).long()]
    elif rec.fmt.startswith("woq_int4"):
        qi = unpack_nibbles(rec.q) - (0 if rec.fmt.startswith("woq_int4z") else 8)
    else:
        qi = rec.q
    *lead, K, N = qi.shape
    ng = rec.s.shape[-2]
    wg = qi.reshape(*lead, ng, K // ng, N).float()
    if rec.fmt.startswith("woq_int4z"):
        wg = wg - rec.z[..., :, None, :]
    w = wg * rec.s[..., :, None, :]
    return w.reshape(*lead, K, N).to(dtype)


def matmul_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 [M, K] @ w [K, N] with fp32 accumulation and fp32 output."""
    if x2.dtype == torch.float32:
        return x2 @ w.float()
    if x2.is_cuda:
        return torch.mm(x2, w.to(x2.dtype), out_dtype=torch.float32)
    return x2.float() @ w.float()


# torch._int_mm on the card takes M > 16 rows (decode has 16) and K, N
# multiples of 8; rows are padded with zeros up to this many.
_INT_MM_MIN_ROWS = 32


def _int8_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] × int8 [K, N] → int32 [M, N]. The CPU sums in float64
    (exact, see :func:`lia_tpu_torch.ops.cuda_matmul.exact_dot`); the card runs
    ``torch._int_mm`` (cuBLASLt int8 × int8 → int32), the counterpart of the
    reference's plain XLA int8 dot. ``_int_mm`` refuses M ≤ 16 (it takes 17
    rows and more, with K and N multiples of 8, and the weight row- or
    column-major), so decode's 16 rows are padded to 32; ``to_device`` keeps
    the weight column-major, its fast layout."""
    if not xq.is_cuda:
        from lia_tpu_torch.ops.cuda_matmul import exact_dot

        return exact_dot(xq, q).to(torch.int32)
    M = xq.shape[0]
    if M < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(_INT_MM_MIN_ROWS - M, xq.shape[1])])
    return torch._int_mm(xq, q)[:M]


def quantize_act(x2: torch.Tensor):
    """Per-token symmetric int8 activations: (codes int8 [M, K], scales f32 [M, 1])."""
    xf = x2.float()
    s_x = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.round(xf / s_x).to(torch.int8), s_x


def _kernel_takes(K: int, ng: int, packed: bool) -> bool:
    """Whether the matmul kernels take a weight of in-dim K and ng groups.

    The math needs, for the half-split packed formats, whole groups in each
    packed half (ng = 1 or ng even, (K/2) % g == 0). The kernels add their
    own alignment: they step 16 weight rows at a time, so the rows they walk
    (K/2 for packed, K for int8) and the group size must be multiples of 16.
    Every OPT and Llama width meets it; other shapes are dequantized."""
    if ng < 1 or K % ng:
        return False
    g = K // ng
    rows = K // 2 if packed else K
    if packed and (K % 2 or (ng > 1 and (ng % 2 or rows % g))):
        return False
    return rows % 16 == 0 and (ng == 1 or g % 16 == 0)


def quantized_matmul(x: torch.Tensor, rec) -> torch.Tensor:
    """x [..., K] @ dequant(rec) with fp32 accumulation; returns fp32 [..., N].
    ``rec`` is a :class:`QuantizedWeight` or a :class:`QuantizedWeightRef`."""
    from lia_tpu_torch.ops import cuda_matmul as cm

    fmt = rec.fmt
    lead, K = x.shape[:-1], x.shape[-1]
    N = rec.q.shape[-1]
    x2 = x.reshape(-1, K)
    if fmt == "static_int8":
        # static per-tensor activation scale, int8 × int8 → int32, rescale
        s_x = rec.z
        xq = torch.clamp(torch.round(x2.float() / s_x), -127, 127).to(torch.int8)
        # int32 × f32 converts the sums to f32 inside the one multiply
        y = torch.mul(_int8_dot(xq, rec.q), s_x * rec.s[..., 0, :])
        return y.reshape(*lead, N)
    if fmt == "woq_int8_dyn":
        xq, s_x = quantize_act(x2)
        y = torch.mul(_int8_dot(xq, rec.q), s_x * rec.s[..., 0, :])
        return y.reshape(*lead, N)
    ng = rec.s.shape[-2]
    packed = fmt.startswith("woq_int4") or fmt == "woq_nf4"
    ref = isinstance(rec, QuantizedWeightRef)  # one layer of a stack, its index on the device
    takes = (ref or rec.q.ndim == 2) and _kernel_takes(K, ng, packed)
    if takes and (fmt == "woq_int4_dyn" or (fmt == "woq_int4z_dyn" and rec.z is not None)):
        xq, s_x = quantize_act(x2)
        z = rec.z if fmt == "woq_int4z_dyn" else None
        if ref:
            y = cm.w4a8_matmul_stacked(xq, s_x, rec.q, rec.s, z, rec.layer)
        else:
            y = cm.w4a8_matmul(xq, s_x, rec.q, rec.s, z)
    elif ref:  # no stacked kernel for this shape: the layer's views
        return quantized_matmul(x, rec.sliced())
    elif takes and fmt.startswith("woq_int4z") and rec.z is not None:
        y = cm.woq4z_matmul(x2, rec.q, rec.s, rec.z)
    elif takes and fmt in ("woq_int8", "woq_int4", "woq_nf4"):
        kind = "nf4" if fmt == "woq_nf4" else ("int4" if packed else "int8")
        y = cm.woq_matmul(x2, rec.q, rec.s, kind)
    else:
        # the reference's last branch: the weight rounds to bf16 whatever x's type
        y = matmul_f32(x2, dequantize(rec, torch.bfloat16))
    return y.reshape(*lead, N)


# ---------------------------------------------------------------------------
# INT8 KV cache (per-token scales)
# ---------------------------------------------------------------------------


class QuantizedKV(NamedTuple):
    """INT8 KV plane(s) with per-token scales: ``q`` int8 [..., S, D], ``s`` f32 [..., S]."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):  # logical (dequantized) shape
        return self.q.shape


def is_quantized_kv(x: Any) -> bool:
    return isinstance(x, QuantizedKV)


def quantize_kv(x: torch.Tensor) -> QuantizedKV:
    """Quantize head-major K/V [..., S, D] with one symmetric scale per token."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)  # [..., S]
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127).to(torch.int8)
    return QuantizedKV(q, scale)


def dequantize_kv(kv: QuantizedKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (kv.q.float() * kv.s[..., None]).to(dtype)
