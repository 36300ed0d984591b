"""CUDA quantized-matmul kernels: wrappers, plain PyTorch versions and launch
counters (the counterpart of ``lia_tpu/ops/pallas_matmul.py``).

- :func:`w4a8_matmul`: int8 activations × half-split int4 weights, exact
  int32 sums per group (``csrc/w4a8_matmul.cu``);
- :func:`w4a8_matmul_stacked`: the same kernel against one layer of an
  ``[L, K/2, N]`` stack, the layer index read from device memory;
- :func:`woq_matmul`: bf16 activations × int8, int4 or NF4 weights, fp32
  sums per group (``csrc/woq_matmul.cu``);
- :func:`woq4z_matmul`: the same kernel over raw int4 codes with per-group
  zero-points (GPTQ), the zero-point folded into a row-sum correction.

Each wrapper takes its plain version for a tensor on the CPU, and launches the
kernel for a CUDA tensor, raising on anything the kernel does not take: a
CUDA tensor never falls back to the plain version. Each plain version repeats
its kernel's arithmetic: every group's sum is finished before its scale
applies, exactly for W4A8 (integer products summed in float64, see
:func:`exact_dot`) and in fp32 for the weight-only kernels. Each wrapper counts its
launches in ``<wrapper>.launches``.

Layouts are the reference's: activations ``[M, K]``, weights ``[K, N]`` (int8)
or ``[K/2, N]`` (byte ``r`` holds rows ``r`` and ``K/2 + r``), scales and
zero-points ``[ng, N]`` f32, outputs f32 ``[M, N]``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from lia_tpu_torch.ops.quant import NF4_CODEBOOK, _kernel_takes, unpack_nibbles

WOQ_KINDS = {"int8": 0, "int4": 1, "nf4": 2, "int4z": 3}  # the kernel's decode template
SMALL_M, SMALL_N = 16, 32  # rows up to which the kernels take their decode tile, and its columns
STAGE_ROWS = 64  # weight rows per shared-memory stage (csrc/qmatmul.cuh)
SPLIT_BLOCKS_PER_SM = 4  # decode: split K until about this many blocks per SM


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of two integer matrices, as float64. Every partial sum of
    int8 × int8 products over K ≤ 2^20 is an integer below 2^53, so float64
    holds it exactly in any summation order. The card's matmuls take no
    integers, and the CPU's integer matmuls are far slower than its float64
    BLAS, which a full-width layer on the CPU (chip_smoke.py's parity) needs."""
    return a.double() @ b.double()


def _groups(K: int, s: torch.Tensor):
    ng = s.shape[0]
    return ng, K // ng


def w4a8_matmul_plain(xq, sx, q, s, z=None) -> torch.Tensor:
    """``y = sx · Σ_g s_g · (xq_g @ (c − 8)_g − [z] rowsum(xq_g) · (z_g − 8))``:
    each group's integer sum exact, converted to fp32, then scaled."""
    M, K = xq.shape
    ng, g = _groups(K, s)
    codes = unpack_nibbles(q) - 8  # [K, N] signed
    acc = torch.zeros(M, q.shape[1], dtype=torch.float32, device=xq.device)
    for gi in range(ng):
        xg = xq[:, gi * g:(gi + 1) * g]
        part = exact_dot(xg, codes[gi * g:(gi + 1) * g]).float()
        if z is not None:
            rowsum = xg.to(torch.int32).sum(dim=1, keepdim=True).float()
            part = part - rowsum * (z[gi] - 8.0)
        acc = acc + part * s[gi]
    return acc * sx


def w4a8_matmul_stacked_plain(xq, sx, q, s, z=None, layer=0) -> torch.Tensor:
    """:func:`w4a8_matmul_plain` on layer ``layer`` (an int or a 0-d tensor) of
    a stacked ``[L, K/2, N]`` weight with ``[L, ng, N]`` scales (and zero-points)."""
    li = int(layer)
    return w4a8_matmul_plain(xq, sx, q[li], s[li], None if z is None else z[li])


def _decode_codes(q: torch.Tensor, kind: str, dtype) -> torch.Tensor:
    """Weight codes ``[K, N]`` in the activation's type: int8 as is, int4 as
    ``c − 8``, int4z as the raw ``c``, NF4 as the codebook entry rounded to
    ``dtype``; all but NF4 are exact in bf16."""
    if kind == "int8":
        return q.to(dtype)
    codes = unpack_nibbles(q)
    if kind == "nf4":
        return torch.from_numpy(NF4_CODEBOOK).to(q.device, dtype)[codes.long()]
    return (codes - (8 if kind == "int4" else 0)).to(dtype)


def woq_matmul_plain(x, q, s, kind: str = "int8", z=None) -> torch.Tensor:
    """``y = Σ_g s_g · (x_g @ code_g)``, each group's product summed in fp32
    before its scale applies; with ``kind="int4z"`` and zero-points ``z``,
    ``Σ_g s_g · (x_g @ c_g − rowsum(x_g) · z_g)``."""
    M, K = x.shape
    ng, g = _groups(K, s)
    codes = _decode_codes(q, kind, x.dtype).float()
    xf = x.float()
    acc = torch.zeros(M, q.shape[1], dtype=torch.float32, device=x.device)
    for gi in range(ng):
        xg = xf[:, gi * g:(gi + 1) * g]
        part = xg @ codes[gi * g:(gi + 1) * g]
        if z is not None:
            part = part - xg.sum(dim=1, keepdim=True) * z[gi]
        acc = acc + part * s[gi]
    return acc


def woq4z_matmul_plain(x, q, s, z) -> torch.Tensor:
    """``x @ ((c − z) · s)`` over raw half-split int4 codes, the zero-point as a
    rank-1 row-sum correction per group."""
    return woq_matmul_plain(x, q, s, "int4z", z)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _stream(*tensors) -> int:
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(
                f"kernel inputs must be contiguous tensors on cuda:{dev}, got one on "
                f"{t.device} (contiguous={t.is_contiguous()})"
            )
    return torch._C._cuda_getCurrentRawStream(dev)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _splits(M: int, N: int, rows: int, unit: int) -> int:
    """Number of K slices for a decode-sized M: enough blocks to give every SM
    about SPLIT_BLOCKS_PER_SM, each slice whole ``unit``s of weight rows: a
    group, so that every group's sum stays in one block, or for per-channel
    weights a stage, whose slices' sums are scaled apart (that changes only
    the fp32 rounding). Larger M runs unsplit."""
    if M > SMALL_M:
        return 1
    blocks = -(-N // SMALL_N)
    want = -(-SPLIT_BLOCKS_PER_SM * _sm_count(torch.cuda.current_device()) // blocks)
    units = -(-rows // unit)
    per = -(-units // max(1, min(want, units, 16)))
    return -(-units // per)


def _check_weight(K: int, q, s, z, packed: bool, name: str):
    rows = K // 2 if packed else K
    N = q.shape[-1]
    if q.dim() != 2 or q.shape[0] != rows or q.dtype is not (torch.uint8 if packed else torch.int8):
        raise ValueError(f"{name}: q must be {'uint8 [K/2' if packed else 'int8 [K'}, N], got "
                         f"{q.dtype} {tuple(q.shape)} for K={K}")
    if s.dim() != 2 or s.shape[1] != N or s.dtype is not torch.float32:
        raise ValueError(f"{name}: s must be float32 [ng, N], got {s.dtype} {tuple(s.shape)}")
    if z is not None and (z.shape != s.shape or z.dtype is not torch.float32):
        raise ValueError(f"{name}: z must be float32 like s, got {z.dtype} {tuple(z.shape)}")
    ng = s.shape[0]
    if not _kernel_takes(K, ng, packed):
        raise ValueError(f"{name}: no kernel for K={K} in {ng} groups")
    unit = STAGE_ROWS if ng == 1 else K // ng
    return N, ng, unit


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")


def _w4a8_launch(name: str, xq, sx, q, s, z, entry: str, *stack) -> torch.Tensor:
    """Checks, outputs and launch shared by the W4A8 entries: ``q``, ``s`` and
    ``z`` are one layer's weight (layer 0's views for the stacked entry, whose
    base pointers they share), ``stack`` the stacked entry's extra arguments."""
    from lia_tpu_torch.ops import _build

    M, K = xq.shape
    if xq.dtype is not torch.int8 or sx.dtype is not torch.float32 or sx.shape != (M, 1):
        raise TypeError(f"{name}: xq must be int8 [M, K] and sx float32 [M, 1], got "
                        f"{xq.dtype} {tuple(xq.shape)}, {sx.dtype} {tuple(sx.shape)}")
    if xq.data_ptr() % 16:
        raise ValueError(f"{name}: xq must be 16-byte aligned (the kernel copies 16 bytes at once)")
    N, ng, unit = _check_weight(K, q, s, z, True, name)
    stream = _stream(xq, sx, q, s, *([] if z is None else [z]))
    splits = _splits(M, N, K // 2, unit)
    out = torch.empty(M, N, dtype=torch.float32, device=xq.device)
    ws = torch.empty(splits, M, N, dtype=torch.float32, device=xq.device) if splits > 1 else out
    rc = getattr(_build.library("w4a8_matmul"), entry)(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(), 0 if z is None else z.data_ptr(), *stack,
        out.data_ptr(), ws.data_ptr(), M, N, K, ng, splits, stream,
    )
    _raise_on(rc, name)
    return out


def w4a8_matmul(xq, sx, q, s, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 activations ``xq [M, K]`` with scales ``sx [M, 1]`` × half-split int4
    weights → f32 ``[M, N]``; ``z`` None for biased codes ``c − 8``, else raw
    codes with per-group zero-points."""
    if xq.device.type == "cpu":
        return w4a8_matmul_plain(xq, sx, q, s, z)
    out = _w4a8_launch("w4a8_matmul", xq, sx, q, s, z, "lia_w4a8_matmul")
    w4a8_matmul.launches += 1
    return out


def w4a8_matmul_stacked(xq, sx, q, s, z: Optional[torch.Tensor], layer) -> torch.Tensor:
    """:func:`w4a8_matmul` against layer ``layer`` of a stacked weight: ``q``
    uint8 ``[L, K/2, N]``, ``s`` (and ``z``) f32 ``[L, ng, N]``. ``layer`` is a
    0-d int32 tensor on the card, read by the kernel (each block offsets its
    weight pointers by it), so no call copies an index from the host; the
    kernel writes NaN where it lies outside ``[0, L)``. On the CPU ``layer``
    may be an int."""
    if xq.device.type == "cpu":
        return w4a8_matmul_stacked_plain(xq, sx, q, s, z, layer)
    name = "w4a8_matmul_stacked"
    if q.dim() != 3 or s.dim() != 3 or s.shape[0] != q.shape[0] or (
            z is not None and (z.shape != s.shape or z.stride() != s.stride())):
        raise ValueError(f"{name}: q must be [L, K/2, N] with s and z [L, ng, N] (z laid out as s), got "
                         f"{tuple(q.shape)}, {tuple(s.shape)}, {None if z is None else tuple(z.shape)}")
    if not isinstance(layer, torch.Tensor) or layer.dim() != 0 or layer.dtype is not torch.int32:
        raise TypeError(f"{name}: layer must be a 0-d int32 tensor, got {layer!r}")
    _stream(layer)
    out = _w4a8_launch(name, xq, sx, q[0], s[0], None if z is None else z[0], "lia_w4a8_matmul_stacked",
                       layer.data_ptr(), q.shape[0], q.stride(0), s.stride(0))
    w4a8_matmul_stacked.launches += 1
    return out


def _woq_launch(x, q, s, z, kind: str, name: str) -> torch.Tensor:
    from lia_tpu_torch.ops import _build

    M, K = x.shape
    if x.dtype is not torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 activations, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned (the kernel copies 16 bytes at once)")
    N, ng, unit = _check_weight(K, q, s, z, kind != "int8", name)
    stream = _stream(x, q, s, *([] if z is None else [z]))
    splits = _splits(M, N, q.shape[0], unit)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    ws = torch.empty(splits, M, N, dtype=torch.float32, device=x.device) if splits > 1 else out
    rc = _build.library("woq_matmul").lia_woq_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), 0 if z is None else z.data_ptr(),
        out.data_ptr(), ws.data_ptr(), M, N, K, ng, WOQ_KINDS[kind], splits, stream,
    )
    _raise_on(rc, name)
    return out


def woq_matmul(x, q, s, kind: str = "int8") -> torch.Tensor:
    """bf16 ``x [M, K]`` × weight-only codes (``kind`` int8 ``[K, N]``, or int4 /
    nf4 half-split ``[K/2, N]``) with grouped scales → f32 ``[M, N]``."""
    if kind not in ("int8", "int4", "nf4"):
        raise ValueError(f"woq_matmul: kind must be int8, int4 or nf4, got {kind!r}")
    if x.device.type == "cpu":
        return woq_matmul_plain(x, q, s, kind)
    out = _woq_launch(x, q, s, None, kind, "woq_matmul")
    woq_matmul.launches += 1
    return out


def woq4z_matmul(x, q, s, z) -> torch.Tensor:
    """bf16 ``x [M, K]`` × raw half-split int4 codes with per-group zero-points
    (GPTQ) → f32 ``[M, N]``."""
    if x.device.type == "cpu":
        return woq4z_matmul_plain(x, q, s, z)
    if z is None:
        raise ValueError("woq4z_matmul: z is required")
    out = _woq_launch(x, q, s, z, "int4z", "woq4z_matmul")
    woq4z_matmul.launches += 1
    return out


KERNELS = (w4a8_matmul, w4a8_matmul_stacked, woq_matmul, woq4z_matmul)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
