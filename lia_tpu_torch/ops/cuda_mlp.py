"""The fused decoder-MLP kernel: wrapper, plain PyTorch version and launch
counter (the counterpart of ``lia_tpu/ops/pallas_mlp.py``).

:func:`fused_mlp` computes ``x + down(act(up(norm(x)))) + b2`` for a pre-norm
layer in one launch (``csrc/fused_mlp.cu``). It takes the plain version for a
tensor on the CPU and launches the kernel for a CUDA tensor, raising on
anything the kernel does not take: a CUDA tensor never falls back.

:func:`fused_mlp_plain` is the math of the TPU kernel with its roundings:

1. the norm in fp32 (LayerNorm, or RMSNorm with ``rms``), times ``ln_scale``
   (plus ``ln_bias``), both in the input's type, rounded to the input's type;
2. ``up = xn @ w1`` with fp32 sums, plus ``b1``;
3. relu, erf-gelu, tanh-gelu (``gelu_new``) or SwiGLU ``silu(xn @ wg) * up``;
4. the activation rounded to the input's type;
5. the down-projection summed in fp32 across all of F;
6. ``x + (sum + b2)`` in fp32, rounded once.

The kernel (``csrc/fused_mlp.cu``) runs a persistent grid in two phases:
phase 1 splits F over the blocks (past one chunk of rows, over groups of
blocks, one chunk a group) and writes the bf16 activation to a scratch;
after a grid barrier, phase 2 gives the blocks units of (H tile of 32
columns, chunk of 16 rows) and sums the down product over all of F in a
fixed order. No atomics add partial sums, so a launch gives the same bits
every run. The scratch and the barrier's two counters (which every launch
leaves zero) are one set per (device, stream) for eager calls, and one set
per captured call under CUDA graph capture (:func:`_workspace`), so launches
that may overlap never share them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

ACTIVATIONS = {"relu": 0, "gelu": 1, "gelu_new": 2, "silu": 3}  # the kernel's act codes
MAX_ROWS = 256  # rows the kernel takes (the reference's decode-sized gate)
MAX_H = 16384  # the widest H the kernel takes (csrc/fused_mlp.cu: MAX_H, x's TMA box)

_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, wg, w2, b2, activation: str = "relu",
                    rms: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """The fused MLP's math with its six roundings; ``x`` [R, H] → [R, H] in
    ``x``'s type. ``wg`` is the SwiGLU gate (``activation="silu"``), else None."""
    dt = x.dtype
    xf = x.float()
    if rms:
        xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        xc = xf - xf.mean(-1, keepdim=True)
        xn = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xn = xn * ln_scale.to(dt).float()
    if ln_bias is not None:
        xn = xn + ln_bias.to(dt).float()
    h = xn.to(dt).float()
    up = h @ w1.to(dt).float()
    if b1 is not None:
        up = up + b1.to(dt).float()
    act = _activate(activation, up, h @ wg.to(dt).float() if activation == "silu" else None)
    acc = act.to(dt).float() @ w2.to(dt).float()
    if b2 is not None:
        acc = acc + b2.to(dt).float()
    return (xf + acc).to(dt)


def _activate(activation: str, up: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    if activation == "silu":
        return F.silu(gate) * up
    if activation == "gelu":
        return F.gelu(up)
    if activation == "gelu_new":
        return F.gelu(up, approximate="tanh")
    if activation == "relu":
        return F.relu(up)
    raise ValueError(f"fused_mlp: unknown activation {activation!r}")


def _workspace(dev: int, stream: int, R: int, Fd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The call's bf16 [rows, F] activation scratch (written before it is
    read: no zeroing) and the grid barrier's two counters (each launch leaves
    them zero). An eager call takes its (device, stream)'s set, made once:
    the launches of one stream run in turn and never hold a set at once. A
    call captured into a CUDA graph takes a set of its own, which the graph
    holds (its counters' zero fill is a node of the graph), so a replay
    shares nothing with eager calls or with other graphs. An eager set has
    MAX_ROWS rows, a captured one R."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(R, Fd, dtype=torch.bfloat16, device=f"cuda:{dev}"),
                torch.zeros(2, dtype=torch.int32, device=f"cuda:{dev}"))
    ws = _workspaces.get((dev, stream))
    if ws is None or ws[0].shape[1] < Fd:
        ws = (torch.empty(MAX_ROWS, Fd, dtype=torch.bfloat16, device=f"cuda:{dev}"),
              ws[1] if ws is not None else torch.zeros(2, dtype=torch.int32, device=f"cuda:{dev}"))
        _workspaces[dev, stream] = ws
    return ws


def fused_mlp(x, ln_scale, ln_bias, w1, b1, wg, w2, b2, activation: str = "relu",
              rms: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """``x + down(act(up(norm(x)))) + b2`` in one launch. ``x`` [R, H] with R ≤
    256, ``w1`` (and ``wg``) [H, F], ``w2`` [F, H], norm and bias vectors; on
    the card every tensor is bfloat16, H % 128 == 0, H <= MAX_H and F % 64 ==
    0. The kernel's sums run in a fixed order, so equal inputs give equal
    bits; it leaves its barrier zero, so an eager call needs no memset and the
    call can be captured in a CUDA graph, which keeps a scratch of its own."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp: unknown activation {activation!r}")
    if (activation == "silu") != (wg is not None):
        raise ValueError("fused_mlp: wg is required for activation='silu' and only for it")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, wg, w2, b2, activation, rms, eps)
    from lia_tpu_torch.ops import _build

    R, H = x.shape
    Fd = w1.shape[1]
    shapes = {"ln_scale": (ln_scale, (H,)), "ln_bias": (ln_bias, (H,)), "w1": (w1, (H, Fd)), "b1": (b1, (Fd,)),
              "wg": (wg, (H, Fd)), "w2": (w2, (Fd, H)), "b2": (b2, (H,))}
    given = [x] + [t for t, _ in shapes.values() if t is not None]
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp: {name} must be {shape}, got {tuple(t.shape)}")
    if any(t.dtype is not torch.bfloat16 for t in given):
        raise TypeError(f"fused_mlp: the kernel takes bfloat16 tensors, got {sorted({str(t.dtype) for t in given})}")
    if not 1 <= R <= MAX_ROWS or H % 128 or H > MAX_H or Fd % 64:
        raise ValueError(f"fused_mlp: no kernel for {R} rows (1..{MAX_ROWS}), H={H} (% 128, at most {MAX_H}) "
                         f"and F={Fd} (% 64)")
    dev = torch.cuda.current_device()
    for t in given:
        if t.get_device() != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_mlp: inputs must be contiguous, 16-byte aligned tensors on cuda:{dev}, got "
                             f"one on {t.device} (contiguous={t.is_contiguous()})")
    stream = torch._C._cuda_getCurrentRawStream(dev)
    act, barrier = _workspace(dev, stream, R, Fd)
    out = torch.empty_like(x)
    rc = _build.library("fused_mlp").lia_fused_mlp(
        x.data_ptr(), ln_scale.data_ptr(), _ptr(ln_bias), w1.data_ptr(), _ptr(b1), _ptr(wg), w2.data_ptr(),
        _ptr(b2), out.data_ptr(), act.data_ptr(), barrier.data_ptr(), R, H, Fd, ACTIVATIONS[activation],
        int(rms), float(eps), stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_mlp: kernel launch failed with cudaError_t {rc}")
    fused_mlp.launches += 1
    return out


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


KERNELS = (fused_mlp,)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
