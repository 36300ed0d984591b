"""The host's half of the quantized-matmul kernels on the CPU: the plan
(``lia_tpu_torch.ops.cuda_matmul.plan``: regime, block tile, split of the
weight rows in whole groups, TMA or the kernel's own copy by row stride,
W4A8's 16-row steps) and the plain version of a split call
(``split_plain``), held against the Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both packages; each
Pallas reference is computed once per module.
"""

import functools

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.ops import pallas_matmul as jpm

from lia_tpu_torch.ops import cuda_matmul as cm
from lia_tpu_torch.ops.quant import _kernel_takes

SMS = 132  # an H100's SMs: the plan's numbers below are the card's

# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,regime,row_tiles", [(1, "decode", 1), (16, "decode", 1), (17, "prefill", 1),
                                                (64, "prefill", 1), (65, "prefill", 1), (128, "prefill", 1),
                                                (4096, "prefill", 32)])
def test_regime_and_tile_follow_m(M, regime, row_tiles):
    """Decode takes up to 16 rows in one tile, prefill 128 rows a tile; the
    12288 columns make 96 tiles of 128."""
    pl = cm.plan(M, 12288, 4096, 32, "w4a8", sms=SMS)
    assert pl.regime == regime
    assert pl.tiles == 96 * row_tiles


@pytest.mark.parametrize("N,aligned,tma", [(40, True, False), (200, True, False), (4100, True, False),
                                           (4096, True, True), (12288, True, True), (50304, True, True),
                                           (96, True, True), (4096, False, False)])
def test_tma_needs_a_16_byte_row_stride(N, aligned, tma):
    """The weight's row stride is N bytes: TMA takes multiples of 16 from a
    16-byte aligned base; other weights are copied by the kernel's warps."""
    for fmt in ("w4a8", "int4", "int8"):
        assert cm.plan(16, N, 1024, 8, fmt, aligned=aligned, sms=SMS).tma is tma


@pytest.mark.parametrize("fmt", ["w4a8", "int8", "int4", "nf4", "int4z"])
@pytest.mark.parametrize("M", [1, 16, 17, 128, 4096])
@pytest.mark.parametrize("K,N,gs", [(4096, 12288, 128), (16384, 4096, 128), (4096, 50304, 128),
                                    (4096, 12288, -1), (16384, 4096, -1), (256, 40, 16), (1024, 4100, 64),
                                    (512, 200, 32)])
def test_split_takes_whole_groups(fmt, M, K, N, gs):
    """Every slice holds whole groups (whole walk units of 128 or 64 rows for
    per-channel scales), the slices cover the rows and none is empty, and a
    split call is one wave: three blocks an SM (decode) or one (prefill)."""
    ng = 1 if gs < 0 else K // gs
    packed = fmt != "int8"
    if not _kernel_takes(K, ng, packed):
        pytest.skip("no kernel for this shape")
    zp = fmt == "int4z"
    pl = cm.plan(M, N, K, ng, fmt, zp, sms=SMS)
    rows = K // 2 if packed else K
    unit = (128 if fmt == "w4a8" else 64) if ng == 1 else K // ng
    assert pl.unit == unit and pl.split_rows % unit == 0
    assert pl.split_rows * pl.splits >= rows > pl.split_rows * (pl.splits - 1)
    assert 1 <= pl.splits <= cm.MAX_SPLITS
    if pl.splits > 1:
        assert pl.tiles * pl.splits <= cm.BLOCKS_PER_SM[pl.regime] * SMS
        assert not (zp and ng == 1)  # zero-point row sums cover whole rows


@pytest.mark.parametrize("shape,fmt,splits", [("wqkv", "w4a8", 4), ("fc2", "w4a8", 11), ("head", "w4a8", 1),
                                              ("wqkv", "int4", 4), ("fc2", "int4", 11), ("head", "int4", 1)])
def test_opt_decode_splits(shape, fmt, splits):
    """OPT-6.7B's decode shapes (16 rows) on 132 SMs, three blocks an SM:
    wqkv's 96 column tiles split 4 ways, fc2's 32 11 ways (whole g128
    groups, 6 of its 64 a slice), the head's 393 not."""
    K, N = {"wqkv": (4096, 12288), "fc2": (16384, 4096), "head": (4096, 50304)}[shape]
    pl = cm.plan(16, N, K, K // 128, fmt, sms=SMS)
    assert pl.splits == splits and pl.split_rows % 128 == 0
    assert cm.plan(4096, N, K, K // 128, fmt, sms=SMS).splits == 1


@pytest.mark.parametrize("fmt,gs,step16", [("w4a8", 16, True), ("w4a8", 48, True), ("w4a8", 32, False),
                                           ("w4a8", 128, False), ("w4a8", -1, False), ("int4", 16, False),
                                           ("int8", 16, False)])
def test_w4a8_16_row_steps(fmt, gs, step16):
    """s8 wgmma sums 32 rows at once: W4A8 groups of other multiples of 16
    take 16-row steps; bf16 wgmma's 16-row depth fits every group."""
    K = 768
    ng = 1 if gs < 0 else K // gs
    assert cm.plan(130, 256, K, ng, fmt, sms=SMS).step16 is step16


# ---------------------------------------------------------------------------
# the split's plain version against the Pallas kernels
# ---------------------------------------------------------------------------

M_PL, N_PL = 8, 64


@functools.lru_cache(maxsize=None)
def _case(kind, K, gs):
    """Inputs (numpy, seeded) and the Pallas kernel's output, once per case."""
    rng = np.random.default_rng(K + (gs if gs > 0 else 0) + 7 * len(kind))
    ng = 1 if gs < 0 else K // gs
    x = rng.standard_normal((M_PL, K)).astype(np.float32)
    sx = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0, 1e-8).astype(np.float32)
    xq = np.rint(x / sx).astype(np.int8)
    q = (rng.integers(-128, 128, (K, N_PL)).astype(np.int8) if kind == "int8"
         else rng.integers(0, 256, (K // 2, N_PL)).astype(np.uint8))
    s = rng.uniform(0.01, 0.1, (ng, N_PL)).astype(np.float32)
    z = rng.integers(1, 16, (ng, N_PL)).astype(np.float32)
    j = jnp.asarray
    if kind in ("w4a8", "w4a8z"):
        ref = jpm.w4a8_matmul(j(xq), j(sx), j(q), j(s), j(z) if kind == "w4a8z" else None, group_size=gs,
                              block_m=8, block_n=32, block_k=64, interpret=True)
    elif kind == "int4z":
        ref = jpm.woq4z_matmul(j(x), j(q), j(s), j(z), gs, block_m=8, block_n=32, block_k=64, interpret=True)
    else:
        bk = (64 if gs < 0 else gs) if kind == "int8" else (128 if gs < 0 else 2 * gs)
        ref = jpm.woq_matmul(j(x), j(q), j(s), gs, int4=kind != "int8", nf4=kind == "nf4", block_m=8,
                             block_n=32, block_k=bk, interpret=True)
    return x, xq, sx, q, s, z, np.asarray(ref)


@pytest.mark.parametrize("kind", ["w4a8", "w4a8z", "int8", "int4", "nf4", "int4z"])
@pytest.mark.parametrize("K,gs", [(512, 64), (512, 32), (1024, 128), (512, -1)])
def test_split_plain_matches_pallas(kind, K, gs):
    """A split call's slices (the plan's, for 8 decode rows on 132 SMs) added
    in order give the Pallas kernel's output; zero-points with per-channel
    scales do not split, as the plan says."""
    x, xq, sx, q, s, z, ref = _case(kind, K, gs)
    ng = 1 if gs < 0 else K // gs
    zp = kind in ("w4a8z", "int4z")
    fmt = "w4a8" if kind.startswith("w4a8") else kind
    pl = cm.plan(M_PL, N_PL, K, ng, fmt, zp, sms=SMS)
    assert pl.splits == (1 if zp and ng == 1 else min(cm.MAX_SPLITS, q.shape[0] // pl.unit))
    t = torch.from_numpy
    zz = t(z) if zp else None
    if fmt == "w4a8":
        fn = lambda a, qq, ss, zs: cm.w4a8_matmul_plain(a, t(sx), qq, ss, zs)  # noqa: E731
        a = t(xq)
    else:
        fn = cm.woq4z_matmul_plain if kind == "int4z" else (
            lambda a, qq, ss, zs: cm.woq_matmul_plain(a, qq, ss, kind))  # noqa: E731
        a = t(x)
    out = cm.split_plain(fn, a, t(q), t(s), zz, split_rows=pl.split_rows, packed=kind != "int8")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
