"""The fused-MLP kernel's decomposition (B14, ``csrc/fused_mlp.cu``), on the
CPU.

The kernel runs a persistent grid in two phases: phase 1 takes the rows in
chunks of ``rows_a_pass`` (the most of 16, 8, 4, 2, 1 whose rows of H fit
in a block's shared memory: 16 up to H 5120, 8 up to 10240, 4 up to 16384;
the card's tests read the kernel's own value) and splits F over the blocks
in granules of 16 columns (past one chunk, over groups of blocks, one chunk
a group), each block taking its granules side by side in passes over H of
up to 16, and writes the bf16 activation; phase 2 gives the blocks units of
(H tile of 32 columns, chunk of 16 rows) and sums the down product over F as
its eight warps take it (warp w the 16-row steps w and w + 8 of every
256-row stage), the warps' partials added in order. Here a plain model of
that split (``mlp_plan``) is shown to cover every (chunk, F column) and
every (H tile, chunk) exactly once, with balanced blocks, and the
decomposition in plain torch (``partitioned_plain``) is held against
``fused_mlp_plain`` and against lia_tpu's Pallas ``fused_mlp`` in interpret
mode on the same seeded numpy inputs: fp32 within 1e-5; bf16 within 2e-2
(the two round at the same six places; the sums run in another order, which
moves an output of O(1) by up to one bf16 step, 2^-7 near 1). The Pallas
side is computed once per module.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.ops.pallas_mlp import fused_mlp as j_fused_mlp

from lia_tpu_torch.ops import cuda_mlp

SMS = 132  # an H100 SXM
GRANULE = 16  # F columns of phase 1's grain (csrc/fused_mlp.cu: GW)
PIECE = 16  # granules of a phase-1 pass over H (PG)
UNIT = 32  # H columns of a phase-2 tile (UW)
STAGE_ROWS = 256  # F rows of a phase-2 stage (KB)
WARPS = 8  # consumer warps a block (NWC)


def mlp_plan(R, H, F, blocks, rows_a_pass):
    """The kernel's split of the work over its persistent grid of ``blocks``.
    Phase 1 takes the rows in chunks of ``rows_a_pass``, ``groups`` =
    min(chunks, blocks) of them side by side: block i takes chunks i %
    groups, i % groups + groups, ... (``chunks[i]``) and F share i // groups
    of ``shares`` = blocks // groups, its granules [ng s // shares, ng (s +
    1) // shares) of ng = F / 16, walked in passes over H of up to 16
    granules (``pieces[i]``: (first F column, width)). Phase 2's units are (H
    tile of 32 columns, chunk of 16 rows), unit u = t * chunks + c to block u
    % blocks (``units[i]``)."""
    ng, nc1, nc2 = F // GRANULE, -(-R // rows_a_pass), -(-R // 16)
    groups = min(nc1, blocks)
    shares = blocks // groups
    pieces, chunks, units = [], [], []
    for i in range(blocks):
        share = i // groups
        g0, g1 = (ng * share // shares, ng * (share + 1) // shares) if share < shares else (0, 0)
        pieces.append([(g * GRANULE, min(PIECE, g1 - g) * GRANULE) for g in range(g0, g1, PIECE)])
        chunks.append(list(range(i % groups, nc1, groups)))
        units.append([divmod(u, nc2) for u in range(i, H // UNIT * nc2, blocks)])
    return {"pieces": pieces, "chunks": chunks, "units": units}


def grid_blocks(H, F, sms):
    """Blocks of the kernel's persistent grid: one an SM, at most one a granule
    or a tile."""
    return min(sms, max(F // GRANULE, H // UNIT))


def partitioned_plain(x, ln_scale, ln_bias, w1, b1, wg, w2, b2, activation="relu", rms=False, eps=1e-5,
                      blocks=SMS, rows_a_pass=16):
    """``fused_mlp_plain`` computed as the kernel decomposes it: the
    activation piece by piece of :func:`mlp_plan`, for each block's chunks of
    rows (each (chunk, column) once), then each H tile's down sum as the
    kernel's eight warps take it, warp w summing the 16-row steps w and w + 8
    of every 256-row stage of F, and the eight partials added in warp order
    before b2 and the residual."""
    dt = x.dtype
    R, H = x.shape
    Fd = w1.shape[1]
    plan = mlp_plan(R, H, Fd, blocks, rows_a_pass)
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
    act = torch.full((R, Fd), float("nan"))
    for block_pieces, block_chunks in zip(plan["pieces"], plan["chunks"]):
        for c in block_chunks:
            rows = slice(c * rows_a_pass, (c + 1) * rows_a_pass)
            for f0, width in block_pieces:
                cols = slice(f0, f0 + width)
                up = h[rows] @ w1[:, cols].to(dt).float()
                if b1 is not None:
                    up = up + b1[cols].to(dt).float()
                gate = h[rows] @ wg[:, cols].to(dt).float() if wg is not None else None
                act[rows, cols] = cuda_mlp._activate(activation, up, gate).to(dt).float()
    steps = torch.arange(Fd) // 16 % (STAGE_ROWS // 16) % WARPS  # the warp of each F row
    w2f = w2.to(dt).float()
    out = torch.empty(R, H, dtype=dt)
    for block_units in plan["units"]:
        for t, c in block_units:
            rows, cols = slice(c * 16, (c + 1) * 16), slice(t * UNIT, (t + 1) * UNIT)
            acc = torch.zeros(act[rows].shape[0], UNIT)
            for w in range(WARPS):
                mine = steps == w
                acc = acc + act[rows][:, mine] @ w2f[mine, cols]
            if b2 is not None:
                acc = acc + b2[cols].to(dt).float()
            out[rows, cols] = (xf[rows, cols] + acc).to(dt)
    return out


@pytest.mark.parametrize("R", [1, 16, 17, 256])
@pytest.mark.parametrize("H,F,blocks,rows_a_pass", [
    (4096, 14336, 132, 16),  # Llama-3-8B: 896 granules, 128 tiles
    (4096, 16384, 132, 16),  # OPT-6.7B: 1024 granules
    (4096, 11008, 132, 16),  # Llama-2-7B's F: 688 granules
    (8192, 28672, 132, 8),  # Llama-3-70B: 1792 granules, chunks of 8 rows
    (9216, 36864, 132, 8),  # OPT-66B
    (12288, 49152, 132, 4),  # OPT-175B: 3072 granules, chunks of 4 rows
    (16384, 53248, 132, 4),  # Llama-3-405B: 3328 granules, passes of 16 and 9 or 10
    (128, 512, 32, 16),  # the CPU tests' widths
    (128, 512, 32, 1),
    (256, 64, 8, 2),  # fewer granules than tiles
    (384, 1088, 7, 16),  # 68 granules over 7 blocks: 9 or 10 a block
    (128, 64, 1, 16),
])
def test_plan_covers_every_column_and_tile_once(R, H, F, blocks, rows_a_pass):
    """Every (chunk of rows, F column) in phase 1 and every (H tile, chunk of
    16 rows) in phase 2 exactly once; a group's blocks split F evenly, and the
    blocks hold phase 2's units evenly."""
    plan = mlp_plan(R, H, F, blocks, rows_a_pass)
    nc1, nc2 = -(-R // rows_a_pass), -(-R // 16)
    groups = min(nc1, blocks)
    done = sorted((c, col) for pieces, chunks in zip(plan["pieces"], plan["chunks"]) for c in chunks
                  for f0, w in pieces for col in range(f0, f0 + w))
    assert done == [(c, col) for c in range(nc1) for col in range(F)]
    for pieces in plan["pieces"]:  # passes of 16 granules, a shorter one only last
        assert all(w == 256 for _, w in pieces[:-1]) and all(0 < w <= 256 and w % 16 == 0 for _, w in pieces[-1:])
    for g in range(groups):
        granules = [sum(w for _, w in pieces) // 16 for i, pieces in enumerate(plan["pieces"])
                    if i % groups == g and i // groups < blocks // groups]
        assert max(granules) - min(granules) <= 1  # F split evenly within a group
    units = sorted(u for block_units in plan["units"] for u in block_units)
    assert units == [(t, c) for t in range(H // 32) for c in range(nc2)]
    per_block = [len(u) for u in plan["units"]]
    assert max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("H,F,sms,blocks", [(4096, 14336, 132, 132), (4096, 16384, 132, 132), (128, 512, 132, 32),
                                            (256, 64, 132, 8), (4096, 14336, 16, 16)])
def test_grid_blocks(H, F, sms, blocks):
    """One block an SM, at most one a granule or a tile."""
    assert grid_blocks(H, F, sms) == blocks


H, FF = 128, 512
ACTS = ["relu", "gelu", "gelu_new", "silu"]
# (activation, RMSNorm, biases, rows): each arm, both norms, the Llama form
CASES = [("relu", False, True, 5), ("gelu", False, True, 16), ("gelu_new", False, False, 1), ("silu", True, False, 17),
         ("silu", False, True, 3)]


def _inputs(act, rms, bias, rows):
    rng = np.random.default_rng(100 + 10 * ACTS.index(act) + 2 * rms + bias + rows)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=f(rows, H), ln_scale=1.0 + f(H, sc=0.1), ln_bias=f(H, sc=0.1) if bias else None,
                w1=f(H, FF, sc=0.05), b1=f(FF, sc=0.1) if bias else None, wg=f(H, FF, sc=0.05) if act == "silu" else None,
                w2=f(FF, H, sc=0.02), b2=f(H, sc=0.1) if bias else None)


def _case_id(c):
    return f"{c[0]}-{'rms' if c[1] else 'ln'}-{'bias' if c[2] else 'nobias'}-r{c[3]}"


@pytest.fixture(scope="module")
def pallas_refs():
    """lia_tpu's fused_mlp (interpret mode) of every case in fp32 and bf16, once."""
    refs = {}
    for act, rms, bias, rows in CASES:
        inp = _inputs(act, rms, bias, rows)
        for jdt in (jnp.float32, jnp.bfloat16):
            a = {k: None if v is None else jnp.asarray(v, jdt) for k, v in inp.items()}
            out = j_fused_mlp(a["x"], a["ln_scale"], a["ln_bias"], a["w1"], a["b1"], a["wg"], a["w2"], a["b2"],
                              activation=act, rms=rms, eps=1e-5, block_f=FF // 2, interpret=True)
            refs[act, rms, bias, rows, jdt == jnp.bfloat16] = np.asarray(out.astype(jnp.float32))
    return refs


def _partitioned(case, blocks, dtype, rows_a_pass=16):
    act, rms, bias, rows = case
    t = {k: None if v is None else torch.from_numpy(v).to(dtype) for k, v in _inputs(act, rms, bias, rows).items()}
    out = partitioned_plain(**t, activation=act, rms=rms, eps=1e-5, blocks=blocks, rows_a_pass=rows_a_pass)
    assert out.dtype == dtype and out.shape == (rows, H)
    return out, cuda_mlp.fused_mlp_plain(**t, activation=act, rms=rms, eps=1e-5)


@pytest.mark.parametrize("blocks", [1, 3, 7, 32])
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_partitioned_matches_plain(case, blocks):
    out, ref = _partitioned(case, blocks, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows_a_pass", [8, 4, 1])
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_partitioned_narrow_chunks_match_pallas(pallas_refs, case, rows_a_pass):
    """Chunks of 8, 4 and 1 rows (the kernel's at wider H) over 7 blocks."""
    out, _ = _partitioned(case, 7, torch.float32, rows_a_pass)
    np.testing.assert_allclose(out.numpy(), pallas_refs[(*case, False)], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks", [3, 32])
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_partitioned_matches_pallas_fp32(pallas_refs, case, blocks):
    out, _ = _partitioned(case, blocks, torch.float32)
    np.testing.assert_allclose(out.numpy(), pallas_refs[(*case, False)], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_partitioned_matches_pallas_bf16(pallas_refs, case):
    """bf16: the roundings of the normed input, the activation and the output
    are the same six; the fp32 sums run in another order. 2e-2 on outputs of
    O(1)."""
    out, _ = _partitioned(case, 7, torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), pallas_refs[(*case, True)], rtol=2e-2, atol=2e-2)
