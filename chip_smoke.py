"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per item:

1. device: the card's name and power limit (nvidia-smi) and torch's view of it;
2. build: every CUDA kernel of lia_tpu_torch/csrc, built with nvcc in parallel;
3. kernel checks: each kernel against its plain PyTorch version on the card at
   the main path's shapes. Attention (OPT-6.7B: B=16, N=N_kv=32, D=128;
   prefill S=256 with left pads; decode past length 272 in a 320-slot bf16 /
   384-slot int8 cache; write-then-attend decode over a 320-slot plane holding
   273 tokens, also at G = 4 and through the stacked entry at a layer offset).
   Quantized matmuls at M = 16 (decode rows) and 4096
   (prefill rows) for the wqkv, fc2 and head (K, N) of OPT-6.7B: w4a8 with and
   without zero-points, woq int8 per-channel / int4 g128 / NF4 g128, woq4z g128;
4. main path: InferenceEngine.generate(fused=True) for opt-6.7b at full width
   and depth with random weights, 16 prompts x 256 tokens, 32 new tokens:
   bf16 weights with bf16 and with int8 KV; bench.py's two candidates
   (int8dyn+int8kv, w4a8+int8kv); weight-only int8, int4 g128 and NF4 g128
   with bf16 KV; and a GPTQ checkpoint (OPT-6.7B width at 2 layers,
   synthesized in AutoGPTQ's packing) as woq_int4z and retagged as
   woq_int4z_dyn. The launch counters, zeroed just before one run and read
   just after it, must show each path's kernels; for the bf16 paths and the
   two candidates prefill ms and decode tokens/s are the median of 5 runs.
   Each configuration's weights are freed before the next is made;
5. tiered: LIA's offload path, InferenceEngine.generate over a tiering
   RuntimeConfig at OPT-6.7B full width and depth, same prompts, from one
   host tree (bf16) made once on the card from the seed and copied out: h2d
   (copy rates of one streamed layer's bytes), then tier-h50-p3 (half
   resident, the rest streamed), tier-h50-p3-ring3 (the same with
   max_inflight_layers=3: a ring of 3, two layers in flight ahead),
   tier-h0-p3-int8kv (all streamed, int8 KV),
   tier-h50-p0 (KV on the host), tier-h50-p0-p2-mb4 (prefill policy 0 in 4
   minibatches, decode policy 2: host attention), tier-p1-2layer (policy 1,
   2 layers, 2 prompts of 64 tokens, all on the CPU) and, over an int8dyn
   tree, tier-h50-p3-int8dyn against the resident engine on the same tree.
   Each line: prefill ms and decode tokens/s (median of 3 runs where timed),
   bytes streamed and copy-stream ms per step, peak device memory under a
   residency limit, exact launch counts;
6. parity: OPT-6.7B width at 2 layers, prefill + 4 decode steps on the card
   (bf16, kernels) against the CPU (fp32, plain versions) over the same tree:
   bf16 weights with both KV types, and int8dyn+int8kv, w4a8+int8kv and
   weight-only int4 g128; and the tiered scheduler at 4 layers (half
   resident) under policies 3, 0 and 0/2 with bf16 and with int8 KV, and
   policy 3 over int8dyn weights and int8 KV;
7. device breakdown: one more main-path run per timed configuration under the
   profiler (weights made anew), device time by kernel and the idle share;
   for tier-h50-p3 and tier-h50-p0-p2-mb4, device compute, copies and host
   attention per step;
8. kernel times: each kernel's, its plain version's and a PyTorch library
   call's device time (profiler trace, mean of 30 calls, L2 flushed before
   each; the kernel's also from CUDA events, as a cross-check) and the
   wrapper's host time, beside the least time the card could take for the
   same bytes or operations; torch._int_mm over a row- and a column-major
   int8 weight. Profiling comes last because a
   profiler session slows the process's later launches.

Then the kernels line (for the quantized matmuls, the decode wqkv call: M=16,
K=4096, N=12288; decode_attention's and the stacked entry's launches from
tier-h50-p3, where the stacked entry, on no path of the reference, launches
0 times), the card's name and power
limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; without a CUDA device it exits 2 at once.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
REPS = 30
TIMED_RUNS = 5  # generate calls of each timed main path
NEW_TOKENS = 32

B, N, D = 16, 32, 128  # OPT-6.7B heads at batch 16
PROMPT = 256
PAST = 272  # decode checks: past length inside 256..287
PADS = [0, 3, 7, 15, 31, 64, 100, 200] + [0] * 8  # left pads per row
KERNEL_TOL = 2e-2  # bf16 outputs of O(1): a few ulps; kernel and plain version
# differ in summation order and in where the probabilities round
PARITY_TOL = 5e-2  # logits, bf16 model on the card vs fp32 on the CPU
# int8 activations: a bf16 activation can land on the other side of a rounding
# boundary of its int8 code from its fp32 twin (|x| / s_x * 127 moves by up to
# 127 * 2^-9 codes), so whole codes differ between the two runs; the same
# happens between bf16 and fp32 runs of the plain versions on the CPU alone
PARITY_TOL_INT8_ACT = 0.15
MATMUL_TOL = 1e-4  # quantized matmuls: max |kernel - plain| over max |plain|. Both
# sum exact products (int32 / float64 integers, or bf16 x bf16 in fp32); the
# fp32 sums of group partials and of scaled groups run in another order, and
# the scales multiply in other places: ~1e-6 observed, 2e-5 for one fp32 sum
# over 16384 terms (per-channel int8 at fc2, M = 4096)
OPT_KN = {"wqkv": (4096, 12288), "fc2": (16384, 4096), "head": (4096, 50304)}  # OPT-6.7B
MATMUL_M = (16, 4096)  # decode rows (16 sequences), prefill rows (16 x 256)
GROUP = 128
TIERED_RUNS = 3  # generate calls of each timed tiering configuration
TIER_MARGIN_GB = 2.5  # device memory the residency check leaves for activations (int8dyn
# prefill at b16 x 256 needed 2.1 GB beside its weights and KV on the H100)
# (name, KV, hbm_percentage, (prefill, decode) policy, minibatches, max_inflight_layers,
# timed): the tiering configurations over bf16 weights at OPT-6.7B full width and depth
TIERED = [
    ("tier-h50-p3", "none", 50, (3, 3), 1, 2, True),
    ("tier-h50-p3-ring3", "none", 50, (3, 3), 1, 3, True),
    ("tier-h0-p3-int8kv", "int8", 0, (3, 3), 1, 2, False),
    ("tier-h50-p0", "none", 50, (0, 0), 1, 2, True),
    ("tier-h50-p0-p2-mb4", "none", 50, (0, 2), 4, 2, True),
]
# (name, (prefill, decode) policy, KV, weight quantization or None): the tiered
# scheduler at 4 layers, half resident, on the card against the CPU
TIER_PARITY = [
    ("tier-parity-p3", (3, 3), "none", None),
    ("tier-parity-p0", (0, 0), "none", None),
    ("tier-parity-p0-p2", (0, 2), "none", None),
    ("tier-parity-p3-int8kv", (3, 3), "int8", None),
    ("tier-parity-p0-int8kv", (0, 0), "int8", None),
    ("tier-parity-p0-p2-int8kv", (0, 2), "int8", None),
    ("tier-parity-p3-int8dyn", (3, 3), "int8", dict(weight_dtype="int8", group_size=-1, act_quant="dynamic")),
]
# bench.py's two candidates (bench.py:68-78) and the weight-only formats
CANDIDATES = {
    "int8dyn+int8kv": (dict(weight_dtype="int8", group_size=-1, kv_cache_dtype="int8",
                            act_quant="dynamic"), {}),
    "w4a8+int8kv": (dict(weight_dtype="int4", group_size=128, kv_cache_dtype="int8",
                         act_quant="dynamic"), {"w4a8_matmul": 1}),
}
WEIGHT_ONLY = {
    "woq-int8": dict(weight_dtype="int8", group_size=-1),
    "woq-int4-g128": dict(weight_dtype="int4", group_size=128),
    "woq-nf4-g128": dict(weight_dtype="nf4", group_size=128),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush_buf = None


def _flush() -> None:
    """Read 256 MB, so the next launch finds its inputs outside the 50 MB L2, as
    the decode loop does (each layer's cache plane and weights are cold when the
    step reaches them). A read leaves no dirty lines to write back, and argmax
    is a kernel none of the timed functions launches, so its trace is dropped
    by name."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    _flush_buf.argmax()


def device_ms(fn) -> float:
    """Device time of one call of ``fn`` (every kernel it launches), L2 cold: the
    profiler's trace of REPS (flush, fn) pairs without the flush kernels, over
    REPS. Host time between launches is not in it (see host_us)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            _flush()
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and "ArgMax" not in e.key
    )
    return total_us / REPS / 1e3


def event_ms(fn) -> float:
    """Device time of one call of ``fn`` from a CUDA-event pair around it, L2
    cold, mean of REPS: the flush before each pair keeps the card busy while
    the host queues ``fn``, so the pair spans the call's kernels back to back.
    A cross-check of device_ms, whose trace can miss kernels."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(REPS):
        _flush()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in pairs) / REPS


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` (Python, checks and launch), GPU work queued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------


def kernel_checks(ca, quantize_kv):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    rows = {}

    # flash prefill
    q, k, v = randn(B, PROMPT, N, D), randn(B, N, PROMPT, D), randn(B, N, PROMPT, D)
    mask = torch.ones(B, PROMPT, dtype=torch.bool, device="cuda")
    for b, p in enumerate(PADS):
        mask[b, :p] = False
    out = ca.flash_attention_prefill(q, k, v, mask)
    ref = ca.flash_attention_prefill_plain(q, k, v, mask)
    torch.cuda.synchronize()
    valid = mask[:, :, None, None]
    check(bool(torch.isfinite(out).all()), "flash_attention_prefill: non-finite output")
    err = ((out.float() - ref.float()) * valid).abs().max().item()
    n_valid = [PROMPT - p for p in PADS]
    flops = 4 * D * N * sum(n * (n + 1) / 2 for n in n_valid)
    nbytes = 4 * q.numel() * 2 + mask.numel()
    causal = torch.tril(torch.ones(PROMPT, PROMPT, dtype=torch.bool, device="cuda"))
    sdpa_mask = (causal[None] & mask[:, None, :])[:, None]
    qt = q.transpose(1, 2)
    rows["flash_attention_prefill"] = dict(
        source="lia_tpu_torch/csrc/flash_prefill.cu",
        replaces="lia_tpu/ops/pallas_attention.py:172",
        max_abs_err=err,
        kernel=lambda: ca.flash_attention_prefill(q, k, v, mask),
        plain=lambda: ca.flash_attention_prefill_plain(q, k, v, mask),
        library=lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=sdpa_mask),
        bound=bound(nbytes, flops),
    )

    # decode caches: 3 layers, attend over layer 1
    L, li = 3, 1
    ln = torch.tensor(PAST, dtype=torch.int32, device="cuda")
    qd, kf, vf = randn(B, 1, N, D), randn(B, N, 1, D), randn(B, N, 1, D)
    dpads = [0, 3, 7, 15] * 4
    n_keys = [PAST - p for p in dpads]

    def slot_mask(S_max):
        sm = torch.zeros(B, S_max, dtype=torch.bool, device="cuda")
        for b, p in enumerate(dpads):
            sm[b, p:PAST] = True
        return sm

    sm = slot_mask(320)
    kc, vc = randn(L, B, N, 320, D), randn(L, B, N, 320, D)
    out = ca.decode_attention_fresh(qd, kf, vf, kc, vc, li, sm, ln)
    ref = ca.decode_attention_fresh_plain(qd, kf, vf, kc, vc, li, sm, ln)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "decode_attention_fresh: non-finite output")
    # yardstick: one SDPA call over the plane with the fresh token already written
    kp, vp = kc[li].clone(), vc[li].clone()
    kp[:, :, PAST], vp[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
    sm_inc = sm.clone()
    sm_inc[:, PAST] = True
    qdt = qd.transpose(1, 2)
    sdpa_dmask = sm_inc[:, None, None, :]
    past_keys = sum(n_keys)  # cache rows this run's data reads, over all rows
    io_bytes = 4 * qd.numel() * 2 + 4  # q, fresh k/v, out in bf16, the length
    rows["decode_attention_fresh"] = dict(
        source="lia_tpu_torch/csrc/decode_fresh.cu",
        replaces="lia_tpu/ops/pallas_attention.py:650",
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        kernel=lambda: ca.decode_attention_fresh(qd, kf, vf, kc, vc, li, sm, ln),
        plain=lambda: ca.decode_attention_fresh_plain(qd, kf, vf, kc, vc, li, sm, ln),
        library=lambda: F.scaled_dot_product_attention(qdt, kp, vp, attn_mask=sdpa_dmask),
        bound=bound(past_keys * N * D * 2 * 2 + io_bytes + sm.numel(), 4 * D * N * (past_keys + B)),
    )

    # write-then-attend decode (the tiered scheduler's streamed layers): the
    # plane holds the token at slot PAST, and the length (PAST + 1) counts it
    ln_inc = torch.tensor(PAST + 1, dtype=torch.int32, device="cuda")
    kp_inc, vp_inc = kp, vp  # layer li with the fresh token written
    plane_keys = sum(n + 1 for n in n_keys)
    plane_bound = bound(plane_keys * N * D * 2 * 2 + 4 * qd.numel() + 4 + sm.numel(), 4 * D * N * plane_keys)
    out = ca.decode_attention(qd, kp_inc, vp_inc, sm_inc, ln_inc)
    ref = ca.decode_attention_plain(qd, kp_inc, vp_inc, sm_inc, ln_inc)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "decode_attention: non-finite output")
    rows["decode_attention"] = dict(
        source="lia_tpu_torch/csrc/decode.cu",
        replaces="lia_tpu/ops/pallas_attention.py:404",
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        kernel=lambda: ca.decode_attention(qd, kp_inc, vp_inc, sm_inc, ln_inc),
        plain=lambda: ca.decode_attention_plain(qd, kp_inc, vp_inc, sm_inc, ln_inc),
        library=lambda: F.scaled_dot_product_attention(qdt, kp_inc, vp_inc, attn_mask=sdpa_dmask),
        bound=plane_bound,
    )
    # GQA (G = 4: 8 kv heads under 32 query heads) over the same slots
    kg, vg = randn(B, N // 4, 320, D), randn(B, N // 4, 320, D)
    out = ca.decode_attention(qd, kg, vg, sm_inc, ln_inc)
    ref = ca.decode_attention_plain(qd, kg, vg, sm_inc, ln_inc)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    emit({"phase": "kernel_check", "kernel": "decode_attention", "variant": "GQA G=4", "max_abs_err": err,
          "tol": KERNEL_TOL})
    check(bool(torch.isfinite(out).all()) and err <= KERNEL_TOL, f"decode_attention GQA: max abs err {err}")
    # the stacked entry (B7): layer li of the stacked cache, read in place
    kc_inc, vc_inc = kc.clone(), vc.clone()
    kc_inc[li], vc_inc[li] = kp_inc, vp_inc
    out = ca.decode_attention_stacked(qd, kc_inc, vc_inc, li, sm_inc, ln_inc)
    ref = ca.decode_attention_stacked_plain(qd, kc_inc, vc_inc, li, sm_inc, ln_inc)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "decode_attention_stacked: non-finite output")
    rows["decode_attention_stacked"] = dict(
        source="lia_tpu_torch/csrc/decode.cu",
        replaces="lia_tpu/ops/pallas_attention.py:505",
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        kernel=lambda: ca.decode_attention_stacked(qd, kc_inc, vc_inc, li, sm_inc, ln_inc),
        plain=lambda: ca.decode_attention_stacked_plain(qd, kc_inc, vc_inc, li, sm_inc, ln_inc),
        library=lambda: F.scaled_dot_product_attention(qdt, kc_inc[li], vc_inc[li], attn_mask=sdpa_dmask),
        bound=plane_bound,
    )

    sm8 = slot_mask(384)
    kq = quantize_kv(randn(L, B, N, 384, D, dtype=torch.float32))
    vq = quantize_kv(randn(L, B, N, 384, D, dtype=torch.float32))
    args = (qd, kf, vf, kq.q, kq.s, vq.q, vq.s, li, sm8, ln)
    out = ca.decode_attention_fresh_int8(*args)
    ref = ca.decode_attention_fresh_int8_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "decode_attention_fresh_int8: non-finite output")
    rows["decode_attention_fresh_int8"] = dict(
        source="lia_tpu_torch/csrc/decode_fresh_int8.cu",
        replaces="lia_tpu/ops/pallas_attention.py:1170",
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        kernel=lambda: ca.decode_attention_fresh_int8(*args),
        plain=lambda: ca.decode_attention_fresh_int8_plain(*args),
        library=None,  # no PyTorch call attends over an int8 cache with per-token scales
        bound=bound(past_keys * N * (D + 4) * 2 + io_bytes + sm8.numel(), 4 * D * N * (past_keys + B)),
    )
    for name, r in rows.items():
        emit({"phase": "kernel_check", "kernel": name, "max_abs_err": r["max_abs_err"], "tol": KERNEL_TOL})
        check(r["max_abs_err"] <= KERNEL_TOL, f"{name}: max abs err {r['max_abs_err']} > {KERNEL_TOL}")
    return rows


def matmul_cases(cm, quantize_act):
    """The quantized-matmul kernel cases, one shape at a time (each yields its
    inputs, made from a seeded generator, so the timing phase makes the same
    ones anew): kernel, plain version, library yardstick and bound. The
    library calls read more bytes than the kernels: ``torch._int_mm`` reads
    the unpacked int8 codes (twice the packed bytes, column-major; its 16
    decode rows are padded to 32, the least it takes), ``torch.mm`` the
    dequantized bf16 weight (2x int8, 4x int4); neither is on the port's path."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randint(lo, hi, *shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32).to(dtype)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 1e-3 + 1e-3

    from lia_tpu_torch.ops.quant import QuantizedWeight, dequantize, unpack_nibbles

    for shape, (K, N) in OPT_KN.items():
        ng = K // GROUP
        packed = randint(0, 256, K // 2, N, dtype=torch.uint8)
        # the library yardstick's operand, column-major: _int_mm's fast layout
        codes8 = (unpack_nibbles(packed) - 8).to(torch.int8).t().contiguous().t()
        i8 = randint(-127, 128, K, N, dtype=torch.int8)
        s, s1 = scales(ng, N), scales(1, N)
        z = randint(0, 16, ng, N, dtype=torch.float32)
        deq = {kind: dequantize(QuantizedWeight(q, sc, fmt, zz), torch.bfloat16) for kind, (q, sc, fmt, zz) in {
            "int8": (i8, s1, "woq_int8", None), "int4": (packed, s, "woq_int4", None),
            "nf4": (packed, s, "woq_nf4", None), "int4z": (packed, s, "woq_int4z", z)}.items()}
        for M in MATMUL_M:
            x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
            xq, sx = quantize_act(x)
            xq_pad = torch.cat([xq, xq.new_zeros(max(0, 32 - M), K)])
            io = 4 * M * N  # f32 output

            def w4a8(zz):
                nbytes = M * K + 4 * M + K * N // 2 + 4 * ng * N * (1 if zz is None else 2) + io
                return dict(kernel=lambda: cm.w4a8_matmul(xq, sx, packed, s, zz),
                            plain=lambda: cm.w4a8_matmul_plain(xq, sx, packed, s, zz),
                            library=lambda: torch._int_mm(xq_pad, codes8),
                            bound=bound(nbytes, 2 * M * K * N, PEAK_INT8_OP_PER_S))

            def woq(kind, q, sc, zz=None):
                nbytes = 2 * M * K + q.numel() + 4 * sc.numel() * (1 if zz is None else 2) + io
                if zz is None:
                    k, p = (lambda: cm.woq_matmul(x, q, sc, kind)), (lambda: cm.woq_matmul_plain(x, q, sc, kind))
                else:
                    k, p = (lambda: cm.woq4z_matmul(x, q, sc, zz)), (lambda: cm.woq4z_matmul_plain(x, q, sc, zz))
                w = deq[kind]
                return dict(kernel=k, plain=p, library=lambda: torch.mm(x, w, out_dtype=torch.float32),
                            bound=bound(nbytes, 2 * M * K * N))

            for name, variant, case in (
                ("w4a8_matmul", "g128", w4a8(None)),
                ("w4a8_matmul", "g128 zero-points", w4a8(z)),
                ("woq_matmul", "int8 per-channel", woq("int8", i8, s1)),
                ("woq_matmul", "int4 g128", woq("int4", packed, s)),
                ("woq_matmul", "nf4 g128", woq("nf4", packed, s)),
                ("woq4z_matmul", "g128", woq("int4z", packed, s, z)),
            ):
                case.update(name=name, variant=variant, M=M, K=K, N=N, shape=shape,
                            representative=(M == 16 and shape == "wqkv"
                                            and variant in ("g128", "int4 g128")))
                yield case


MATMUL_ROWS = {
    "w4a8_matmul": ("lia_tpu_torch/csrc/w4a8_matmul.cu", "lia_tpu/ops/pallas_matmul.py:409"),
    "woq4z_matmul": ("lia_tpu_torch/csrc/woq_matmul.cu", "lia_tpu/ops/pallas_matmul.py:601"),
    "woq_matmul": ("lia_tpu_torch/csrc/woq_matmul.cu", "lia_tpu/ops/pallas_matmul.py:658"),
}


def matmul_kernel_checks(cm, quantize_act):
    """Each quantized-matmul case against its plain version; returns the kernels
    line's rows (their representative case: decode wqkv)."""
    rows = {}
    for c in matmul_cases(cm, quantize_act):
        out, ref = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{c['name']} {c['variant']}: non-finite output")
        abs_err = (out - ref).abs().max().item()
        rel = abs_err / max(ref.abs().max().item(), 1e-30)
        emit({"phase": "kernel_check", "kernel": c["name"], "variant": c["variant"], "M": c["M"],
              "K": c["K"], "N": c["N"], "max_abs_err": abs_err, "rel_err": rel, "tol": MATMUL_TOL})
        check(rel <= MATMUL_TOL, f"{c['name']} {c['variant']} M={c['M']} K={c['K']} N={c['N']}: "
                                 f"relative error {rel} > {MATMUL_TOL}")
        if c["representative"]:
            source, replaces = MATMUL_ROWS[c["name"]]
            rows[c["name"]] = dict(source=source, replaces=replaces, max_abs_err=abs_err)
        del out, ref
    return rows


def matmul_kernel_times(cm, quantize_act, rows) -> None:
    """Device times of every quantized-matmul case (kernel, plain version, library
    call) beside its bound; the representative cases fill the kernels line."""
    for c in matmul_cases(cm, quantize_act):
        t = dict(ms=device_ms(c["kernel"]), event_ms=event_ms(c["kernel"]), host_us=host_us(c["kernel"]),
                 plain_ms=device_ms(c["plain"]), library_ms=device_ms(c["library"]),
                 bound_ms=c["bound"][0], bound_by=c["bound"][1])
        emit({"phase": "kernel_time", "kernel": c["name"], "variant": c["variant"], "M": c["M"],
              "K": c["K"], "N": c["N"], **t})
        if c["representative"]:
            rows[c["name"]].update(t, bound=c["bound"])


def int_mm_layout() -> None:
    """torch._int_mm (the int8 x int8 formats' matmul) over OPT-6.7B's wqkv
    weight in row-major and in column-major layout, at decode (16 rows padded
    to 32) and prefill rows: the layout ``to_device`` keeps on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    K, N = OPT_KN["wqkv"]
    w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
    w_col = w.t().contiguous().t()
    for M in (32, 4096):
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
        check(torch.equal(torch._int_mm(xq, w), torch._int_mm(xq, w_col)), "int_mm: layouts disagree")
        emit({"phase": "int_mm_layout", "M": M, "K": K, "N": N,
              "row_major_ms": device_ms(lambda: torch._int_mm(xq, w)),
              "col_major_ms": device_ms(lambda: torch._int_mm(xq, w_col))})


def kernel_times(rows) -> None:
    """Device times of each kernel, its plain version and the library call, and
    the wrapper's host time. Runs last: a profiler session leaves the process's
    launches slower (measured on the card: eager decode loses ~40% after one)."""
    for name, r in rows.items():
        r["ms"] = device_ms(r["kernel"])
        r["event_ms"] = event_ms(r["kernel"])
        r["host_us"] = host_us(r["kernel"])
        r["plain_ms"] = device_ms(r["plain"])
        r["library_ms"] = device_ms(r["library"]) if r["library"] else None
        emit({"phase": "kernel_time", "kernel": name, "ms": r["ms"], "event_ms": r["event_ms"], "host_us": r["host_us"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


def launch_counts(ca, cm) -> dict:
    return {**ca.launch_counts(), **cm.launch_counts()}


def main_path(ca, cm, label: str, cfg, make_params, prompts, kv: str, per_forward: dict, timed: bool):
    """One configuration through ``generate(fused=True)``. The counters are zeroed
    just before one run and read just after: prefill attention once per layer,
    decode attention per layer per step, and each matmul kernel of
    ``per_forward`` that many times per forward pass (prefill and 31 steps).
    ``timed``: a warm-up first and TIMED_RUNS runs (median and all) of prefill
    ms and decode tokens/s; else the counted run's own numbers. The weights
    live only as long as this call."""
    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.ops import kv_cache as kvc

    engine = InferenceEngine(cfg, make_params(), RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    if timed:
        engine.generate(prompts, gen, fused=True)  # warm-up (cuBLAS handles, kernel loads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    cm.reset_launch_counts()
    res = engine.generate(prompts, gen, fused=True)
    launches = launch_counts(ca, cm)
    L, steps = cfg.num_layers, gen.max_new_tokens - 1
    expected = {name: 0 for name in launches}
    expected["flash_attention_prefill"] = L
    expected["decode_attention_fresh_int8" if kv == "int8" else "decode_attention_fresh"] = L * steps
    for name, n in per_forward.items():
        expected[name] = n * (1 + steps)
    check(launches == expected, f"{label}: launches {launches} != expected {expected}")
    seqs = res.sequences
    check(seqs.shape == (len(prompts), gen.max_new_tokens), f"{label}: sequences shape {seqs.shape}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), f"{label}: token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    # the eager loop is bound by host time, and the host's cores are shared:
    # report the median of TIMED_RUNS runs (the counted one first) and all of them
    runs = [res.summary()]
    if timed:
        runs += [engine.generate(prompts, gen, fused=True).summary() for _ in range(TIMED_RUNS - 1)]

    # logits of the same path are finite (outside the counted run)
    with torch.inference_mode():
        tokens = torch.tensor(prompts, dtype=torch.int32, device="cuda")
        mask = torch.ones_like(tokens, dtype=torch.bool)
        cache = kvc.init_cache(cfg, len(prompts), 320 if kv == "none" else 384,
                               torch.bfloat16, quantized=kv == "int8", device="cuda")
        logits, cache = T.prefill(cfg, engine.params, tokens, mask, cache)
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full_like(nxt, len(prompts[0]))
        logits2, _ = T.decode_step(cfg, engine.params, nxt, pos, cache)
        check(logits.shape == (len(prompts), cfg.vocab_size), f"{label}: logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all()), f"{label}: non-finite logits")

    def med(key, scale=1.0):
        return statistics.median(r[key] * scale for r in runs), [r[key] * scale for r in runs]

    record = {
        "phase": "main_path", "config": label, "model": cfg.name, "layers": L, "kv": kv,
        "batch": len(prompts), "prompt": len(prompts[0]), "new_tokens": gen.max_new_tokens,
        "launches": launches, "peak_mem_gb": peak / 1e9,
    }
    for key, name, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                             ("decode_tokens_per_s", "decode_tokens_per_s", 1.0),
                             ("total_latency_s", "total_s", 1.0)):
        record[name], record[name + "_runs"] = med(key, scale)
    emit(record)
    del engine, cache, logits, logits2
    torch.cuda.empty_cache()
    return launches, record["total_s"]


def gptq_params(cfg, seed: int):
    """An OPT tree from a synthesized AutoGPTQ state dict (numpy): random
    codes, zero-points and scales in GPTQ's packing (g = 128, trivial g_idx),
    the rest random fp, through ``params_from_gptq_state_dict`` (lossless
    woq_int4z records). Scales of 0.006/4.3205 give weights of about the fp
    dummy's spread."""
    from lia_tpu_torch.utils.gptq import params_from_gptq_state_dict

    rng = np.random.default_rng(seed)
    H, F, V = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size

    def r(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.006).astype(np.float32)

    def pack(codes, zeros):  # AutoGPTQ: 8 codes per int32 along K, zero - 1 along N
        qweight = np.zeros((codes.shape[0] // 8, codes.shape[1]), np.uint32)
        qzeros = np.zeros((zeros.shape[0], zeros.shape[1] // 8), np.uint32)
        for i in range(8):
            qweight |= codes[i::8].astype(np.uint32) << (4 * i)
            qzeros |= (zeros[:, i::8] - 1).astype(np.uint32) << (4 * i)
        return qweight.view(np.int32), qzeros.view(np.int32)

    pre = "model.decoder."
    sd = {pre + "embed_tokens.weight": r(V, H), pre + "embed_positions.weight": r(cfg.max_position_embeddings + 2, H),
          pre + "final_layer_norm.weight": np.ones(H, np.float32), pre + "final_layer_norm.bias": np.zeros(H, np.float32)}
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        for name, (K, N) in (("self_attn.q_proj", (H, H)), ("self_attn.k_proj", (H, H)),
                             ("self_attn.v_proj", (H, H)), ("self_attn.out_proj", (H, H)),
                             ("fc1", (H, F)), ("fc2", (F, H))):
            codes = rng.integers(0, 16, (K, N), dtype=np.uint8)
            zeros = rng.integers(1, 16, (K // GROUP, N), dtype=np.uint8)
            sd[lp + name + ".qweight"], sd[lp + name + ".qzeros"] = pack(codes, zeros)
            sd[lp + name + ".scales"] = np.full((K // GROUP, N), 0.006 / 4.3205, np.float16)
            sd[lp + name + ".g_idx"] = (np.arange(K) // GROUP).astype(np.int32)
            sd[lp + name + ".bias"] = np.zeros(N, np.float32)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[lp + ln + ".weight"], sd[lp + ln + ".bias"] = np.ones(H, np.float32), np.zeros(H, np.float32)
    return params_from_gptq_state_dict(cfg, sd, group_size=GROUP)


def _short(kernel: str) -> str:
    """A kernel's name without return type, namespaces, template and parameters."""
    name = kernel.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1][:60]


def device_breakdown(label: str, cfg, make_params, prompts, kv: str, wall_s: float) -> None:
    """Device time by kernel over one more main-path run under the profiler
    (the weights made anew), and the idle share against the median wall time
    of the unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine

    engine = InferenceEngine(cfg, make_params(), RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    engine.generate(prompts, gen, fused=True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, gen, fused=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({
        "phase": "device_breakdown", "config": label, "kv": kv, "device_busy_s": busy_s,
        "wall_s": wall_s, "idle_share": 1 - busy_s / wall_s,
        "top_kernels": [{"kernel": _short(e.key),
                         "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top],
    })
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: tiered weight streaming (the scheduler's path)
# ---------------------------------------------------------------------------


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree (a quantized record's q, s, z)."""
    from lia_tpu_torch.runtime.weight_manager import tree_tensors

    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def first_layers(tree, n: int):
    """The tree with its stacked layers cut to the first ``n`` (views)."""
    from lia_tpu_torch.runtime.weight_manager import stacked_prefix

    return {k: (v if k != "layers" else stacked_prefix(v, n)) for k, v in tree.items()}


def host_tree(cfg, quant=None):
    """OPT-6.7B's fused tree, drawn on the card from the seed, in (pageable)
    host memory in the card's layout (to_host); the device copy is freed. The
    weight manager packs each streamed layer into pinned memory itself."""
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_host

    t0 = time.perf_counter()
    dev = fuse_projections(cfg, device_dummy_params(cfg, seed=0, quant=quant))
    host = to_host(dev, "cuda")
    del dev
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return host, time.perf_counter() - t0


def h2d_bandwidth(nbytes: int) -> None:
    """Host-device copy rates for one streamed layer's bytes: pinned and pageable
    H2D, pinned and pageable D2H (host clock around REPS copies and a sync):
    the card's counterpart of the reference's Microbench.h2d_bandwidth."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.ones(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.ones(nbytes, dtype=torch.uint8)
    check(pinned.is_pinned(), "h2d: the pinned buffer is not pinned")

    def gbps(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return nbytes * reps / (time.perf_counter() - t0) / 1e9

    emit({"phase": "h2d", "bytes": nbytes,
          "h2d_pinned_gb_s": gbps(lambda: dev.copy_(pinned, non_blocking=True)),
          "h2d_pageable_gb_s": gbps(lambda: dev.copy_(pageable)),
          "d2h_pinned_gb_s": gbps(lambda: pinned.copy_(dev, non_blocking=True)),
          "d2h_pageable_gb_s": gbps(lambda: pageable.copy_(dev))})


def tiered_expected(cfg, n_res: int, kv: str, policies, nm: int, batch: int) -> dict:
    """Kernel launches of one tiered generate, from the scheduler's code: the
    resident layers run flash prefill and the fresh-merge decode kernel; the
    streamed layers run flash prefill once per minibatch and ``decode_attention``
    per step where their plan attends on the card (policies 0 and 3), and no
    kernel where it attends on the host (1, 2, 4)."""
    from lia_tpu_torch.ops import cuda_attention as ca
    from lia_tpu_torch.ops import cuda_matmul as cm

    L, steps = cfg.num_layers, NEW_TOKENS - 1
    n_str = L - n_res
    card = {0: True, 1: False, 2: False, 3: True, 4: False}
    chunks = nm if nm > 1 and batch % nm == 0 else 1
    out = {name: 0 for name in {**ca.launch_counts(), **cm.launch_counts()}}
    out["flash_attention_prefill"] = n_res + (n_str * chunks if card[policies[0]] else 0)
    out["decode_attention_fresh_int8" if kv == "int8" else "decode_attention_fresh"] = n_res * steps
    out["decode_attention"] = n_str * steps if card[policies[1]] else 0
    return out


def tiered_path(ca, cm, name: str, cfg, tree, prompts, kv: str, hbm: int, policies, nm: int, inflight: int,
                timed: bool):
    """One tiering configuration through ``InferenceEngine.generate``: launch
    counts zeroed just before one run and read just after it, checked exactly;
    the copy stream's bytes and time (CUDA events on it); peak device memory
    against what may live there (the resident layers, the ring, the device KV,
    the embeddings and head, and a margin for activations); with ``timed``,
    TIERED_RUNS runs (median and all). Returns (tokens, launches, engine)."""
    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.engine import InferenceEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, tree, tiered_runtime(kv, hbm, policies, nm, inflight))
    init_s = time.perf_counter() - t0
    sched = engine.scheduler
    check(sched is not None, f"{name}: the engine built no scheduler")
    wm = sched.wm
    check(all(t.is_pinned() for t in wm._packed), f"{name}: a streamed layer is not in pinned memory")
    # before any run, the card holds the resident layers, the ring and the
    # embeddings and head, and nothing of the streamed layers
    rep = wm.memory_report()
    held = torch.cuda.memory_allocated() - base
    owned = rep["resident_bytes"] + rep["ring_bytes"] + tree_bytes(engine.params)
    check(held <= owned + 64e6, f"{name}: the engine holds {held / 1e9:.3f} GB on the card, "
                                f"{owned / 1e9:.3f} GB expected: streamed layers stayed on the card")
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    B = len(prompts)
    ca.reset_launch_counts()
    cm.reset_launch_counts()
    wm.copy_stats()
    with host_attention_clock() as host_attn:
        res = engine.generate(prompts, gen)
    launches = launch_counts(ca, cm)
    copies = wm.copy_stats()
    peak = torch.cuda.max_memory_allocated()
    expected = tiered_expected(cfg, wm.n_resident, kv, policies, nm, B)
    check(launches == expected, f"{name}: launches {launches} != expected {expected}")
    seqs = res.sequences
    check(seqs.shape == (B, NEW_TOKENS), f"{name}: sequences shape {seqs.shape}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), f"{name}: token outside the vocabulary")
    runs = [res.summary()]
    if timed:
        runs += [engine.generate(prompts, gen).summary() for _ in range(TIERED_RUNS - 1)]
    wm.copy_stats()

    # what may live on the card during a run: the resident prefix, the ring,
    # the device KV (resident segment, and the streamed one unless it is on
    # the host), the embeddings and head, and TIER_MARGIN_GB for activations
    bucket = 128 if kv == "int8" else 64
    max_len = -(-(len(prompts[0]) + NEW_TOKENS) // bucket) * bucket
    per_layer_kv = 2 * B * cfg.num_kv_heads * max_len * (cfg.head_dim * (1 if kv == "int8" else 2)
                                                          + (4 if kv == "int8" else 0))
    kv_layers = wm.n_resident + (0 if sched.kv_host else cfg.num_layers - wm.n_resident)
    limit = (rep["resident_bytes"] + rep["ring_bytes"] + kv_layers * per_layer_kv + tree_bytes(engine.params)
             + TIER_MARGIN_GB * 1e9)
    check(peak < limit, f"{name}: peak device memory {peak / 1e9:.2f} GB above the residency limit "
                        f"{limit / 1e9:.2f} GB: streamed layers stayed on the card")
    passes = NEW_TOKENS  # the prompt and each decode step stream every streamed layer once
    med = {}
    for key, out_key, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                                ("decode_tokens_per_s", "decode_tokens_per_s", 1.0)):
        vals = [r[key] * scale for r in runs]
        med[out_key], med[out_key + "_runs"] = statistics.median(vals), vals
    emit({"phase": "tiered", "config": name, "model": cfg.name, "layers": cfg.num_layers, "kv": kv,
          "hbm_percentage": hbm, "resident_layers": wm.n_resident, "prefill_policy": policies[0],
          "decode_policy": policies[1], "num_minibatch": nm, "max_inflight_layers": inflight, "batch": B, "prompt": len(prompts[0]),
          "new_tokens": NEW_TOKENS, **med, "init_s": init_s,
          "bytes_per_decode_step": copies["bytes"] / passes, "copy_ms_per_step": copies["copy_ms"] / passes,
          "host_attention_ms_per_pass": host_attn[0] / passes * 1e3,
          "copy_gb_per_s": copies["bytes"] / max(copies["copy_ms"], 1e-9) / 1e6,
          "held_after_init_gb": held / 1e9, "peak_mem_gb": peak / 1e9, "residency_limit_gb": limit / 1e9,
          "memory": rep,
          "host_threads": torch.get_num_threads(), "launches": launches})
    return seqs, launches, engine


def tiered_runtime(kv: str, hbm: int, policies, nm: int, inflight: int = 2):
    from lia_tpu_torch.config import QuantConfig, RuntimeConfig

    return RuntimeConfig(hbm_percentage=hbm, stream_weights=hbm == 0, prefill_policy=policies[0],
                         decode_policy=policies[1], num_minibatch=nm, max_inflight_layers=inflight,
                         quant=QuantConfig(kv_cache_dtype=kv))


@contextlib.contextmanager
def host_attention_clock():
    """Host clock around every call of the host tier's attention (policies 1,
    2 and 4 attend on the CPU); yields a one-element list of seconds spent."""
    from lia_tpu_torch.ops import attention as att

    spent = [0.0]
    originals = {n: getattr(att, n) for n in ("attend_decode_host", "attend_prefill_host")}

    def timed(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            return out
        return call

    try:
        for n, fn in originals.items():
            setattr(att, n, timed(fn))
        yield spent
    finally:
        for n, fn in originals.items():
            setattr(att, n, fn)


def tiered_breakdown(name: str, engine, prompts) -> None:
    """Where the time of one tiered generate goes, under the profiler: device
    time in kernels (compute) and in copies (the weight stream, KV and
    activations crossing), host attention (policies 2/4: host clock around
    the host tier's attention calls), and the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from lia_tpu_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    with host_attention_clock() as spent, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    copy_s = sum(e.self_device_time_total for e in events if "Memcpy" in e.key) / 1e6
    compute_s = sum(e.self_device_time_total for e in events if "Memcpy" not in e.key) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "tiered_breakdown", "config": name, "wall_s": wall, "device_compute_s": compute_s,
          "device_copy_s": copy_s, "host_attention_s": spent[0], "per_step_ms": {
              "wall": wall / NEW_TOKENS * 1e3, "compute": compute_s / NEW_TOKENS * 1e3,
              "copy": copy_s / NEW_TOKENS * 1e3, "host_attention": spent[0] / NEW_TOKENS * 1e3},
          "top": [{"kernel": _short(e.key), "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top]})


def tiered_parity() -> None:
    """OPT-6.7B width at 4 layers, half resident: prefill and 4 decode steps of
    the scheduler on the card (bf16, kernels, streamed weights) against the
    CPU (fp32, plain versions and the host tier's golden attention) over the
    same tree, for each TIER_PARITY configuration (int8 KV: the streamed
    layers dequantize each plane and run decode_attention on the card)."""
    from lia_tpu_torch.config import QuantConfig, RuntimeConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.runtime.scheduler import StreamingScheduler
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config("opt-6.7b").replace(num_layers=4)
    cfg32 = cfg.replace(dtype="float32")
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), bool)
    mask[1, :14] = False
    tokens[1, :14] = 1
    steps = rng.integers(2, cfg.vocab_size, (4, 2)).astype(np.int32)
    pos = mask.sum(1).astype(np.int32)

    def run(sched, device):
        with torch.inference_mode():
            logits, state = sched.prefill_pass(tokens, mask, 128)
            out = [logits.float().cpu()]
            for i, st in enumerate(steps):
                logits, state = sched.decode_pass(torch.from_numpy(st).to(device),
                                                  torch.from_numpy(pos + i).to(device), state)
                out.append(logits.float().cpu())
            return torch.stack(out)

    trees = {}
    for label, (p, d), kv, quant in TIER_PARITY:
        key = json.dumps(quant)
        if key not in trees:
            trees.clear()
            qc = None if quant is None else QuantConfig(**quant)
            params = fuse_projections(cfg, device_dummy_params(cfg, seed=1, quant=qc))
            trees[key] = params, to_device(params, "cpu", torch.float32)
        params, params32 = trees[key]
        rt = RuntimeConfig(hbm_percentage=50, prefill_policy=p, decode_policy=d,
                           quant=QuantConfig(kv_cache_dtype=kv))
        gpu = run(StreamingScheduler(cfg, rt, params, "cuda"), "cuda")
        cpu = run(StreamingScheduler(cfg32, rt, params32, "cpu"), "cpu")
        err = (gpu - cpu).abs().max().item()
        tol = PARITY_TOL_INT8_ACT if (quant or {}).get("act_quant") == "dynamic" else PARITY_TOL
        emit({"phase": "parity", "config": label, "layers": 4, "hbm_percentage": 50, "prefill_policy": p,
              "decode_policy": d, "kv": kv, "weights": (quant or {}).get("weight_dtype", "bf16"), "batch": 2,
              "prompt": 64, "decode_steps": 4, "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
              "tol": tol, "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
        check(bool(torch.isfinite(gpu).all()), f"parity {label}: non-finite logits on the card")
        check(err <= tol, f"parity {label}: max abs logit err {err} > {tol}")
    trees.clear()
    torch.cuda.empty_cache()


def tiered_phase(ca, cm, cfg, prompts):
    """The tiering configurations at OPT-6.7B full width and depth: bf16
    weights from one pinned host tree (h50-p3, h0-p3 over int8 KV, h50-p0,
    h50-p0-p2 with 4 minibatches, and policy 1 at 2 layers over 2 short
    prompts), then int8dyn weights (h50-p3 over int8 KV) against the resident
    engine on the same tree. Returns (launches by configuration, the bf16 host
    tree, the engines to break down later)."""
    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine, pack_prompts
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.runtime.weight_manager import slice_layer

    tree, make_s = host_tree(cfg)
    layer_bytes = tree_bytes(slice_layer(tree["layers"], 0))
    emit({"phase": "host_tree", "weights": "bf16", "gb": tree_bytes(tree) / 1e9, "seconds": make_s})
    h2d_bandwidth(layer_bytes)
    launches = {}
    for name, kv, hbm, policies, nm, inflight, timed in TIERED:
        _, launches[name], engine = tiered_path(ca, cm, name, cfg, tree, prompts, kv, hbm, policies, nm, inflight,
                                                timed)
        del engine
    # policy 1 (all host) at 2 layers over 2 prompts of 64 tokens: the host's
    # bf16 matmuls are the cost, and no kernel runs
    cfg2 = cfg.replace(num_layers=2)
    _, launches["tier-p1-2layer"], engine = tiered_path(
        ca, cm, "tier-p1-2layer", cfg2, first_layers(tree, 2), [p[:64] for p in prompts[:2]], "none", 0, (1, 1), 1,
        2, timed=False)
    del engine

    # int8dyn weights over int8 KV: the streamed layers' codes arrive column-major
    # (torch._int_mm's fast layout); the prompt's logits equal the resident
    # engine's on the same tree bit for bit (prefill runs the same kernels
    # over the same bytes). Decode differs in one place: the resident layers'
    # int8 fresh-merge kernel folds the K scales into fp32 scores, the
    # streamed layers dequantize the plane to bf16 first and attend (as
    # lia_tpu's attend_decode does), so the first step's logits agree to a
    # tolerance and greedy tokens of random weights may part after it
    qc = QuantConfig(weight_dtype="int8", group_size=-1, kv_cache_dtype="int8", act_quant="dynamic")
    tree8, make_s = host_tree(cfg, qc)
    emit({"phase": "host_tree", "weights": "int8dyn", "gb": tree_bytes(tree8) / 1e9, "seconds": make_s})
    seqs, launches["tier-h50-p3-int8dyn"], engine = tiered_path(ca, cm, "tier-h50-p3-int8dyn", cfg, tree8, prompts,
                                                               "int8", 50, (3, 3), 1, 2, timed=False)
    wm = engine.scheduler.wm
    streamed = wm.get_layer(cfg.num_layers - 1)["attn"]["wqkv"].q
    check(streamed.stride(-2) == 1, f"int8dyn: streamed codes are not column-major (strides {streamed.stride()})")
    from lia_tpu_torch.ops import kv_cache as kvc

    tokens, mask = pack_prompts(prompts, 1)
    pos = torch.from_numpy(mask.sum(1).astype(np.int32)).cuda()
    with torch.inference_mode():
        tier_logits, state = engine.scheduler.prefill_pass(tokens, mask, 384)
        nxt = tier_logits.argmax(-1).to(torch.int32)
        tier_step, _ = engine.scheduler.decode_pass(nxt, pos, state)
    del engine, state
    resident = InferenceEngine(cfg, tree8, RuntimeConfig(quant=QuantConfig(kv_cache_dtype="int8")))
    ref = resident.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS)).sequences
    with torch.inference_mode():
        cache = kvc.init_cache(cfg, len(prompts), 384, torch.bfloat16, quantized=True, device="cuda")
        res_logits, cache = T.prefill(cfg, resident.params, torch.from_numpy(tokens).cuda(),
                                      torch.from_numpy(mask).cuda(), cache)
        res_step, _ = T.decode_step(cfg, resident.params, nxt[:, None], pos[:, None], cache)
    prefill_diff = (tier_logits - res_logits).abs().max().item()
    step_diff = (tier_step - res_step).abs().max().item()
    agree = float((seqs == ref).mean())
    emit({"phase": "tiered_vs_resident", "config": "tier-h50-p3-int8dyn", "prefill_logits_max_abs_diff": prefill_diff,
          "step_logits_max_abs_diff": step_diff, "step_tol": PARITY_TOL_INT8_ACT,
          "step_argmax_agree": float((tier_step.argmax(-1) == res_step.argmax(-1)).float().mean()),
          "tokens_agree": agree, "first_divergent_step": int(np.argmax((seqs != ref).any(0))) if agree < 1 else None})
    check(prefill_diff == 0.0, f"int8dyn: tiered prefill logits differ from the resident engine's by {prefill_diff}")
    check(step_diff <= PARITY_TOL_INT8_ACT, f"int8dyn: first decode step's logits differ by {step_diff}")
    del resident, cache, tree8
    torch.cuda.empty_cache()
    return launches, tree


# ---------------------------------------------------------------------------
# phase 6: parity
# ---------------------------------------------------------------------------


def parity(label: str, kv: str, quant=None):
    """OPT-6.7B width at 2 layers, one tree on both sides: the card (bf16 model,
    kernels) against the CPU (fp32 model, plain versions; quantized records
    move as they are)."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config("opt-6.7b").replace(num_layers=2)
    qc = None if quant is None else QuantConfig(**quant)
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=1, quant=qc))
    cfg32 = cfg.replace(dtype="float32")
    params32 = to_device(params, "cpu", torch.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), bool)
    mask[1, :14] = False  # row 1 is a 50-token prompt, left-padded
    tokens[1, :14] = 1
    steps = rng.integers(2, cfg.vocab_size, (4, 2)).astype(np.int32)  # fixed decode inputs
    S_max = 128

    def run(device, c, p, dtype):
        with torch.inference_mode():
            cache = kvc.init_cache(c, 2, S_max, dtype, quantized=kv == "int8", device=device)
            tok = torch.from_numpy(tokens).to(device)
            m = torch.from_numpy(mask).to(device)
            logits, cache = T.prefill(c, p, tok, m, cache)
            out = [logits.float().cpu()]
            pos = m.to(torch.int32).sum(1)
            for i, st in enumerate(steps):
                t = torch.from_numpy(st).to(device)[:, None]
                logits, cache = T.decode_step(c, p, t, (pos + i)[:, None], cache)
                out.append(logits.float().cpu())
            return torch.stack(out)

    gpu = run("cuda", cfg, params, torch.bfloat16)
    cpu = run("cpu", cfg32, params32, torch.float32)
    err = (gpu - cpu).abs().max().item()
    tol = PARITY_TOL_INT8_ACT if (quant or {}).get("act_quant") == "dynamic" else PARITY_TOL
    emit({"phase": "parity", "config": label, "kv": kv, "layers": 2, "batch": 2, "prompt": 64,
          "decode_steps": 4, "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
          "tol": tol, "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
    check(bool(torch.isfinite(gpu).all()), f"parity {label}: non-finite logits on the card")
    check(err <= tol, f"parity {label}: max abs logit err {err} > {tol}")
    del params
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import _build
    from lia_tpu_torch.ops import cuda_attention as ca
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops.quant import quantize_act, quantize_kv, retag_dynamic_act
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": sorted(paths)})

    rows = kernel_checks(ca, quantize_kv)
    mm_rows = matmul_kernel_checks(cm, quantize_act)

    cfg = get_config("opt-6.7b")
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (16, PROMPT)).tolist()
    L = cfg.num_layers
    per_fwd = 4 * L + 1  # matmul kernel calls per forward: wqkv, wo, fc1, fc2 per layer, the head

    # (label, make_params, kv, kernel calls per forward) of the timed paths;
    # the device breakdowns make their weights anew from the same recipe
    timed = [(f"bf16 weights, {kv} KV", lambda: device_dummy_params(cfg, seed=0), kv, {})
             for kv in ("none", "int8")]
    for label, (qkw, kernels) in CANDIDATES.items():
        qc = QuantConfig(**qkw)
        timed.append((label, lambda qc=qc: device_dummy_params(cfg, seed=0, quant=qc), qc.kv_cache_dtype,
                      {name: n * per_fwd for name, n in kernels.items()}))
    launches, walls = {}, {}
    for label, make, kv, calls in timed:
        launches[label], walls[label] = main_path(ca, cm, label, cfg, make, prompts, kv, calls, timed=True)
    for label, qkw in WEIGHT_ONLY.items():
        launches[label], _ = main_path(
            ca, cm, label, cfg, lambda qc=QuantConfig(**qkw): device_dummy_params(cfg, seed=0, quant=qc),
            prompts, "none", {"woq_matmul": per_fwd}, timed=False)
    cfg2 = cfg.replace(num_layers=2)  # GPTQ: no head record (OPT ties it), 4 linears per layer
    gptq = gptq_params(cfg2, seed=0)
    launches["gptq woq_int4z"], _ = main_path(ca, cm, "gptq woq_int4z", cfg2, lambda: gptq, prompts, "none",
                                              {"woq4z_matmul": 4 * cfg2.num_layers}, timed=False)
    launches["gptq woq_int4z_dyn"], _ = main_path(
        ca, cm, "gptq woq_int4z_dyn", cfg2, lambda: retag_dynamic_act(gptq), prompts, "none",
        {"w4a8_matmul": 4 * cfg2.num_layers}, timed=False)
    del gptq

    parity("bf16 weights, none KV", "none")
    parity("bf16 weights, int8 KV", "int8")
    for label, (qkw, _) in CANDIDATES.items():
        parity(label, qkw["kv_cache_dtype"], qkw)
    parity("woq-int4-g128", "none", WEIGHT_ONLY["woq-int4-g128"])

    tier_launches, tree = tiered_phase(ca, cm, cfg, prompts)
    launches.update(tier_launches)
    tiered_parity()

    # every profiler session comes after the timed runs
    for label, make, kv, _ in timed:
        device_breakdown(label, cfg, make, prompts, kv, walls[label])
    from lia_tpu_torch.engine.engine import InferenceEngine

    for name, kv, hbm, policies, nm, inflight, _ in TIERED:
        if name in ("tier-h50-p3", "tier-h50-p0-p2-mb4"):
            engine = InferenceEngine(cfg, tree, tiered_runtime(kv, hbm, policies, nm, inflight))
            tiered_breakdown(name, engine, prompts)
            del engine
    del tree
    kernel_times(rows)
    matmul_kernel_times(cm, quantize_act, mm_rows)
    int_mm_layout()

    from_run = {"flash_attention_prefill": "bf16 weights, none KV",
                "decode_attention_fresh": "bf16 weights, none KV",
                "decode_attention_fresh_int8": "bf16 weights, int8 KV",
                "w4a8_matmul": "w4a8+int8kv", "woq_matmul": "woq-int4-g128",
                "woq4z_matmul": "gptq woq_int4z", "decode_attention": "tier-h50-p3",
                "decode_attention_stacked": "tier-h50-p3"}  # no reference path runs the stacked entry
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[from_run[name]][name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for name, r in {**rows, **mm_rows}.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
