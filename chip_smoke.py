"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per item:

1. device: the card's name and power limit (nvidia-smi) and torch's view of it;
2. build: every CUDA kernel of lia_tpu_torch/csrc, built with nvcc in parallel;
3. kernel checks: each kernel against its plain PyTorch version on the card at
   the main path's shapes. Attention (OPT-6.7B: B=16, N=N_kv=32, D=128;
   prefill S=256 with left pads; decode past length 272 in a 320-slot bf16 /
   384-slot int8 cache; write-then-attend decode over a 320-slot plane holding
   273 tokens, also at G = 4 and through the stacked entry at a layer offset;
   paged decode over a shuffled 2-layer pool, bs 16, 16 rows of 1-1000 tokens
   with the fresh merge, also at C = 4, G = 4 and D = 64; chunk-over-cache
   attention as a prefix-cache suffix (C=256 at base 768 of 1024 slots), as a
   left-padded first chunk (B=2, C=128) and with a window; grouped-beam decode,
   bf16 and int8, over 4 groups of 4 beams with a 256-slot prompt (group pads
   0/7/31/100) and a 16-token tail, also at G = 4, D = 64 and tail 0); flash
   prefill and bf16 / int8 decode at Llama-3-8B's heads (32 over 8 KV heads,
   D 128), without and with a sliding window of 64 that binds. Quantized
   matmuls at M = 16 (decode rows) and 4096
   (prefill rows) for the wqkv, fc2 and head (K, N) of OPT-6.7B: w4a8 with and
   without zero-points, woq int8 per-channel / int4 g128 / NF4 g128, woq4z g128;
   the stacked w4a8 entry over a 3-layer stack at wqkv and fc2, every layer
   bit for bit against w4a8_matmul on its view. The fused MLP at OPT-6.7B's
   relu, gelu and gelu_new arms (LayerNorm, biases) and Llama-3-8B's SwiGLU
   (RMSNorm), at 1, 16 and 256 rows, twice (its atomics sum in a varying
   order), its workspace left zero;
4. main path: InferenceEngine.generate(fused=True) for opt-6.7b at full width
   and depth with random weights, 16 prompts x 256 tokens, 32 new tokens:
   bf16 weights with bf16 and with int8 KV; bench.py's two candidates
   (int8dyn+int8kv, w4a8+int8kv); weight-only int8, int4 g128 and NF4 g128
   with bf16 KV; and a GPTQ checkpoint (OPT-6.7B width at 2 layers,
   synthesized in AutoGPTQ's packing) as woq_int4z and retagged as
   woq_int4z_dyn. Two gate A/Bs, each on its gate-off run's engine, the two
   sides in turns: bf16 with the fused-MLP gate on (992 fused MLPs: every
   decode step's layers), w4a8+int8kv with the stacked-W4A8 gate on (3968
   stacked launches, 160 w4a8_matmul: the prefill and the heads). Then
   llama-3-8b at full width and
   depth (dummy bf16 weights made once on the card), the same prompts' shape:
   the default engine with bf16 and with int8 KV, and with projections
   unfused, the fused-MLP gate off and on in turns (32 flash prefills, 992 decode
   attention launches, 992 fused MLPs with the gate on). The launch
   counters, zeroed just before one run and read just after it, must show
   each path's kernels exactly; for the bf16 paths, the two candidates, the
   gate A/Bs and the Llama runs prefill ms and decode tokens/s are the median
   of 3 runs. Each configuration's engine is freed before the next is made;
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
6. serving: ContinuousBatcher at OPT-6.7B full width and depth (bf16 weights
   made once), one seeded workload of 64 requests submitted together (32
   share a 256-token prefix and add 16-256 tokens, 32 have 64-512 unique
   tokens; 16-128 new tokens each, no EOS), max_batch 16, max_len 1024, pages
   of 16, after a warm-up of a few requests: serve-slab (bf16 KV),
   serve-slab-int8kv, serve-paged (prefix caching), serve-paged-noapc,
   serve-paged-chunk256 (prefill_chunk 256, no prefix cache) and
   serve-paged-fused8 (fused_steps 8). Each line: stats() (tokens/s, TTFT
   and TPOT percentiles, steps, dispatches, prefix hits), wall time, peak
   memory and the launch counts, checked exactly against the batcher's own
   counters; every request's length and vocabulary, and every page back at
   the end. serve_http: the HTTP front end over serve-paged's batcher, 8
   concurrent /generate requests, /stats and /health. serving_parity:
   OPT-6.7B width at 2 layers, the batcher's functions in its order (prefill,
   page commit, a prefix-cache admission, 4 paged decode steps; insert_slot
   and 4 ragged steps over a bf16 and an int8 slab), card against CPU;
7. beam and score: InferenceEngine.generate_beam at OPT-6.7B full width and
   depth, 4 seeded prompts cut to 256/240/200/160 tokens, 4 beams, 32 new
   tokens, no EOS: beam-nb4 (grouped, bf16 KV) and beam-nb4-int8kv (median of
   3), beam-nb4-expanded, beam-nb4-proc (repetition penalty 1.2,
   no_repeat_ngram_size 3), tier-h50-p3-beam (grouped under the scheduler)
   and tier-h50-p0-beam (expanded, host KV), one run each. Each line: prefill
   ms, decode row-tokens/s (16 rows x 31 steps over the decode seconds), the
   bytes a step's beam shuffle rewrites, peak memory, exact launch counts.
   score: loglikelihood of 16 records of 256 + 32 tokens, resident and
   tier-h50-p3, ms per call, the two agreeing. beam_parity: OPT-6.7B width at
   2 layers, a grouped beam cache and 4 beam_decode_step calls (the CPU run's
   tokens and shuffles forced on both sides) and score_logprobs, card against
   CPU, bf16 and int8 KV;
8. parity: OPT-6.7B width at 2 layers, prefill + 4 decode steps on the card
   (bf16, kernels) against the CPU (fp32, plain versions) over the same tree:
   bf16 weights with both KV types, and int8dyn+int8kv, w4a8+int8kv (gate
   off, then with the stacked W4A8 route: 32 stacked launches) and
   weight-only int4 g128; Llama-3-8B width at 2 layers, projections unfused,
   both gates on (the fused MLP at every layer), bf16 and int8 KV; and the tiered scheduler at 4 layers (half
   resident) under policies 3, 0 and 0/2 with bf16 and with int8 KV, and
   policy 3 over int8dyn weights and int8 KV;
9. device breakdown: one more main-path run per timed OPT configuration and
   of llama-3-8b with bf16 KV under the
   profiler (weights made anew), device time by kernel and the idle share;
   for tier-h50-p3 and tier-h50-p0-p2-mb4, device compute, copies and host
   attention per step; one more beam-nb4 run;
10. kernel times: each kernel's, its plain version's and a PyTorch library
   call's device time (profiler trace, mean of 20 calls, L2 flushed before
   each; the kernel's also from CUDA events, as a cross-check) and the
   wrapper's host time, beside the least time the card could take for the
   same bytes or operations; the library call's time both from the trace
   (with the kernels it held per call) and from events, the events' where
   the trace reads under the bound (the stacked w4a8 entry's library call is
   torch._int_mm, as w4a8_matmul's; the fused MLP's, where no single PyTorch
   call computes the block, the unfused chain of torch calls); torch._int_mm
   over a row- and a column-major int8 weight. Profiling comes last because a
   profiler session slows the process's later launches.

Then the kernels line, fourteen wrappers (for the quantized matmuls, the
decode wqkv call: M=16, K=4096, N=12288; the stacked w4a8 entry's launches
from w4a8+int8kv with its gate on; the fused MLP's at Llama-3-8B's SwiGLU and
16 rows, its launches from the Llama run with the gate on; decode_attention's and the stacked entry's launches from
tier-h50-p3, where the stacked entry, on no path of the reference, launches
0 times; paged_decode_attention's from serve-paged, flash_attention_cached's
from serve-paged-chunk256, the beam kernels' from beam-nb4 and
beam-nb4-int8kv), the card's name and power
limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; without a CUDA device it exits 2 at once.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import itertools
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
REPS = 20  # calls a kernel time averages over
TIMED_RUNS = 3  # generate calls of each timed main path
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
    ("tier-h50-p0-p2-mb4", "none", 50, (0, 2), 4, 2, False),  # host attention: ~40 s a run
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
# continuous-batching serving (ContinuousBatcher) at OPT-6.7B full width and
# depth: one seeded workload of SERVE_REQUESTS requests submitted together
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_MAX_LEN, SERVE_BLOCK = 64, 16, 1024, 16
SERVE_PREFIX = 256  # the shared prefix of half the requests
# beam search at OPT-6.7B full width and depth: BEAM_GROUPS seeded prompts cut to
# BEAM_PROMPT_LENS tokens, BEAM_NB beams each, NEW_TOKENS new tokens, no EOS
BEAM_GROUPS, BEAM_NB, BEAM_RUNS = 4, 4, 3
BEAM_PROMPT_LENS = (256, 240, 200, 160)
BEAM_PROMPT, BEAM_PADS, BEAM_TLEN = 256, (0, 7, 31, 100), 16  # the beam kernels' check shape
SCORE_CONT = 32  # scoring: 16 records of a 256-token context and a 32-token continuation
SERVING = [
    ("serve-slab", dict()),
    ("serve-slab-int8kv", dict(kv_quantized=True)),
    ("serve-paged", dict(paged=True)),
    ("serve-paged-noapc", dict(paged=True, prefix_cache=False)),
    ("serve-paged-chunk256", dict(paged=True, prefill_chunk=256, prefix_cache=False)),
    ("serve-paged-fused8", dict(paged=True, fused_steps=8)),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_T0 = time.perf_counter()


def phase_time(name: str) -> None:
    """The script's wall clock at the end of a phase (where the time limit goes)."""
    emit({"phase": "phase_time", "after": name, "seconds": time.perf_counter() - _T0})


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


def device_trace(fn):
    """Device time of one call of ``fn`` (every kernel it launches), L2 cold: the
    profiler's trace of REPS (flush, fn) pairs without the flush kernels, over
    REPS; with the kernels the trace holds per call, by name. Host time
    between launches is not in it (see host_us)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            _flush()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "ArgMax" not in e.key]
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / REPS / 1e3, {e.key[:80]: e.count / REPS for e in events}


def device_ms(fn) -> float:
    return device_trace(fn)[0]


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
    rows.update(serving_kernel_checks(ca, randn, dpads))
    rows.update(beam_kernel_checks(ca, quantize_kv, randn))
    llama_attention_checks(ca, quantize_kv, randn)
    for name, r in rows.items():
        emit({"phase": "kernel_check", "kernel": name, "max_abs_err": r["max_abs_err"], "tol": KERNEL_TOL})
        check(r["max_abs_err"] <= KERNEL_TOL, f"{name}: max abs err {r['max_abs_err']} > {KERNEL_TOL}")
    from lia_tpu_torch.ops import cuda_mlp

    rows.update(fused_mlp_checks(cuda_mlp))  # checked against its own tolerance inside
    return rows


LLAMA_N, LLAMA_NKV = 32, 8  # Llama-3-8B's heads: G = 4 at D = 128
WINDOW = 64  # a sliding window that binds at the checks' prompt and past lengths


def llama_attention_checks(ca, quantize_kv, randn) -> None:
    """B1, B2 and B3 at Llama-3-8B's heads (32 over 8 KV heads, D 128) on the
    main path's prompt and past lengths, without a window and with one of
    WINDOW tokens that binds (mistral's sliding window: B1's ``window``; the
    decode kernels' contiguous range from the windowed slot mask)."""
    from lia_tpu_torch.ops.attention import decode_attn_ctx

    q, k, v = randn(B, PROMPT, LLAMA_N, D), randn(B, LLAMA_NKV, PROMPT, D), randn(B, LLAMA_NKV, PROMPT, D)
    mask = torch.ones(B, PROMPT, dtype=torch.bool, device="cuda")
    for b, p in enumerate(PADS):
        mask[b, :p] = False
    valid = mask[:, :, None, None]
    qd, kf, vf = randn(B, 1, LLAMA_N, D), randn(B, LLAMA_NKV, 1, D), randn(B, LLAMA_NKV, 1, D)
    kc, vc = randn(2, B, LLAMA_NKV, 320, D), randn(2, B, LLAMA_NKV, 320, D)
    kq = quantize_kv(randn(2, B, LLAMA_NKV, 384, D, dtype=torch.float32))
    vq = quantize_kv(randn(2, B, LLAMA_NKV, 384, D, dtype=torch.float32))
    ln = torch.tensor(PAST, dtype=torch.int32, device="cuda")
    for window in (None, WINDOW):
        variant = "G=4 D=128" + ("" if window is None else f" window {window}")
        out = ca.flash_attention_prefill(q, k, v, mask, window=window)
        ref = ca.flash_attention_prefill_plain(q, k, v, mask, window=window)
        errs = {"flash_attention_prefill": ((out.float() - ref.float()) * valid).abs().max().item()}
        for kernel, S_max, args in (("decode_attention_fresh", 320, (qd, kf, vf, kc, vc, 1)),
                                    ("decode_attention_fresh_int8", 384, (qd, kf, vf, kq.q, kq.s, vq.q, vq.s, 1))):
            sm = torch.zeros(B, S_max, dtype=torch.bool, device="cuda")
            for b, p in enumerate([0, 3, 7, 15] * 4):
                sm[b, p:PAST] = True
            ctx = decode_attn_ctx(sm, ln, window)
            out = getattr(ca, kernel)(*args, ctx.slot_mask, ln)
            ref = getattr(ca, kernel + "_plain")(*args, ctx.slot_mask, ln)
            errs[kernel] = (out.float() - ref.float()).abs().max().item()
        torch.cuda.synchronize()
        for kernel, err in errs.items():
            emit({"phase": "kernel_check", "kernel": kernel, "variant": variant, "max_abs_err": err, "tol": KERNEL_TOL})
            check(err <= KERNEL_TOL, f"{kernel} {variant}: max abs err {err} > {KERNEL_TOL}")


# (label, H, F, activation, RMSNorm, biases): OPT-6.7B's three arms and Llama-3-8B's SwiGLU
FUSED_MLP_CASES = [
    ("opt-6.7b relu", 4096, 16384, "relu", False, True),
    ("opt-6.7b gelu", 4096, 16384, "gelu", False, True),
    ("opt-6.7b gelu_new", 4096, 16384, "gelu_new", False, True),
    ("llama-3-8b swiglu", 4096, 14336, "silu", True, False),
]
FUSED_MLP_ROWS = (1, 16, 256)  # one sequence, the b16 decode step, the kernel's most
FUSED_MLP_TOL = 2e-2  # |kernel - plain| <= tol * (1 + |plain|): bf16 outputs of O(1)
# round once at the end (one step is 2^-7 relative); the fp32 sums run in
# another order (the kernel's atomics in one that varies run to run), which can
# also move a rounding of the normed input or of the activation by one step


def fused_mlp_checks(cuda_mlp) -> dict:
    """B14 against its plain version at each case and row count (twice, the
    atomics' order varying; the workspace left zero); returns the kernels
    line's row: Llama-3-8B's SwiGLU at 16 rows, timed against the plain
    version and the unfused torch chain (norm, matmuls, activation, add), the
    yardstick where no single PyTorch call computes the block."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    row = None
    for label, H, Fd, act, rms, biases in FUSED_MLP_CASES:
        def r(*shape, sc=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * sc).to(torch.bfloat16)

        w = dict(ln_scale=(1 + r(H, sc=0.1).float()).to(torch.bfloat16), ln_bias=r(H, sc=0.1) if biases else None,
                 w1=r(H, Fd, sc=0.02), b1=r(Fd, sc=0.1) if biases else None,
                 wg=r(H, Fd, sc=0.02) if act == "silu" else None, w2=r(Fd, H, sc=0.02),
                 b2=r(H, sc=0.1) if biases else None)
        for rows in FUSED_MLP_ROWS:
            x = r(rows, H)
            out = cuda_mlp.fused_mlp(x, **w, activation=act, rms=rms)
            again = cuda_mlp.fused_mlp(x, **w, activation=act, rms=rms)
            ref = cuda_mlp.fused_mlp_plain(x, **w, activation=act, rms=rms)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            excess = (d - FUSED_MLP_TOL * (1 + ref.float().abs())).max().item()
            ws, tickets = cuda_mlp._workspace(torch.cuda.current_device(), H)
            line = {"phase": "kernel_check", "kernel": "fused_mlp", "variant": label, "rows": rows,
                    "max_abs_err": d.max().item(),
                    "max_abs_err_rerun": (again.float() - out.float()).abs().max().item(),
                    "max_abs_plain": ref.float().abs().max().item(), "tol": f"{FUSED_MLP_TOL} * (1 + |plain|)",
                    "workspace_zero": not bool(ws.any() or tickets.any())}
            emit(line)
            check(bool(torch.isfinite(out.float()).all()), f"fused_mlp {label} rows={rows}: non-finite output")
            check(excess <= 0 and line["workspace_zero"], f"fused_mlp {label} rows={rows}: {line}")
            if label.startswith("llama") and rows == B:
                swiglu = act == "silu"

                def chain(x=x, w=w, rms=rms, act=act, swiglu=swiglu):
                    h = (F.rms_norm(x, (H,), w["ln_scale"], 1e-5) if rms
                         else F.layer_norm(x, (H,), w["ln_scale"], w["ln_bias"], 1e-5))
                    if swiglu:
                        a = F.silu(h @ w["wg"]) * (h @ w["w1"])
                    else:
                        a = {"relu": F.relu, "gelu": F.gelu}[act](torch.addmm(w["b1"], h, w["w1"]))
                    return x + (a @ w["w2"] if w["b2"] is None else torch.addmm(w["b2"], a, w["w2"]))

                weight_bytes = 2 * H * Fd * (3 if swiglu else 2)
                nbytes = 2 * 2 * rows * H + weight_bytes + 2 * (2 * H + Fd)
                row = dict(source="lia_tpu_torch/csrc/fused_mlp.cu", replaces="lia_tpu/ops/pallas_mlp.py:98",
                           max_abs_err=line["max_abs_err"],
                           kernel=lambda x=x, w=w, a=act, n=rms: cuda_mlp.fused_mlp(x, **w, activation=a, rms=n),
                           plain=lambda x=x, w=w, a=act, n=rms: cuda_mlp.fused_mlp_plain(x, **w, activation=a, rms=n),
                           library=chain, library_kind="chain of torch calls: norm, matmuls, activation, add",
                           bound=bound(nbytes, 2 * rows * H * Fd * (3 if swiglu else 2)))
    return {"fused_mlp": row}


def paged_case(randn, lengths, C: int, Nkv: int, G: int, Dh: int, P: int = SERVE_MAX_LEN // SERVE_BLOCK,
               bs: int = SERVE_BLOCK, L: int = 2):
    """A shuffled two-layer paged pool at serving's shapes (P table entries per
    row): each row's pages are drawn at random from blocks 1.., the table's
    unused entries hold the null page 0; q [B, C, N, D] and the fresh chunk
    [B, N_kv, C, D]."""
    Bq = len(lengths)
    nb = Bq * P + 1
    kp, vp = randn(L, nb, Nkv, bs, Dh), randn(L, nb, Nkv, bs, Dh)
    g = torch.Generator()
    g.manual_seed(3)
    perm = torch.randperm(nb - 1, generator=g) + 1
    table = torch.zeros(Bq, P, dtype=torch.int32)
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        table[b, :used] = perm[b * P : b * P + used].to(torch.int32)
    q = randn(Bq, C, Nkv * G, Dh)
    kf, vf = randn(Bq, Nkv, C, Dh), randn(Bq, Nkv, C, Dh)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.cuda(), lens, kf, vf


def cached_case(randn, Bq: int, C: int, base: int, pads, S_max: int = SERVE_MAX_LEN):
    """A chunk of C rows over an S_max-slot plane that holds it at [base, base +
    C), each row's validity starting at its pad (a first chunk's pad rows, or
    0 over a cached prefix)."""
    q = randn(Bq, C, N, D)
    kc, vc = randn(Bq, N, S_max, D), randn(Bq, N, S_max, D)
    sm = torch.zeros(Bq, S_max, dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        sm[b, p : base + C] = True
    return q, kc, vc, torch.tensor(base, dtype=torch.int32, device="cuda"), sm


def serving_kernel_checks(ca, randn, dpads):
    """paged_decode_attention (B5) and flash_attention_cached (B6) against their
    plain versions at serving's shapes (OPT-6.7B heads, bs 16, 1024 slots),
    and the timing rows of the kernels line: B5 at B2's row's keys (16 rows,
    lengths 272 - pad), B6 as a prefix-cache suffix (B=1, C=256, base=768)."""
    import torch.nn.functional as F

    def compare(name, variant, out, ref, valid=None):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name} {variant}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = (diff if valid is None else diff * valid).max().item()
        emit({"phase": "kernel_check", "kernel": name, "variant": variant, "max_abs_err": err, "tol": KERNEL_TOL})
        check(err <= KERNEL_TOL, f"{name} {variant}: max abs err {err} > {KERNEL_TOL}")
        return err

    # B5: ragged lengths 1..1000 over a shuffled pool, C=1 with the fresh merge;
    # then C=4, GQA (G=4) and D=64
    lengths = np.linspace(1, 1000, B).astype(int).tolist()
    for variant, C, Nkv, G, Dh in (("C=1", 1, N, 1, D), ("C=4", 4, N, 1, D), ("GQA G=4", 1, N // 4, 4, D),
                                   ("D=64", 1, N, 1, 64)):
        q, kp, vp, table, lens, kf, vf = paged_case(randn, lengths, C, Nkv, G, Dh)
        args = (q, kp, vp, 1, table, lens, kf, vf)
        compare("paged_decode_attention", variant, ca.paged_decode_attention(*args),
                ca.paged_decode_attention_plain(*args))
    del kp, vp
    rows = {}
    # the timed case: B2's keys (lengths 272 - pad), C=1, layer 1 of a 2-layer
    # pool of the pages those need (its inputs live until the timing phase)
    t_lengths = [PAST - p for p in dpads]
    q, kp, vp, table, lens, kf, vf = paged_case(randn, t_lengths, 1, N, 1, D, P=-(-(PAST + 1) // SERVE_BLOCK))
    args = (q, kp, vp, 1, table, lens, kf, vf)
    err = compare("paged_decode_attention", "timed: lengths 272 - pad", ca.paged_decode_attention(*args),
                  ca.paged_decode_attention_plain(*args))
    # yardstick: SDPA over the same keys gathered into a contiguous plane, the
    # fresh token written at each row's length (the gather is not timed)
    S = table.shape[1] * SERVE_BLOCK
    kg = kp[1][table.long()].permute(0, 2, 1, 3, 4).reshape(B, N, S, D)
    vg = vp[1][table.long()].permute(0, 2, 1, 3, 4).reshape(B, N, S, D)
    rows_idx = torch.arange(B, device="cuda")
    kg[rows_idx, :, lens.long()] = kf[:, :, 0]
    vg[rows_idx, :, lens.long()] = vf[:, :, 0]
    gmask = (torch.arange(S, device="cuda")[None, :] <= lens[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    keys = sum(t_lengths)
    table_bytes = table.numel() * 4 + lens.numel() * 4
    rows["paged_decode_attention"] = dict(
        source="lia_tpu_torch/csrc/paged_decode.cu",
        replaces="lia_tpu/ops/paged.py:601",
        max_abs_err=err,
        kernel=lambda: ca.paged_decode_attention(*args),
        plain=lambda: ca.paged_decode_attention_plain(*args),
        library=lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=gmask),
        bound=bound(keys * N * D * 2 * 2 + 4 * q.numel() * 2 + table_bytes, 4 * D * N * (keys + B)),
    )

    # B6: a prefix-cache suffix (B=1, C=256, base=768 of 1024 slots), a first
    # chunk with left pads (B=2, C=128, base=0), and a sliding window
    for variant, Bq, C, base, pads, window in (("APC suffix", 1, 256, 768, [0], None),
                                               ("first chunk, left pads", 2, 128, 0, [5, 77], None),
                                               ("window 300", 1, 256, 768, [0], 300)):
        q6, kc6, vc6, b6, sm6 = cached_case(randn, Bq, C, base, pads)
        valid = torch.zeros(Bq, C, 1, 1, dtype=torch.bool, device="cuda")
        for b, p in enumerate(pads):
            valid[b, max(p - base, 0):] = True
        err6 = compare("flash_attention_cached", variant,
                       ca.flash_attention_cached(q6, kc6, vc6, b6, sm6, window=window),
                       ca.flash_attention_cached_plain(q6, kc6, vc6, b6, sm6, window=window), valid)
        if variant == "APC suffix":
            timed6 = (q6, kc6, vc6, b6, sm6, err6)
    q6, kc6, vc6, b6, sm6, err6 = timed6
    C6, base6 = q6.shape[1], int(b6)
    qpos = base6 + torch.arange(C6, device="cuda")
    cmask = ((torch.arange(SERVE_MAX_LEN, device="cuda")[None, :] <= qpos[:, None]) & sm6[0][None, :])[None, None]
    keys6 = sum(base6 + t + 1 for t in range(C6))
    q6t = q6.transpose(1, 2)
    rows["flash_attention_cached"] = dict(
        source="lia_tpu_torch/csrc/flash_cached.cu",
        replaces="lia_tpu/ops/pallas_attention.py:310",
        max_abs_err=err6,
        kernel=lambda: ca.flash_attention_cached(q6, kc6, vc6, b6, sm6),
        plain=lambda: ca.flash_attention_cached_plain(q6, kc6, vc6, b6, sm6),
        library=lambda: F.scaled_dot_product_attention(q6t, kc6, vc6, attn_mask=cmask),
        bound=bound(2 * kc6.numel() * 2 + 2 * q6.numel() * 2 + sm6.numel() + 4, 4 * D * N * keys6),
    )
    return rows


def beam_case(ca, quantize_kv, randn, int8: bool, Nkv: int = N, Dh: int = D, tlen: int = BEAM_TLEN, L: int = 2):
    """Grouped-beam kernel inputs at the beam path's shapes (OPT-6.7B heads,
    BEAM_GROUPS groups of BEAM_NB beams over a BEAM_PROMPT-slot prompt with the
    groups' left pads BEAM_PADS, ``tlen`` tail slots of a 32-slot bf16 or
    128-slot int8 tail), over layer 1 of a 2-layer cache: (kernel, plain
    version, args, prompt keys per group)."""
    B = BEAM_GROUPS * BEAM_NB
    q = randn(B, 1, N, Dh)
    kf, vf = randn(B, Nkv, 1, Dh), randn(B, Nkv, 1, Dh)
    pm = torch.zeros(BEAM_GROUPS, BEAM_PROMPT, dtype=torch.bool, device="cuda")
    for g, p in enumerate(BEAM_PADS):
        pm[g, p:] = True
    lens = (pm, torch.tensor(BEAM_PROMPT, dtype=torch.int32, device="cuda"),
            torch.tensor(tlen, dtype=torch.int32, device="cuda"), BEAM_NB)
    T_max = 128 if int8 else 32
    if int8:
        planes = [x for rows, S in ((BEAM_GROUPS, BEAM_PROMPT), (B, T_max)) for _ in range(2)
                  for x in quantize_kv(randn(L, rows, Nkv, S, Dh, dtype=torch.float32))]
        return ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain, (q, kf, vf, *planes, 1, *lens)
    planes = [randn(L, rows, Nkv, S, Dh) for rows, S in ((BEAM_GROUPS, BEAM_PROMPT), (B, T_max)) for _ in range(2)]
    return ca.decode_beam_attention, ca.decode_beam_attention_plain, (q, kf, vf, *planes, 1, *lens)


def beam_kernel_checks(ca, quantize_kv, randn):
    """decode_beam_attention (B9) and decode_beam_attention_int8 (B10) against
    their plain versions at the beam path's shape (4 groups of 4 beams, 32
    heads, D = 128, a 256-slot prompt with group pads 0/7/31/100, tail length
    16), then at G = 4, D = 64 and tail length 0; the timing rows of the
    kernels line. The library yardstick is SDPA over each beam's concatenated
    view [group prompt | tail | fresh] (int8: dequantized to bf16), the
    concatenation not timed."""
    import torch.nn.functional as F

    from lia_tpu_torch.ops.quant import QuantizedKV, dequantize_kv

    rows = {}
    for int8, name, source, replaces in ((False, "decode_beam_attention", "lia_tpu_torch/csrc/beam_decode.cu",
                                          "lia_tpu/ops/pallas_attention.py:813"),
                                         (True, "decode_beam_attention_int8", "lia_tpu_torch/csrc/beam_decode_int8.cu",
                                          "lia_tpu/ops/pallas_attention.py:992")):
        for variant, kw in (("GQA G=4", dict(Nkv=N // 4)), ("D=64", dict(Dh=64)), ("tail 0", dict(tlen=0))):
            kernel, plain, args = beam_case(ca, quantize_kv, randn, int8, **kw)
            out, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            emit({"phase": "kernel_check", "kernel": name, "variant": variant, "max_abs_err": err, "tol": KERNEL_TOL})
            check(bool(torch.isfinite(out).all()) and err <= KERNEL_TOL, f"{name} {variant}: max abs err {err}")
        kernel, plain, args = beam_case(ca, quantize_kv, randn, int8)
        out, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        q, kf, vf = args[:3]
        B = q.shape[0]
        group = torch.arange(B, device="cuda") // BEAM_NB
        if int8:
            kp, vp, kt, vt = (dequantize_kv(QuantizedKV(c[1], sc[1])) for c, sc in zip(args[3:11:2], args[4:11:2]))
            row_bytes = D + 4  # int8 codes and an f32 scale
        else:
            kp, vp, kt, vt = (x[1] for x in args[3:7])
            row_bytes = 2 * D
        k_all = torch.cat([kp[group], kt, kf], dim=2)
        v_all = torch.cat([vp[group], vt, vf], dim=2)
        pm = args[-4]
        T_max = kt.shape[2]
        tail_ok = (torch.arange(T_max, device="cuda") < BEAM_TLEN)[None].expand(B, T_max)
        amask = torch.cat([pm[group], tail_ok, torch.ones(B, 1, dtype=torch.bool, device="cuda")], 1)[:, None, None]
        qt = q.transpose(1, 2)
        prompt_keys = sum(BEAM_PROMPT - p for p in BEAM_PADS)  # read once per group
        beam_keys = BEAM_NB * prompt_keys + B * BEAM_TLEN  # attended over all beams
        nbytes = (prompt_keys + B * BEAM_TLEN) * N * row_bytes * 2 + 4 * q.numel() * 2 + pm.numel() + 8
        rows[name] = dict(
            source=source, replaces=replaces, max_abs_err=(out.float() - ref.float()).abs().max().item(),
            kernel=lambda kernel=kernel, args=args: kernel(*args), plain=lambda plain=plain, args=args: plain(*args),
            library=lambda qt=qt, k_all=k_all, v_all=v_all, amask=amask: F.scaled_dot_product_attention(
                qt, k_all, v_all, attn_mask=amask),
            bound=bound(nbytes, 4 * D * N * (beam_keys + B)),
        )
        emit({"phase": "beam_bound", "kernel": name, "bytes": nbytes, "prompt_bytes": prompt_keys * N * row_bytes * 2,
              "prompt_bytes_read_per_beam": BEAM_NB * prompt_keys * N * row_bytes * 2})
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


STACK_LAYERS = 3  # B13's checks: a stack of this many layers, each layer read in turn


def stacked_cases(cm, quantize_act):
    """B13 (the stacked W4A8 entry) over a 3-layer stack at OPT-6.7B's wqkv and
    fc2, M = 16 and 4096, with and without zero-points; the layer index lives
    in device memory. Each case checks every layer bit for bit against B4 on
    the layer's view (``b4_equal``) and times layer 1 against the plain
    version and the library yardstick (``torch._int_mm`` over the layer's
    unpacked codes, as B4's row)."""
    from lia_tpu_torch.ops.quant import unpack_nibbles

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    L, li = STACK_LAYERS, 1
    layers = torch.arange(L, dtype=torch.int32, device="cuda")
    for shape in ("wqkv", "fc2"):
        K, N = OPT_KN[shape]
        ng = K // GROUP
        q = torch.randint(0, 256, (L, K // 2, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
        s = torch.rand(L, ng, N, generator=gen, device="cuda") * 1e-3 + 1e-3
        z = torch.randint(0, 16, (L, ng, N), generator=gen, device="cuda", dtype=torch.int32).float()
        codes8 = (unpack_nibbles(q[li]) - 8).to(torch.int8).t().contiguous().t()
        for M in MATMUL_M:
            x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
            xq, sx = quantize_act(x)
            xq_pad = torch.cat([xq, xq.new_zeros(max(0, 32 - M), K)])
            for zz, variant in ((None, "g128"), (z, "g128 zero-points")):
                def b4_equal(zz=zz, xq=xq, sx=sx):
                    return all(torch.equal(cm.w4a8_matmul_stacked(xq, sx, q, s, zz, layers[i]),
                                           cm.w4a8_matmul(xq, sx, q[i], s[i], None if zz is None else zz[i]))
                               for i in range(L))

                nbytes = M * K + 4 * M + K * N // 2 + 4 * ng * N * (1 if zz is None else 2) + 4 * M * N + 4
                yield dict(name="w4a8_matmul_stacked", variant=variant, M=M, K=K, N=N, shape=shape,
                           kernel=lambda zz=zz, xq=xq, sx=sx: cm.w4a8_matmul_stacked(xq, sx, q, s, zz, layers[li]),
                           plain=lambda zz=zz, xq=xq, sx=sx: cm.w4a8_matmul_stacked_plain(xq, sx, q, s, zz, li),
                           library=lambda xq_pad=xq_pad: torch._int_mm(xq_pad, codes8),
                           bound=bound(nbytes, 2 * M * K * N, PEAK_INT8_OP_PER_S), b4_equal=b4_equal,
                           representative=(M == 16 and shape == "wqkv" and zz is None))


MATMUL_ROWS = {
    "w4a8_matmul": ("lia_tpu_torch/csrc/w4a8_matmul.cu", "lia_tpu/ops/pallas_matmul.py:409"),
    "w4a8_matmul_stacked": ("lia_tpu_torch/csrc/w4a8_matmul.cu", "lia_tpu/ops/pallas_matmul.py:491"),
    "woq4z_matmul": ("lia_tpu_torch/csrc/woq_matmul.cu", "lia_tpu/ops/pallas_matmul.py:601"),
    "woq_matmul": ("lia_tpu_torch/csrc/woq_matmul.cu", "lia_tpu/ops/pallas_matmul.py:658"),
}


def matmul_kernel_checks(cm, quantize_act):
    """Each quantized-matmul case against its plain version; returns the kernels
    line's rows (their representative case: decode wqkv)."""
    rows = {}
    for c in itertools.chain(matmul_cases(cm, quantize_act), stacked_cases(cm, quantize_act)):
        out, ref = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{c['name']} {c['variant']}: non-finite output")
        abs_err = (out - ref).abs().max().item()
        rel = abs_err / max(ref.abs().max().item(), 1e-30)
        line = {"phase": "kernel_check", "kernel": c["name"], "variant": c["variant"], "M": c["M"],
                "K": c["K"], "N": c["N"], "max_abs_err": abs_err, "rel_err": rel, "tol": MATMUL_TOL}
        if "b4_equal" in c:  # every layer of the stack bit for bit against B4 on its view
            line["bit_equal_to_w4a8_matmul_at_every_layer"] = c["b4_equal"]()
            check(line["bit_equal_to_w4a8_matmul_at_every_layer"], f"{c['name']} {c['variant']} M={c['M']} "
                                                                   f"K={c['K']}: differs from w4a8_matmul")
        emit(line)
        check(rel <= MATMUL_TOL, f"{c['name']} {c['variant']} M={c['M']} K={c['K']} N={c['N']}: "
                                 f"relative error {rel} > {MATMUL_TOL}")
        if c["representative"]:
            source, replaces = MATMUL_ROWS[c["name"]]
            rows[c["name"]] = dict(source=source, replaces=replaces, max_abs_err=abs_err)
        del out, ref
    return rows


def matmul_kernel_times(cm, quantize_act, rows) -> None:
    """Device times of every quantized-matmul case (kernel, plain version, library
    call) beside its bound, and of the stacked entry at the wqkv shape (its
    other cases run B4's body at the same shapes); the representative cases
    fill the kernels line."""
    stacked = (c for c in stacked_cases(cm, quantize_act) if c["shape"] == "wqkv" and c["variant"] == "g128")
    for c in itertools.chain(matmul_cases(cm, quantize_act), stacked):
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
        lib = dict(library_ms=None, library_timed_by=None)
        if r["library"]:
            # both readings, with the kernels the trace held per call: a trace
            # that misses kernels (none at all where a library launches a CUDA
            # graph; the fused MLP's torch chain once read 0.039 ms against its
            # 0.105 ms bound) reads under the bound, and the events measure it
            prof_ms, traced = device_trace(r["library"])
            ev_ms = event_ms(r["library"])
            below = prof_ms < r["bound"][0]
            lib = dict(library_ms=ev_ms if below else prof_ms, library_timed_by="events" if below else "profiler",
                       library_profiler_ms=prof_ms, library_event_ms=ev_ms, library_kernels_traced=traced)
        r["library_ms"] = lib["library_ms"]
        emit({"phase": "kernel_time", "kernel": name, "ms": r["ms"], "event_ms": r["event_ms"], "host_us": r["host_us"],
              "plain_ms": r["plain_ms"], **lib,
              "library_kind": r.get("library_kind", "one call"), "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


def launch_counts(ca, cm) -> dict:
    from lia_tpu_torch.ops import cuda_mlp

    return {**ca.launch_counts(), **cm.launch_counts(), **cuda_mlp.launch_counts()}


def reset_counts(ca, cm) -> None:
    from lia_tpu_torch.ops import cuda_mlp

    for mod in (ca, cm, cuda_mlp):
        mod.reset_launch_counts()


@contextlib.contextmanager
def gates(stacked_w4a8: bool = False, fused_mlp: bool = False):
    """The port's two gated routes on for the duration (off by default)."""
    from lia_tpu_torch.ops import dispatch

    dispatch.set_stacked_w4a8(stacked_w4a8)
    dispatch.set_fused_mlp(fused_mlp)
    try:
        yield
    finally:
        dispatch.set_stacked_w4a8(False)
        dispatch.set_fused_mlp(False)


def main_path(ca, cm, label: str, cfg, make_params, prompts, kv: str, per_forward: dict, timed: bool,
              runtime=None, ab=None) -> dict:
    """One configuration through ``generate(fused=True)``. The counters are zeroed
    just before one run and read just after: prefill attention once per layer,
    decode attention per layer per step and each matmul kernel of
    ``per_forward`` that many times per forward pass (prefill and 31 steps).
    ``runtime``: the engine's RuntimeConfig arguments besides the KV type.
    ``ab``: (gate, exact) for a gate A/B on the same engine: the gated route
    on (:func:`gates`) in the second side, whose run launches each kernel of
    ``exact`` exactly that many times (the rest as the first side), the two
    sides run in turns (off, on, then off, on, on, off), since only runs of
    one call in turns compare. ``timed``: a warm-up first and TIMED_RUNS runs a
    side (median and all) of prefill ms and decode tokens/s; else the counted
    run's own numbers. Returns {label: (launches, median wall s)} per side.
    The engine lives only as long as this call."""
    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.ops import kv_cache as kvc

    engine = InferenceEngine(cfg, make_params(), RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv), **(runtime or {})))
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    L, steps = cfg.num_layers, gen.max_new_tokens - 1
    expected = {name: 0 for name in launch_counts(ca, cm)}
    expected["flash_attention_prefill"] = L
    expected["decode_attention_fresh_int8" if kv == "int8" else "decode_attention_fresh"] = L * steps
    for name, n in per_forward.items():
        expected[name] = n * (1 + steps)
    sides = [(label, {}, expected)]
    if ab:
        gate, exact = ab
        sides.append((f"{label}, {gate}", {gate: True}, {**expected, **exact}))
    runs, launches, peak = {}, {}, {}
    for name, gate, _ in sides:
        with gates(**gate):
            if timed:
                engine.generate(prompts, gen, fused=True)  # warm-up (cuBLAS handles, kernel loads)
    for name, gate, want in sides:
        with gates(**gate):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ca, cm)
            res = engine.generate(prompts, gen, fused=True)
            launches[name] = launch_counts(ca, cm)
            check(launches[name] == want, f"{name}: launches {launches[name]} != expected {want}")
            peak[name] = torch.cuda.max_memory_allocated()
            seqs = res.sequences
            check(seqs.shape == (len(prompts), gen.max_new_tokens), f"{name}: sequences shape {seqs.shape}")
            check(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), f"{name}: token outside the vocabulary")
            runs[name] = [res.summary()]
    # the eager loop is bound by host time, and the host's cores are shared:
    # report the median of TIMED_RUNS runs a side (the counted one first) and all of them
    order = [sides[(i + 1) // 2 % len(sides)] for i in range(2 * (TIMED_RUNS - 1))] if ab else sides * (TIMED_RUNS - 1)
    for name, gate, _ in order if timed else ():
        with gates(**gate):
            runs[name].append(engine.generate(prompts, gen, fused=True).summary())

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

    out = {}
    for name, gate, _ in sides:
        record = {
            "phase": "main_path", "config": name, "model": cfg.name, "layers": L, "kv": kv,
            "runtime": runtime or {}, "gates": gate,
            "batch": len(prompts), "prompt": len(prompts[0]), "new_tokens": gen.max_new_tokens,
            "launches": launches[name], "peak_mem_gb": peak[name] / 1e9,
        }
        for key, field, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                                  ("decode_tokens_per_s", "decode_tokens_per_s", 1.0),
                                  ("total_latency_s", "total_s", 1.0)):
            vals = [r[key] * scale for r in runs[name]]
            record[field], record[field + "_runs"] = statistics.median(vals), vals
        emit(record)
        out[name] = (launches[name], record["total_s"])
    del engine, cache, logits, logits2
    torch.cuda.empty_cache()
    return out


LLAMA_CELL = "llama-3-8b, bf16 KV"
LLAMA_WALL = {}  # median wall seconds of each Llama configuration (the device breakdown's denominator)


def llama_prompts(cfg):
    return np.random.default_rng(0).integers(2, cfg.vocab_size, (16, PROMPT)).tolist()


def llama_phase(ca, cm) -> dict:
    """Llama-3-8B at full width and depth (H 4096, F 14336, 32 heads over 8 KV
    heads, vocab 128 256; dummy bf16 weights made once on the card), 16
    prompts x 256 tokens, 32 new tokens through generate(fused=True): the
    default engine (fused projections) with bf16 and with int8 KV, then
    projections unfused with the fused-MLP gate off and on in turns. Exact
    launches: 32 flash prefills, 992 decode-attention launches, and 992 fused
    MLPs with the gate on (the prefill's 4096 rows stay unfused)."""
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    cfg = get_config("llama-3-8b")
    tree = device_dummy_params(cfg, seed=0)
    emit({"phase": "llama_weights", "model": cfg.name, "gb": tree_bytes(tree) / 1e9})
    prompts = llama_prompts(cfg)
    out = {}
    for label, kv, runtime, ab in (
        (LLAMA_CELL, "none", None, None),
        ("llama-3-8b, int8 KV", "int8", None, None),
        ("llama-3-8b, unfused projections, bf16 KV", "none", {"fuse_projections": False},
         ("fused_mlp", {"fused_mlp": cfg.num_layers * (NEW_TOKENS - 1)})),
    ):
        out.update(main_path(ca, cm, label, cfg, lambda: tree, prompts, kv, {}, timed=True, runtime=runtime, ab=ab))
    del tree
    torch.cuda.empty_cache()
    LLAMA_WALL.update({name: wall for name, (_, wall) in out.items()})
    return {name: counts for name, (counts, _) in out.items()}


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
    out = {name: 0 for name in launch_counts(ca, cm)}
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
    reset_counts(ca, cm)
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
    # against what the engine added to what the card held before it was made
    # (the kernel checks' inputs, kept for the timing phase)
    check(peak - base < limit, f"{name}: peak device memory {(peak - base) / 1e9:.2f} GB above the residency "
                               f"limit {limit / 1e9:.2f} GB: streamed layers stayed on the card")
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
          "held_after_init_gb": held / 1e9, "peak_mem_gb": peak / 1e9, "held_before_gb": base / 1e9,
          "residency_limit_gb": limit / 1e9,
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
# phase 6: continuous-batching serving
# ---------------------------------------------------------------------------


def serving_workload(vocab: int):
    """SERVE_REQUESTS requests from one seed, in a shuffled order: half share a
    SERVE_PREFIX-token prefix followed by 16-256 unique tokens, half are unique
    with 64-512 tokens; max_new_tokens 16-128 each, and no EOS."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(2, vocab, SERVE_PREFIX).tolist()
    half = SERVE_REQUESTS // 2
    prompts = [prefix + rng.integers(2, vocab, int(rng.integers(16, 257))).tolist() for _ in range(half)]
    prompts += [rng.integers(2, vocab, int(rng.integers(64, 513))).tolist() for _ in range(half)]
    new = rng.integers(16, 129, SERVE_REQUESTS).tolist()
    order = rng.permutation(SERVE_REQUESTS)
    return [prompts[i] for i in order], [new[i] for i in order]


def serving_expected(cfg, opts: dict, stats: dict, prompts, names) -> dict:
    """Kernel launches of one serving run, from the batcher's own counters:
    every decode step runs one attention kernel per layer (the paged kernel
    over the pool, the fresh-merge kernel over the slab); every admission runs
    one prefill attention per layer: flash_attention_cached per chunk of a
    chunked admission (prefill_chunk, no prefix cache: ceil(n / chunk) chunks)
    and per prefix-cache hit (one suffix chunk), flash_attention_prefill for
    every other admission. Nothing else launches (bf16 weights: cuBLAS)."""
    L, steps = cfg.num_layers, int(stats["decode_steps"])
    out = {name: 0 for name in names}
    if opts.get("paged"):
        out["paged_decode_attention"] = L * steps
    else:
        out["decode_attention_fresh_int8" if opts.get("kv_quantized") else "decode_attention_fresh"] = L * steps
    chunk = opts.get("prefill_chunk")
    hits = int(stats.get("prefix_hits", 0))
    if chunk:
        out["flash_attention_cached"] = L * sum(-(-len(p) // chunk) for p in prompts)
    else:
        out["flash_attention_cached"] = L * hits
        out["flash_attention_prefill"] = L * (len(prompts) - hits)
    return out


def serving_path(ca, cm, name: str, opts: dict, cfg, params, prompts, new_tokens):
    """One serving configuration: SERVE_REQUESTS requests through a fresh
    ContinuousBatcher, counters zeroed just before the run and read just after
    it and checked exactly, every request's length and vocabulary, and (paged)
    the pool's accounting at the end. Returns (launches, the batcher)."""
    import gc

    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.serving import ContinuousBatcher

    gc.collect()  # the HTTP handler class of serve_http holds the last batcher in a reference cycle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the weights, and the kernel checks' inputs
    cb = ContinuousBatcher(cfg, params, max_batch=SERVE_MAX_BATCH, max_len=SERVE_MAX_LEN,
                           gen=GenerationConfig(max_new_tokens=128), block_size=SERVE_BLOCK, **opts)
    reset_counts(ca, cm)
    t0 = time.perf_counter()
    ids = [cb.submit(p, max_new_tokens=n) for p, n in zip(prompts, new_tokens)]
    done = {r.req_id: r.output for r in cb.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(ca, cm)
    peak = torch.cuda.max_memory_allocated()
    stats = cb.stats()
    check(sorted(done) == sorted(ids), f"{name}: {len(done)} of {len(ids)} requests finished")
    for i, n in zip(ids, new_tokens):
        out = done[i]
        check(len(out) == n, f"{name}: request {i} returned {len(out)} tokens, asked for {n}")
        check(all(0 <= t < cfg.vocab_size for t in out), f"{name}: request {i}: a token outside the vocabulary")
    if cb.paged:
        check(bool((cb.page_rc == 0).all()), f"{name}: nonzero page refcounts after the run")
        n_back = len(cb.free_blocks) + len(cb.cached_pages)
        check(n_back == cb.num_blocks - 1, f"{name}: {n_back} pages back of {cb.num_blocks - 1}")
    expected = serving_expected(cfg, opts, stats, prompts, launches)
    check(launches == expected, f"{name}: launches {launches} != expected {expected}")
    if name == "serve-paged":
        check(stats["prefix_hits"] >= 1, f"{name}: no prefix-cache hit")
    keys = ("tokens_per_s", "p50_ttft_s", "p90_ttft_s", "p99_ttft_s", "p50_tpot_s", "p90_tpot_s", "p99_tpot_s",
            "decode_steps", "decode_dispatches", "steps_per_dispatch", "prefix_hits", "prefix_tokens_reused")
    emit({"phase": "serving", "config": name, "model": cfg.name, "layers": cfg.num_layers, **opts,
          "requests": len(prompts), "max_batch": SERVE_MAX_BATCH,
        "max_len": SERVE_MAX_LEN, "block_size": SERVE_BLOCK, "prompt_tokens": sum(len(p) for p in prompts),
        "new_tokens": sum(new_tokens), **{k: stats[k] for k in keys if k in stats}, "wall_s": wall,
        "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9, "launches": launches})
    return launches, cb


def serve_http(cb) -> None:
    """The port's HTTP front end over a full-depth paged batcher: 8 concurrent
    /generate requests, each output's length, /stats' request count, /health.
    The engine thread owns every CUDA call; everything stops at the end."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from lia_tpu_torch.serve import ServingFrontend, make_handler

    before = len(cb.done)
    frontend = ServingFrontend(cb)
    frontend.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(frontend))
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, None if body is None else json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        out = (r.status, json.loads(r.read()))
        conn.close()
        return out

    rng = np.random.default_rng(5)
    reqs = [(rng.integers(2, 50000, int(rng.integers(8, 200))).tolist(), int(rng.integers(4, 33))) for _ in range(8)]
    results = {}
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i, p=p, n=n: results.__setitem__(
            i, call("POST", "/generate", {"prompt_ids": p, "max_new_tokens": n}))) for i, (p, n) in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        health = call("GET", "/health")
        stats = call("GET", "/stats")
    finally:
        srv.shutdown()
        srv.server_close()
        frontend.stop()
    check(sorted(results) == list(range(8)), f"serve_http: {len(results)} of 8 requests answered")
    for i, (p, n) in enumerate(reqs):
        status, out = results[i]
        check(status == 200 and len(out["output_ids"]) == n, f"serve_http: request {i}: {status} {out}")
    check(health == (200, {"status": "ok"}), f"serve_http: /health answered {health}")
    check(stats[0] == 200 and stats[1]["requests"] == before + 8, f"serve_http: /stats answered {stats}")
    emit({"phase": "serve_http", "requests": 8, "wall_s": wall, "stats_requests": stats[1]["requests"],
          "ttft_s": [results[i][1]["ttft_s"] for i in range(8)],
          "latency_s": [results[i][1]["latency_s"] for i in range(8)]})


def serving_phase(ca, cm, cfg):
    """Every SERVING configuration over one bf16 tree (fused once), after a
    warm-up of a few requests; then the HTTP front end over serve-paged's
    batcher. Returns the launches by configuration."""
    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    params = fuse_projections(cfg, device_dummy_params(cfg, seed=0))
    prompts, new_tokens = serving_workload(cfg.vocab_size)
    for opts in (dict(paged=True), dict()):  # warm-up: kernels, cuBLAS handles, the allocator
        warm = ContinuousBatcher(cfg, params, max_batch=4, max_len=SERVE_MAX_LEN, block_size=SERVE_BLOCK,
                                 gen=GenerationConfig(max_new_tokens=8), **opts)
        for p in prompts[:4]:
            warm.submit(p)
        warm.run()
        del warm
    launches = {}
    for name, opts in SERVING:
        launches[name], cb = serving_path(ca, cm, name, opts, cfg, params, prompts, new_tokens)
        if name == "serve-paged":
            serve_http(cb)
        del cb
    del params
    torch.cuda.empty_cache()
    return launches


def serving_parity() -> None:
    """OPT-6.7B width at 2 layers, the functions the batcher calls in its order,
    on the card (bf16, kernels) against the CPU (fp32, plain versions) over the
    same tree: a prompt's prefill into a one-row cache, its commit to pages,
    a second prompt sharing its first 64 tokens admitted from the prefix
    cache (seed_prefix_cache + prefill_chunk + commit), then 4 paged decode
    steps of both; and both prompts through insert_slot into a slab, then 4
    ragged decode steps, over bf16 and over int8 KV. Logits within PARITY_TOL."""
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops import paged as pg
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device
    from lia_tpu_torch.engine.engine import bucket_length, pack_prompts

    cfg = get_config("opt-6.7b").replace(num_layers=2)
    cfg32 = cfg.replace(dtype="float32")
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=1))
    params32 = to_device(params, "cpu", torch.float32)
    rng = np.random.default_rng(6)
    a = rng.integers(2, cfg.vocab_size, 100).tolist()
    b = a[:64] + rng.integers(2, cfg.vocab_size, 37).tolist()
    steps = rng.integers(2, cfg.vocab_size, (4, 2)).astype(np.int32)
    bs, P, S_max = SERVE_BLOCK, 16, 256
    row_a = np.zeros(P, np.int32)
    row_a[:8] = [9, 3, 14, 1, 7, 22, 5, 11]  # shuffled pages; 100 + 4 tokens need 7
    row_b = np.zeros(P, np.int32)
    row_b[:8] = list(row_a[:4]) + [2, 17, 8, 30]  # shares a's first 4 pages (64 tokens)
    seed_row = np.zeros(P, np.int32)
    seed_row[:4] = row_a[:4]  # the pages the prefix-cache seed reads

    def paged(device, c, p, dtype):
        dev = torch.device(device)
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        with torch.inference_mode():
            kp = torch.zeros(c.num_layers, 32, c.num_kv_heads, bs, c.head_dim, dtype=dtype, device=dev)
            vp = torch.zeros_like(kp)
            toks, mask = pack_prompts([a], 1, bucket=bucket_length(len(a)))
            seg = kvc.init_cache(c, 1, toks.shape[1], dtype, device=dev)
            la, seg = T.prefill(c, p, t(toks), t(mask), seg)
            pad = toks.shape[1] - len(a)
            pg.write_prompt_all_layers(kp, vp, seg.k[:, 0, :, pad:], seg.v[:, 0, :, pad:], t(row_a), len(a))
            seed = pg.seed_prefix_cache(kp, vp, t(seed_row), 64, bucket_length(len(b)))
            lb, seed = T.prefill_chunk(c, p, t([b[64:]]), torch.ones(1, len(b) - 64, dtype=torch.bool, device=dev),
                                       seed)
            pg.write_prompt_all_layers(kp, vp, seed.k[:, 0], seed.v[:, 0], t(row_b), len(b), 64)
            out = [la.float().cpu(), lb.float().cpu()]
            table, lengths = t(np.stack([row_a, row_b])), np.asarray([len(a), len(b)], np.int32)
            for st in steps:
                logits, _, _ = pg.decode_step_paged(c, p, t(st[:, None]), t(lengths), kp, vp, table, t(lengths),
                                                    torch.ones(2, dtype=torch.bool, device=dev))
                out.append(logits.float().cpu())
                lengths = lengths + 1
            return out

    def slab(device, c, p, dtype, quantized):
        dev = torch.device(device)
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        with torch.inference_mode():
            cache = kvc.init_cache(c, 2, S_max, dtype, quantized=quantized, device=dev)
            cache = cache._replace(length=torch.zeros(2, dtype=torch.int32, device=dev))
            out = []
            for slot, prompt in enumerate((a, b)):
                toks, mask = pack_prompts([prompt], 1)
                seg = kvc.init_cache(c, 1, S_max, dtype, quantized=quantized, device=dev)
                logits, seg = T.prefill(c, p, t(toks), t(mask), seg)
                kvc.insert_slot(cache, seg, slot)
                out.append(logits.float().cpu())
            pos = np.asarray([len(a), len(b)], np.int32)
            for st in steps:
                logits, cache = T.decode_step_ragged(c, p, t(st[:, None]), t(pos), cache,
                                                     torch.ones(2, dtype=torch.bool, device=dev))
                out.append(logits.float().cpu())
                pos = pos + 1
            return out

    runs = [("paged + prefix cache", lambda d, c, p, dt: paged(d, c, p, dt)),
            ("slab, bf16 KV", lambda d, c, p, dt: slab(d, c, p, dt, False)),
            ("slab, int8 KV", lambda d, c, p, dt: slab(d, c, p, dt, True))]
    for label, fn in runs:
        gpu = fn("cuda", cfg, params, torch.bfloat16)
        cpu = fn("cpu", cfg32, params32, torch.float32)
        errs = [(g - c_).abs().max().item() for g, c_ in zip(gpu, cpu)]
        err = max(errs)
        emit({"phase": "serving_parity", "config": label, "layers": 2, "prompts": [len(a), len(b)],
              "shared_prefix": 64, "decode_steps": len(steps), "max_abs_err": err, "max_abs_err_by_call": errs,
              "max_abs_logit": max(c_.abs().max().item() for c_ in cpu), "tol": PARITY_TOL,
              "argmax_agree": float(np.mean([bool((g.argmax(-1) == c_.argmax(-1)).all()) for g, c_ in zip(gpu, cpu)]))})
        check(all(bool(torch.isfinite(g).all()) for g in gpu), f"serving_parity {label}: non-finite logits")
        check(err <= PARITY_TOL, f"serving_parity {label}: max abs logit err {err} > {PARITY_TOL}")
    del params, params32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: beam search and scoring
# ---------------------------------------------------------------------------


def beam_state_bytes(cfg, kv: str, rows: int, slots: int, layers: int) -> int:
    """Bytes of the K and V planes (int8: codes and f32 scales) of ``layers``
    layers at ``rows`` rows and ``slots`` slots: what a beam shuffle rewrites."""
    per_slot = cfg.head_dim * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
    return 2 * layers * rows * cfg.num_kv_heads * slots * per_slot


# (name, KV, grouped, processors, timed, tiering (hbm_percentage, policies) or None)
BEAM = [
    ("beam-nb4", "none", True, False, True, None),
    ("beam-nb4-int8kv", "int8", True, False, True, None),
    ("beam-nb4-expanded", "none", False, False, False, None),
    ("beam-nb4-proc", "none", True, True, False, None),
    ("tier-h50-p3-beam", "none", True, False, False, (50, (3, 3))),
    ("tier-h50-p0-beam", "none", False, False, False, (50, (0, 0))),
]


def beam_expected(cfg, kv: str, grouped: bool, n_res: int, names) -> dict:
    """Kernel launches of one generate_beam, from the engine's code: the prompt
    runs flash prefill once per layer (at B0 rows grouped, B0·nb expanded);
    every decode step runs the beam kernel per layer (grouped, resident or
    streamed), or, expanded, the fresh-merge kernel per resident layer (of
    ``n_res``) and decode_attention per streamed layer on the card (policy 0)."""
    L, steps = cfg.num_layers, NEW_TOKENS - 1
    out = {name: 0 for name in names}
    out["flash_attention_prefill"] = L
    if grouped:
        out["decode_beam_attention_int8" if kv == "int8" else "decode_beam_attention"] = L * steps
        return out
    out["decode_attention_fresh_int8" if kv == "int8" else "decode_attention_fresh"] = n_res * steps
    out["decode_attention"] = (L - n_res) * steps
    return out


def beam_path(ca, cm, name: str, cfg, engine, prompts, kv: str, grouped: bool, proc: bool, timed: bool, tiering):
    """One beam configuration through ``InferenceEngine.generate_beam``: counters
    zeroed just before one run and read just after it, checked exactly; the
    sequences' shape and vocabulary; with ``timed``, a warm-up and BEAM_RUNS
    runs (median and all) of prefill ms and decode row-tokens/s (B0·nb rows ×
    31 steps over the decode seconds, comparable with the b16 greedy cells).
    Returns (launches, median wall seconds of a run)."""
    from lia_tpu_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, num_beams=BEAM_NB, eos_token_id=None,
                           **(dict(repetition_penalty=1.2, no_repeat_ngram_size=3) if proc else {}))
    rows = len(prompts) * BEAM_NB
    if timed:
        engine.generate_beam(prompts, gen, grouped=grouped)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ca, cm)
    t0 = time.perf_counter()
    res = engine.generate_beam(prompts, gen, grouped=grouped)
    wall = [time.perf_counter() - t0]
    launches = launch_counts(ca, cm)
    peak = torch.cuda.max_memory_allocated()
    n_res = cfg.num_layers if engine.scheduler is None else engine.scheduler.wm.n_resident
    expected = beam_expected(cfg, kv, grouped, n_res, launches)
    check(launches == expected, f"{name}: launches {launches} != expected {expected}")
    seqs = res.sequences
    check(seqs.shape == (len(prompts), NEW_TOKENS), f"{name}: sequences shape {seqs.shape}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), f"{name}: token outside the vocabulary")
    runs = [res.summary(rows)]
    if timed:
        for _ in range(BEAM_RUNS - 1):
            t0 = time.perf_counter()
            runs.append(engine.generate_beam(prompts, gen, grouped=grouped).summary(rows))
            wall.append(time.perf_counter() - t0)
    if grouped:  # the tails of every layer: [L, rows, N_kv, T_max, D]
        t_max = -(-NEW_TOKENS // (128 if kv == "int8" else 32)) * (128 if kv == "int8" else 32)
        reorder = beam_state_bytes(cfg, kv, rows, t_max, cfg.num_layers)
    else:  # the whole cache, both segments (a host cache under policy 0)
        bucket = 128 if kv == "int8" else 64
        reorder = beam_state_bytes(cfg, kv, rows, -(-(max(map(len, prompts)) + NEW_TOKENS) // bucket) * bucket,
                                   cfg.num_layers)
    med = {}
    for key, out_key, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                                ("decode_tokens_per_s", "decode_row_tokens_per_s", 1.0)):
        vals = [r[key] * scale for r in runs]
        med[out_key], med[out_key + "_runs"] = statistics.median(vals), vals
    emit({"phase": "beam", "config": name, "model": cfg.name, "layers": cfg.num_layers, "kv": kv,
          "grouped": grouped, "processors": proc, "tiering": tiering, "groups": len(prompts), "num_beams": BEAM_NB,
          "prompts": [len(p) for p in prompts], "new_tokens": NEW_TOKENS, **med,
          "wall_s": statistics.median(wall), "reorder_bytes_per_step": reorder, "peak_mem_gb": peak / 1e9,
          "launches": launches})
    return launches, statistics.median(wall)


def score_path(ca, cm, name: str, cfg, engine, contexts, continuations):
    """``loglikelihood`` of the records (a counted call, then a timed one):
    finite, non-positive sums, one flash prefill per layer. Returns the sums."""
    reset_counts(ca, cm)
    ll = engine.loglikelihood(contexts, continuations)
    launches = launch_counts(ca, cm)
    expected = {n: 0 for n in launches}
    expected["flash_attention_prefill"] = cfg.num_layers
    check(launches == expected, f"{name}: launches {launches} != expected {expected}")
    check(ll.shape == (len(contexts),) and bool(np.isfinite(ll).all() and (ll <= 0).all()), f"{name}: sums {ll}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.loglikelihood(contexts, continuations)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "score", "config": name, "records": len(contexts), "context": len(contexts[0]),
          "continuation": len(continuations[0]), "ms_per_call": ms, "loglikelihood": ll.tolist(),
          "launches": launches})
    return ll


def beam_phase(ca, cm, cfg, prompts, tree):
    """Every BEAM configuration at OPT-6.7B full width and depth (one fused bf16
    tree on the card for the resident ones, the pageable host tree for the
    tiered ones), then scoring, resident and tier-h50-p3. Returns (launches by
    configuration, the median wall of beam-nb4, its prompts)."""
    from lia_tpu_torch.config import QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    bprompts = [p[:n] for p, n in zip(prompts, BEAM_PROMPT_LENS)]
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=0))
    launches, walls = {}, {}
    for name, kv, grouped, proc, timed, tiering in BEAM:
        if tiering is None:
            engine = InferenceEngine(cfg, params, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
        else:
            engine = InferenceEngine(cfg, tree, tiered_runtime(kv, tiering[0], tiering[1], 1))
            check((engine.scheduler.grouped_beam_ok) == grouped, f"{name}: grouped_beam_ok is not {grouped}")
        launches[name], walls[name] = beam_path(ca, cm, name, cfg, engine, bprompts, kv, grouped, proc, timed, tiering)
        del engine
        torch.cuda.empty_cache()

    rng = np.random.default_rng(7)
    contexts = [p[:PROMPT] for p in prompts]
    conts = rng.integers(2, cfg.vocab_size, (len(prompts), SCORE_CONT)).tolist()
    resident = InferenceEngine(cfg, params, RuntimeConfig())
    ll = score_path(ca, cm, "score", cfg, resident, contexts, conts)
    del resident, params
    torch.cuda.empty_cache()
    tiered = InferenceEngine(cfg, tree, tiered_runtime("none", 50, (3, 3), 1))
    ll_t = score_path(ca, cm, "score-tier-h50-p3", cfg, tiered, contexts, conts)
    del tiered
    torch.cuda.empty_cache()
    diff = float(np.abs(ll - ll_t).max())
    emit({"phase": "score_vs_tiered", "max_abs_diff": diff, "max_abs_ll": float(np.abs(ll).max())})
    check(diff <= 1e-3 * float(np.abs(ll).max()), f"score: resident and tiered sums differ by {diff}")
    return launches, walls["beam-nb4"], bprompts


def beam_parity() -> None:
    """OPT-6.7B width at 2 layers, one tree on both sides: a grouped beam cache
    of 2 prompts × 4 beams, the prompt and 4 beam_decode_step calls on the card
    (bf16, kernels) against the CPU (fp32, plain versions), every step's
    tokens and tail shuffle (flat_src) the CPU run's, over bf16 and int8 KV;
    then score_logprobs at the prompt's valid positions. Within PARITY_TOL."""
    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine import beam as beam_mod
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config("opt-6.7b").replace(num_layers=2)
    cfg32 = cfg.replace(dtype="float32")
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=1))
    params32 = to_device(params, "cpu", torch.float32)
    rng = np.random.default_rng(8)
    tokens = rng.integers(2, cfg.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), bool)
    mask[1, :14] = False
    tokens[1, :14] = 1
    nb, n_steps = 4, 4
    gen = GenerationConfig(num_beams=nb)

    def run(device, c, p, dtype, kv, forced=None):
        """Logits of the prompt and of each step, score_logprobs, and the steps'
        (fed tokens, flat_src); ``forced`` replaces this run's own."""
        with torch.inference_mode():
            t = lambda x: torch.from_numpy(np.asarray(x)).to(device)  # noqa: E731
            cache = kvc.init_cache(c, 2, 128, dtype, quantized=kv == "int8", device=device)
            logits, cache = T.prefill(c, p, t(tokens), t(mask), cache)
            cache = kvc.beam_cache_from_prefill(cache, nb, 8)
            out = [logits.float().cpu()]
            scores, finished = beam_mod.init_beam_state(2, nb, device)
            tok, scores, finished, _ = beam_mod.beam_select(gen, c.vocab_size, logits.repeat_interleave(nb, 0),
                                                            scores, finished)
            pos = t(np.repeat(mask.sum(1), nb).astype(np.int32))[:, None]
            feeds, srcs = [], []
            for i in range(n_steps):
                if forced is not None:
                    tok = t(forced[0][i])
                feeds.append(tok.cpu().numpy())
                logits, cache = T.beam_decode_step(c, p, tok[:, None], pos + i, cache)
                out.append(logits.float().cpu())
                tok, scores, finished, src = beam_mod.beam_select(gen, c.vocab_size, logits, scores, finished)
                if forced is not None:
                    src = t(forced[1][i])
                srcs.append(src.cpu().numpy())
                cache = kvc.beam_tail_reorder(cache, src)
            lp = T.score_logprobs(c, p, t(tokens), t(mask), kvc.init_cache(c, 2, 64, dtype, device=device))
            return torch.cat(out), lp.float().cpu(), (feeds, srcs)

    for kv in ("none", "int8"):
        cpu, lp_cpu, picks = run("cpu", cfg32, params32, torch.float32, kv)
        gpu, lp_gpu, _ = run("cuda", cfg, params, torch.bfloat16, kv, forced=picks)
        err = (gpu - cpu).abs().max().item()
        valid = torch.from_numpy(mask)[:, :, None]
        lp_err = ((lp_gpu - lp_cpu).abs() * valid).max().item()
        emit({"phase": "beam_parity", "kv": kv, "layers": 2, "groups": 2, "num_beams": nb, "prompt": 64,
              "decode_steps": n_steps, "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
              "score_logprobs_max_abs_err": lp_err, "tol": PARITY_TOL,
              "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
        check(bool(torch.isfinite(gpu).all()), f"beam_parity {kv}: non-finite logits on the card")
        check(err <= PARITY_TOL, f"beam_parity {kv}: max abs logit err {err} > {PARITY_TOL}")
        check(lp_err <= PARITY_TOL, f"beam_parity {kv}: score_logprobs max abs err {lp_err} > {PARITY_TOL}")
    del params, params32
    torch.cuda.empty_cache()


def beam_breakdown(ca, cfg, prompts, wall_s: float) -> None:
    """Device time by kernel over one more beam-nb4 run under the profiler (the
    weights made anew), and the idle share against the median wall time of
    the unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    engine = InferenceEngine(cfg, device_dummy_params(cfg, seed=0))
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, num_beams=BEAM_NB)
    engine.generate_beam(prompts, gen)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate_beam(prompts, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "device_breakdown", "config": "beam-nb4", "kv": "none", "device_busy_s": busy_s,
          "wall_s": wall_s, "idle_share": 1 - busy_s / wall_s,
          "top_kernels": [{"kernel": _short(e.key), "count": e.count, "ms": e.self_device_time_total / 1e3}
                          for e in top]})
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: parity
# ---------------------------------------------------------------------------


def parity(label: str, kv: str, quant=None, model: str = "opt-6.7b", fuse: bool = True, gate=None,
           stacked_per_layer: int = 0):
    """``model``'s width (OPT-6.7B by default) at 2 layers, one tree on both
    sides: the card (bf16 model, kernels) against the CPU (fp32 model, plain
    versions; quantized records move as they are), projections fused unless
    ``fuse`` is off, the routes of ``gate`` on for both runs (with the fused
    MLP on, the card runs it at every layer of the prefill's 2 x 64 rows and
    of each step; with the stacked W4A8 route on, ``stacked_per_layer`` linears
    of each layer run the stacked entry at each decode step)."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops import cuda_mlp
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config(model).replace(num_layers=2)
    qc = None if quant is None else QuantConfig(**quant)
    params = device_dummy_params(cfg, seed=1, quant=qc)
    if fuse:
        params = fuse_projections(cfg, params)
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

    with gates(**(gate or {})):
        fused, stacked = cuda_mlp.fused_mlp.launches, cm.w4a8_matmul_stacked.launches
        gpu = run("cuda", cfg, params, torch.bfloat16)
        fused, stacked = cuda_mlp.fused_mlp.launches - fused, cm.w4a8_matmul_stacked.launches - stacked
        cpu = run("cpu", cfg32, params32, torch.float32)
    check(fused == (cfg.num_layers * (1 + len(steps)) if (gate or {}).get("fused_mlp") else 0),
          f"parity {label}: {fused} fused-MLP launches")
    check(stacked == stacked_per_layer * cfg.num_layers * len(steps), f"parity {label}: {stacked} stacked launches")
    err = (gpu - cpu).abs().max().item()
    tol = PARITY_TOL_INT8_ACT if (quant or {}).get("act_quant") == "dynamic" else PARITY_TOL
    emit({"phase": "parity", "config": label, "model": model, "kv": kv, "layers": 2, "batch": 2, "prompt": 64,
          "gates": gate or {}, "fused_mlp_launches": fused, "w4a8_matmul_stacked_launches": stacked,
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
    phase_time("kernel checks")

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
    # the two gate A/Bs: bf16 with the fused MLP at every decode step (prefill's
    # 4096 rows stay unfused), w4a8 with the decode steps' linears through the
    # stacked entry (prefill and the head stay on w4a8_matmul)
    steps = NEW_TOKENS - 1
    gate_ab = {"bf16 weights, none KV": ("fused_mlp", {"fused_mlp": L * steps}),
               "w4a8+int8kv": ("stacked_w4a8", {"w4a8_matmul": per_fwd + steps, "w4a8_matmul_stacked": 4 * L * steps})}
    runs = {}
    for label, make, kv, calls in timed:  # with its gated route on, in turn, where it has one
        runs.update(main_path(ca, cm, label, cfg, make, prompts, kv, calls, timed=True, ab=gate_ab.get(label)))
    for label, qkw in WEIGHT_ONLY.items():
        runs.update(main_path(
            ca, cm, label, cfg, lambda qc=QuantConfig(**qkw): device_dummy_params(cfg, seed=0, quant=qc),
            prompts, "none", {"woq_matmul": per_fwd}, timed=False))
    cfg2 = cfg.replace(num_layers=2)  # GPTQ: no head record (OPT ties it), 4 linears per layer
    gptq = gptq_params(cfg2, seed=0)
    runs.update(main_path(ca, cm, "gptq woq_int4z", cfg2, lambda: gptq, prompts, "none",
                          {"woq4z_matmul": 4 * cfg2.num_layers}, timed=False))
    runs.update(main_path(ca, cm, "gptq woq_int4z_dyn", cfg2, lambda: retag_dynamic_act(gptq), prompts, "none",
                          {"w4a8_matmul": 4 * cfg2.num_layers}, timed=False))
    del gptq
    launches = {name: counts for name, (counts, _) in runs.items()}
    walls = {name: wall for name, (_, wall) in runs.items()}
    launches.update(llama_phase(ca, cm))

    parity("bf16 weights, none KV", "none")
    parity("bf16 weights, int8 KV", "int8")
    for label, (qkw, _) in CANDIDATES.items():
        parity(label, qkw["kv_cache_dtype"], qkw)
    w4a8 = CANDIDATES["w4a8+int8kv"][0]  # the stacked route: wqkv, wo, fc1, fc2 of each layer per step
    parity("w4a8+int8kv, stacked gate", w4a8["kv_cache_dtype"], w4a8, gate=dict(stacked_w4a8=True),
           stacked_per_layer=4)
    parity("woq-int4-g128", "none", WEIGHT_ONLY["woq-int4-g128"])
    for kv in ("none", "int8"):  # both gated routes on, projections unfused
        parity(f"llama-3-8b, {kv} KV, both gates", kv, model="llama-3-8b", fuse=False,
               gate=dict(stacked_w4a8=True, fused_mlp=True))
    phase_time("main path and parity")

    tier_launches, tree = tiered_phase(ca, cm, cfg, prompts)
    launches.update(tier_launches)
    tiered_parity()
    phase_time("tiered")

    launches.update(serving_phase(ca, cm, cfg))
    serving_parity()
    phase_time("serving")

    beam_launches, beam_wall, beam_prompts = beam_phase(ca, cm, cfg, prompts, tree)
    launches.update(beam_launches)
    beam_parity()
    phase_time("beam and score")

    # every profiler session comes after the timed runs
    for label, make, kv, _ in timed:
        device_breakdown(label, cfg, make, prompts, kv, walls[label])
    llama = get_config("llama-3-8b")
    device_breakdown(LLAMA_CELL, llama, lambda: device_dummy_params(llama, seed=0), llama_prompts(llama), "none",
                     LLAMA_WALL[LLAMA_CELL])
    from lia_tpu_torch.engine.engine import InferenceEngine

    for name, kv, hbm, policies, nm, inflight, _ in TIERED:
        if name in ("tier-h50-p3", "tier-h50-p0-p2-mb4"):
            engine = InferenceEngine(cfg, tree, tiered_runtime(kv, hbm, policies, nm, inflight))
            tiered_breakdown(name, engine, prompts)
            del engine
    del tree
    beam_breakdown(ca, cfg, beam_prompts, beam_wall)
    phase_time("device breakdowns")
    kernel_times(rows)
    matmul_kernel_times(cm, quantize_act, mm_rows)
    int_mm_layout()
    phase_time("kernel times")

    from_run = {"flash_attention_prefill": "bf16 weights, none KV",
                "decode_attention_fresh": "bf16 weights, none KV",
                "decode_attention_fresh_int8": "bf16 weights, int8 KV",
                "w4a8_matmul": "w4a8+int8kv", "woq_matmul": "woq-int4-g128",
                "w4a8_matmul_stacked": "w4a8+int8kv, stacked_w4a8",
                "fused_mlp": "llama-3-8b, unfused projections, bf16 KV, fused_mlp",
                "woq4z_matmul": "gptq woq_int4z", "decode_attention": "tier-h50-p3",
                "decode_attention_stacked": "tier-h50-p3",  # no reference path runs the stacked entry
                "paged_decode_attention": "serve-paged", "flash_attention_cached": "serve-paged-chunk256",
                "decode_beam_attention": "beam-nb4", "decode_beam_attention_int8": "beam-nb4-int8kv"}
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
