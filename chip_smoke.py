"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per item:

1. device: the card's name and power limit (nvidia-smi) and torch's view of it;
2. build: every CUDA kernel of lia_tpu_torch/csrc, built with nvcc in parallel;
3. kernel checks: each kernel against its plain PyTorch version on the card at
   the main path's shapes (OPT-6.7B: B=16, N=N_kv=32, D=128; prefill S=256 with
   left pads; decode past length 272 in a 320-slot bf16 / 384-slot int8 cache);
4. main path: InferenceEngine for opt-6.7b at full width and depth with random
   bf16 weights, 16 prompts x 256 tokens, 32 new tokens, generate(fused=True),
   once with bf16 KV and once with int8 KV; the launch counters, zeroed just
   before one run and read just after it, must show 32 prefill launches and
   32 x 31 decode launches of the KV type's kernel; prefill ms and decode
   tokens/s are the median of 5 runs;
5. parity: OPT-6.7B width at 2 layers, prefill + 4 decode steps on the card
   (bf16, kernels) against the CPU (fp32, plain versions), both KV types;
6. device breakdown: one more main-path run per KV type under the profiler,
   device time by kernel and the device's idle share;
7. kernel times: each kernel's, its plain version's and a PyTorch library
   call's device time (profiler trace, mean of 30 calls, L2 flushed before
   each) and the wrapper's host time, beside the least time the card could
   take for the same bytes or FLOPs. Profiling comes last because a profiler
   session slows the process's later launches.

Then the kernels line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; without a CUDA device it exits 2 at once.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
REPS = 30
TIMED_RUNS = 5  # main-path generate calls per KV type

B, N, D = 16, 32, 128  # OPT-6.7B heads at batch 16
PROMPT = 256
PAST = 272  # decode checks: past length inside 256..287
PADS = [0, 3, 7, 15, 31, 64, 100, 200] + [0] * 8  # left pads per row
KERNEL_TOL = 2e-2  # bf16 outputs of O(1): a few ulps; kernel and plain version
# differ in summation order and in where the probabilities round
PARITY_TOL = 5e-2  # logits, bf16 model on the card vs fp32 on the CPU


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


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` (Python, checks and launch), GPU work queued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOP_PER_S * 1e3
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


def kernel_times(rows) -> None:
    """Device times of each kernel, its plain version and the library call, and
    the wrapper's host time. Runs last: a profiler session leaves the process's
    launches slower (measured on the card: eager decode loses ~40% after one)."""
    for name, r in rows.items():
        r["ms"] = device_ms(r["kernel"])
        r["host_us"] = host_us(r["kernel"])
        r["plain_ms"] = device_ms(r["plain"])
        r["library_ms"] = device_ms(r["library"]) if r["library"] else None
        emit({"phase": "kernel_time", "kernel": name, "ms": r["ms"], "host_us": r["host_us"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})


# ---------------------------------------------------------------------------
# phase 4: main path
# ---------------------------------------------------------------------------


def main_path(ca, kv: str, cfg, params, prompts):
    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.ops import kv_cache as kvc

    engine = InferenceEngine(cfg, params, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
    gen = GenerationConfig(max_new_tokens=32)
    engine.generate(prompts, gen, fused=True)  # warm-up (cuBLAS handles, kernel loads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    res = engine.generate(prompts, gen, fused=True)
    launches = ca.launch_counts()
    L, steps = cfg.num_layers, gen.max_new_tokens - 1
    decode_kernel = "decode_attention_fresh_int8" if kv == "int8" else "decode_attention_fresh"
    expected = {name: 0 for name in launches}
    expected["flash_attention_prefill"] = L
    expected[decode_kernel] = L * steps
    check(launches == expected, f"{kv} KV: launches {launches} != expected {expected}")
    seqs = res.sequences
    check(seqs.shape == (len(prompts), gen.max_new_tokens), f"sequences shape {seqs.shape}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), "token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    # the eager loop is bound by host time, and the host's cores are shared:
    # report the median of TIMED_RUNS runs (the counted one first) and all of them
    runs = [res.summary()] + [engine.generate(prompts, gen, fused=True).summary()
                              for _ in range(TIMED_RUNS - 1)]

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
        check(logits.shape == (len(prompts), cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all()), "non-finite logits")

    def med(key, scale=1.0):
        return statistics.median(r[key] * scale for r in runs), [r[key] * scale for r in runs]

    record = {
        "phase": "main_path", "model": cfg.name, "layers": L, "kv": kv, "batch": len(prompts),
        "prompt": len(prompts[0]), "new_tokens": gen.max_new_tokens, "launches": launches,
        "peak_mem_gb": peak / 1e9,
    }
    for key, name, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                             ("decode_tokens_per_s", "decode_tokens_per_s", 1.0),
                             ("total_latency_s", "total_s", 1.0)):
        record[name], record[name + "_runs"] = med(key, scale)
    emit(record)
    return launches, engine, gen, record["total_s"]


def _short(kernel: str) -> str:
    """A kernel's name without return type, namespaces, template and parameters."""
    name = kernel.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1][:60]


def device_breakdown(engine, gen, prompts, kv: str, wall_s: float) -> None:
    """Device time by kernel over one more main-path run under the profiler, and
    the idle share against the median wall time of the unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, gen, fused=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit({
        "phase": "device_breakdown", "kv": kv, "device_busy_s": busy_s, "wall_s": wall_s,
        "idle_share": 1 - busy_s / wall_s,
        "top_kernels": [{"kernel": _short(e.key),
                         "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top],
    })


# ---------------------------------------------------------------------------
# phase 5: parity
# ---------------------------------------------------------------------------


def parity(kv: str):
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config("opt-6.7b").replace(num_layers=2)
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=1))
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
    emit({"phase": "parity", "kv": kv, "layers": 2, "batch": 2, "prompt": 64, "decode_steps": 4,
          "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(), "tol": PARITY_TOL,
          "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
    check(bool(torch.isfinite(gpu).all()), f"parity {kv}: non-finite logits on the card")
    check(err <= PARITY_TOL, f"parity {kv}: max abs logit err {err} > {PARITY_TOL}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import _build
    from lia_tpu_torch.ops import cuda_attention as ca
    from lia_tpu_torch.ops.quant import quantize_kv
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

    cfg = get_config("opt-6.7b")
    params = device_dummy_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (16, PROMPT)).tolist()
    paths = {kv: main_path(ca, kv, cfg, params, prompts) for kv in ("none", "int8")}
    launches = {kv: p[0] for kv, p in paths.items()}
    del params

    parity("none")
    parity("int8")

    # every profiler session comes after the timed runs
    for kv, (_, engine, gen, wall_s) in paths.items():
        device_breakdown(engine, gen, prompts, kv, wall_s)
    del paths, engine
    torch.cuda.empty_cache()
    kernel_times(rows)

    from_run = {"flash_attention_prefill": "none", "decode_attention_fresh": "none",
                "decode_attention_fresh_int8": "int8"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[from_run[name]][name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for name, r in rows.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
