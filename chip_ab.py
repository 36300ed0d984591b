"""A/B of two checkouts of the port on one card, in turns within one call.

Runs this checkout's ``chip_smoke.py`` phases over the ``lia_tpu_torch`` of
another checkout (``--root``), so two trees (a parent and a change) run the
same measurement code. ``--kernels`` picks the device times (profiler, L2
cold) taken first: ``matmul``, the quantized-matmul entry points
(``w4a8_matmul``, ``w4a8_matmul_stacked``, ``woq_matmul`` int4 g128,
``woq4z_matmul``) at OPT-6.7B's wqkv, fc2 and head with 16 and 4096 rows;
``flash``, B1 (b16 s256) and B6 (a 256-row chunk at base 768); ``decode``,
B2 (``decode_attention_fresh``), B7/B8 (``decode_attention`` and its stacked
entry) at chip_smoke's table shapes, and B2 and B7 at OPT-2.7B's,
GPT-NeoX-20B's, GPT-J-6B's and Llama-3-8B's heads, at G = 2 and at D = 256,
G = 4, and B9 (``decode_beam_attention``) at 4 x 4 beams over a 256- and a
1024-slot prompt, at Llama-3-8B's heads and at those heads with D = 256
over either prompt (64 blocks);
``paged``, B5 (``paged_decode_attention``: b16 over lengths 272 - pad, also
at Llama-3-8B's G = 4 and over rows of ~1000 tokens); ``mlp``, B14
(``fused_mlp``: Llama-3-8B's SwiGLU and OPT-6.7B's relu at 16 rows, and at 1
and 256); ``int8``, B3 (``decode_attention_fresh_int8``: b16 over past 272 -
pad, at Llama-3-8B's G = 4 and over ~1000-token rows) and B10
(``decode_beam_attention_int8``: 4 x 4 beams over a 256- and a 1024-slot
prompt); ``host``, the host µs of B10's and B3's wrappers beside a direct
call of their library functions, with B9's wrapper as the host's control
(``ab_host`` lines). ``--paths`` picks the main paths through ``generate(fused=True)``
at full width and depth, b16 x 256 prompt tokens and 32 new tokens (prefill
ms and decode tokens/s, the median of 3 runs after a warm-up): ``quantized``,
OPT-6.7B with bf16 weights, bench.py's w4a8+int8kv and weight-only int4
g128; ``gates``, OPT-6.7B bf16 and Llama-3-8B with unfused projections, each
with the fused-MLP gate off and on in turns on one engine; ``int8kv``,
OPT-6.7B bf16 weights and Llama-3-8B with int8 KV, then beam-nb4-int8kv
(``generate_beam``, 4 prompts x 4 beams: prefill ms and decode row-tokens/s);
``beam``, beam-nb4 (the same with bf16 KV: B9 at every decode step). Then the serving
cells serve-paged-chunk256 and serve-paged (64 requests through a
ContinuousBatcher, as chip_smoke's serving phase, each ``--serving-repeats``
times in turns; ``--serving-repeats 0`` skips them). Every line chip_smoke prints carries
``"tree": <label>``. Each tree builds its kernels into its own
``lia_tpu_torch/_build`` (a ``build`` line gives the seconds: the libraries'
compile time in the tree's first process). Run the trees in turns (A, B, B, A), one process
each, so that both see the same card and host::

    git archive <parent> | tar -x -C tmp/ab/parent
    for t in parent change change parent; do
        python3 chip_ab.py --root tmp/ab/$t --label $t | tee -a chiprun_out/ab.log
    done
    python3 chip_ab.py --summarize chiprun_out/ab.log

``--summarize`` prints, for each cell and tree, every run's number and their
median. Needs a CUDA device (exits 2 without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

KERNEL_GROUPS = ("matmul", "flash", "decode", "paged", "mlp", "int8", "host")
MAIN_PATHS = ("quantized", "gates", "int8kv", "beam")
SERVING_CELLS = ("serve-paged-chunk256", "serve-paged")


def summarize(log: Path) -> None:
    """Per cell and tree: the runs' prefill ms and decode tok/s (main path) or
    tokens/s and wall s (serving), with their medians."""
    cells = {}
    for line in log.read_text().splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        tree = rec.get("tree")
        if rec.get("phase") in ("main_path", "beam"):
            for key in ("prefill_ms", "decode_tokens_per_s", "decode_row_tokens_per_s"):
                if key + "_runs" in rec:
                    cells.setdefault((rec["config"].split(": ", 1)[1] + " " + key, tree), []).extend(rec[key + "_runs"])
        elif rec.get("phase") == "ab_kernel":
            cells.setdefault((f"{rec['kernel']} {rec['shape']} M={rec['M']} ms", tree), []).append(rec["ms"])
            if "host_us" in rec:
                cells.setdefault((f"{rec['kernel']} {rec['shape']} M={rec['M']} host_us", tree), []).append(
                    rec["host_us"])
        elif rec.get("phase") == "ab_host":
            for key in ("wrapper_us_min", "direct_us_min"):
                cells.setdefault((f"{rec['kernel']} {key}", tree), []).append(rec[key])
        elif rec.get("phase") == "serving":
            for key in ("tokens_per_s", "wall_s", "p50_tpot_s", "p99_tpot_s"):
                cells.setdefault((rec["config"] + " " + key, tree), []).append(rec[key])
            splits = rec.get("split_launches") or rec.get("flash_split_launches")
            if splits:
                for kernel, n in splits.items():
                    cells.setdefault((f"{rec['config']} {kernel} split share", tree), []).append(
                        n / max(rec["launches"][kernel], 1))
    for (cell, tree), vals in sorted(cells.items()):
        print(json.dumps({"cell": cell, "tree": tree, "median": statistics.median(vals), "runs": vals}))


def kernel_times(cs, ca, cm, groups) -> None:
    """Device times (chip_smoke's profiler timing, L2 cold) of the kernel
    groups picked (see the module's docstring)."""
    import torch

    from lia_tpu_torch.ops.quant import quantize_act, quantize_kv

    if "matmul" in groups:
        picked = {("w4a8_matmul", "g128"), ("woq_matmul", "int4 g128"), ("woq4z_matmul", "g128"),
                  ("w4a8_matmul_stacked", "g128")}
        for c in itertools.chain(cs.matmul_cases(cm, quantize_act), cs.stacked_cases(cm, quantize_act)):
            if (c["name"], c["variant"]) in picked:
                cs.emit({"phase": "ab_kernel", "kernel": c["name"], "shape": c["shape"], "M": c["M"],
                         "ms": cs.kernel_trace(c["name"], c["kernel"])[0]})
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def emit(kernel, shape, M, fn):
        ms, _ = cs.kernel_trace(kernel, fn, cs.own_launches(ca, fn))
        cs.emit({"phase": "ab_kernel", "kernel": kernel, "shape": shape, "M": M, "ms": ms, "host_us": cs.host_us(fn)})

    dpads = [0, 3, 7, 15] * 4  # chip_smoke's decode rows: lengths 272 - pad
    if "decode" in groups:
        L, li = 3, 1
        qd, kf, vf = randn(cs.B, 1, cs.N, cs.D), randn(cs.B, cs.N, 1, cs.D), randn(cs.B, cs.N, 1, cs.D)
        sm = torch.zeros(cs.B, 320, dtype=torch.bool, device="cuda")
        for b, p in enumerate(dpads):
            sm[b, p:cs.PAST] = True
        kc, vc = randn(L, cs.B, cs.N, 320, cs.D), randn(L, cs.B, cs.N, 320, cs.D)
        ln = torch.tensor(cs.PAST, dtype=torch.int32, device="cuda")
        emit("decode_attention_fresh", "b16 272-pad", cs.B, lambda: ca.decode_attention_fresh(qd, kf, vf, kc, vc, li, sm, ln))
        sm_inc = sm.clone()
        sm_inc[:, cs.PAST] = True
        ln_inc = ln + 1
        emit("decode_attention", "b16 273-pad", cs.B, lambda: ca.decode_attention(qd, kc[li], vc[li], sm_inc, ln_inc))
        emit("decode_attention_stacked", "b16 273-pad", cs.B,
             lambda: ca.decode_attention_stacked(qd, kc, vc, li, sm_inc, ln_inc))
        # B2 and B7 at the other timed heads: chip_smoke's HEAD_DIM_HEADS and
        # PLANE_HEADS shapes (a 384-slot cache, the same rows)
        for shape, Nq, Nkv, Dh in (("opt-2.7b heads D=80", 32, 32, 80), ("gpt-neox-20b heads D=96", 64, 64, 96),
                                   ("gpt-j-6b heads D=256", 16, 16, 256), ("G=2", 32, 16, 128),
                                   ("llama-3-8b heads G=4", 32, 8, 128), ("D=256 G=4", 16, 4, 256)):
            q2, kf2, vf2 = randn(cs.B, 1, Nq, Dh), randn(cs.B, Nkv, 1, Dh), randn(cs.B, Nkv, 1, Dh)
            sm2 = torch.zeros(cs.B, 384, dtype=torch.bool, device="cuda")
            for b, p in enumerate(dpads):
                sm2[b, p:cs.PAST] = True
            kc2, vc2 = randn(2, cs.B, Nkv, 384, Dh), randn(2, cs.B, Nkv, 384, Dh)
            sm2_inc = sm2.clone()
            sm2_inc[:, cs.PAST] = True
            emit("decode_attention_fresh", f"b16 272-pad, {shape}", cs.B,
                 lambda a=(q2, kf2, vf2, kc2, vc2, 1, sm2, ln): ca.decode_attention_fresh(*a))
            emit("decode_attention", f"b16 273-pad, {shape}", cs.B,
                 lambda a=(q2, kc2[1], vc2[1], sm2_inc, ln_inc): ca.decode_attention(*a))
        # B9 at 128, 32 and (Llama's heads at D = 256: two blocks a group) 64
        # blocks, where beam_plan splits and the plane route (plane_plan) does not
        for shape, kw in (("4 x 4 beams", {}), ("4 x 4 beams, 1024-slot prompt", dict(S_p=1024)),
                          ("llama G4 4 x 4 beams", dict(Nkv=cs.N // 4)),
                          ("llama G4 D256 4 x 4 beams", dict(Nkv=cs.N // 4, Dh=256)),
                          ("llama G4 D256 4 x 4 beams, 1024-slot prompt", dict(Nkv=cs.N // 4, Dh=256, S_p=1024))):
            kernel, _, args = cs.beam_case(ca, quantize_kv, randn, False, **kw)
            emit("decode_beam_attention", shape, cs.B, lambda k=kernel, a=args: k(*a))
    if "paged" in groups:
        for shape, lengths, G in (("b16 272-pad", [cs.PAST - p for p in dpads], 1),
                                  ("llama G4 b16 272-pad", [cs.PAST - p for p in dpads], 4),
                                  ("b16 ~1000", [1000 - p for p in dpads], 1),
                                  ("llama G4 b16 ~1000", [1000 - p for p in dpads], 4)):
            P = -(-(max(lengths) + 1) // cs.SERVE_BLOCK)
            pargs = cs.paged_case(randn, lengths, 1, cs.N // G, G, cs.D, P=P)
            emit("paged_decode_attention", shape, cs.B, lambda a=pargs: ca.paged_decode_attention(a[0], a[1], a[2], 1, *a[3:]))
    if "mlp" in groups:
        from lia_tpu_torch.ops import cuda_mlp

        for label, H, Fd, act, rms, biases in cs.FUSED_MLP_CASES:
            if act not in ("silu", "relu"):
                continue
            for rows in (16, 1, 256):
                w = dict(ln_scale=(1 + 0.1 * randn(H).float()).to(torch.bfloat16),
                         ln_bias=0.1 * randn(H) if biases else None, w1=0.02 * randn(H, Fd),
                         b1=0.1 * randn(Fd) if biases else None, wg=0.02 * randn(H, Fd) if act == "silu" else None,
                         w2=0.02 * randn(Fd, H), b2=0.1 * randn(H) if biases else None)
                x = randn(rows, H)
                emit("fused_mlp", label, rows, lambda x=x, w=w, a=act, n=rms: cuda_mlp.fused_mlp(x, **w, activation=a, rms=n))
    if "int8" in groups:
        for shape, Nkv, past, S in (("b16 272-pad", cs.N, cs.PAST, 384), ("llama G4 b16 272-pad", cs.N // 4, cs.PAST, 384),
                                    ("b16 ~1000", cs.N, 1000, 1024), ("llama G4 b16 ~1000", cs.N // 4, 1000, 1024)):
            a = cs.int8_plane_case(randn, quantize_kv, [(past, p) for p in dpads], Nkv, cs.N // Nkv, S)
            emit("decode_attention_fresh_int8", shape, cs.B, lambda a=a: ca.decode_attention_fresh_int8(*a))
        for shape, S_p in (("4 x 4 beams, 256-slot prompt", 256), ("4 x 4 beams, 1024-slot prompt", 1024)):
            kernel, _, args = cs.beam_case(ca, quantize_kv, randn, True, S_p=S_p)
            emit("decode_beam_attention_int8", shape, cs.B, lambda k=kernel, a=args: k(*a))
    if "host" in groups:
        host_times(cs, ca, randn, quantize_kv, dpads)
    if "flash" not in groups:
        return

    q, k, v = randn(cs.B, cs.PROMPT, cs.N, cs.D), randn(cs.B, cs.N, cs.PROMPT, cs.D), randn(cs.B, cs.N, cs.PROMPT, cs.D)
    mask = torch.ones(cs.B, cs.PROMPT, dtype=torch.bool, device="cuda")
    for b, p in enumerate(cs.PADS):
        mask[b, :p] = False
    emit("flash_attention_prefill", "b16 s256", cs.B * cs.PROMPT, lambda: ca.flash_attention_prefill(q, k, v, mask))
    a6 = cs.cached_case(randn, 1, 256, 768, [0])
    emit("flash_attention_cached", "C256 base 768", 256, lambda: ca.flash_attention_cached(*a6))


def host_times(cs, ca, randn, quantize_kv, dpads) -> None:
    """Host µs of one call (min and median over 15 loops of 200 calls, GPU
    work queued) of B10's and B3's wrappers at the int8 group's first shapes,
    beside a direct call of the library function with the arguments the
    wrapper passed (the C side and the launch), and of B9's wrapper, whose
    code the trees share, as the host's control."""
    import statistics
    import time

    import torch

    from lia_tpu_torch.ops import _build

    def host(fn, n=200, reps=15):
        fn()
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        return min(runs), statistics.median(runs)

    def direct(libname, fname, call):
        """The library function and the arguments one wrapper call gives it."""
        lib, seen = _build.library(libname), {}
        real = getattr(lib, fname)

        class Recorder:
            def __getattr__(self, name):
                if name != fname:
                    return getattr(lib, name)

                def record(*args):
                    seen["args"] = args
                    return real(*args)
                return record

        library = _build.library
        _build.library = lambda name: Recorder() if name == libname else library(name)
        try:
            kept = call()  # its output stays alive while the recorded pointers are used
        finally:
            _build.library = library
        return lambda: real(*seen["args"]), kept

    k9, _, a9 = cs.beam_case(ca, quantize_kv, randn, False)
    k10, _, a10 = cs.beam_case(ca, quantize_kv, randn, True)
    a3 = cs.int8_plane_case(randn, quantize_kv, [(cs.PAST, p) for p in dpads], cs.N, 1, 384)
    for kernel, lib, fname, call in (
            ("decode_beam_attention", "beam_decode", "lia_beam_decode", lambda: k9(*a9)),
            ("decode_beam_attention_int8", "beam_decode_int8", "lia_beam_decode_int8", lambda: k10(*a10)),
            ("decode_attention_fresh_int8", "decode_fresh_int8", "lia_decode_fresh_int8",
             lambda: ca.decode_attention_fresh_int8(*a3))):
        raw, _kept = direct(lib, fname, call)
        (w_min, w_med), (r_min, r_med) = host(call), host(raw)
        cs.emit({"phase": "ab_host", "kernel": kernel, "wrapper_us_min": w_min, "wrapper_us_median": w_med,
                 "direct_us_min": r_min, "direct_us_median": r_med})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose lia_tpu_torch is measured")
    ap.add_argument("--label", help="name of the tree in every line")
    ap.add_argument("--kernels", nargs="*", choices=KERNEL_GROUPS, default=["decode", "paged", "mlp"],
                    help="kernel groups to time (none with no value)")
    ap.add_argument("--paths", nargs="*", choices=MAIN_PATHS, default=["gates"],
                    help="main paths to run (none with no value)")
    ap.add_argument("--serving-repeats", type=int, default=2)
    ap.add_argument("--summarize", type=Path, help="print medians of a log of earlier runs and exit")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize)
        return 0
    if not args.root or not args.label:
        ap.error("--root and --label are required")
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    label = args.label
    cs.emit = lambda obj: print(json.dumps({"tree": label, **obj}), flush=True)

    import lia_tpu_torch
    from lia_tpu_torch.config import GenerationConfig, QuantConfig
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import _build
    from lia_tpu_torch.ops import cuda_attention as ca
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    if not hasattr(ca, "split_counts"):  # a tree from before the split path: it splits nothing
        ca.split_counts = lambda: {"flash_attention_prefill": 0, "flash_attention_cached": 0}
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit({"phase": "device", "nvidia_smi": cs.nvidia_smi(), "package": str(Path(lia_tpu_torch.__file__).parent)})
    t0 = time.perf_counter()
    _build.build_all()  # the tree's first process builds every library; later ones load them
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})

    kernel_times(cs, ca, cm, args.kernels)
    cfg = get_config("opt-6.7b")
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (16, cs.PROMPT)).tolist()
    paths = args.paths
    steps = cs.NEW_TOKENS - 1
    if "quantized" in paths or "gates" in paths:
        gate = ("fused_mlp", {"fused_mlp": cfg.num_layers * steps}) if "gates" in paths else None
        cs.main_path(ca, cm, f"{label}: bf16 weights, none KV", cfg, lambda: device_dummy_params(cfg, seed=0),
                     prompts, "none", {}, timed=True, ab=gate)
    per_fwd = 4 * cfg.num_layers + 1  # wqkv, wo, fc1, fc2 per layer, the head
    for name, qkw, kernel in (("w4a8+int8kv", cs.CANDIDATES["w4a8+int8kv"][0], "w4a8_matmul"),
                              ("woq-int4-g128", cs.WEIGHT_ONLY["woq-int4-g128"], "woq_matmul")):
        if "quantized" not in paths:
            break
        qc = QuantConfig(**qkw)
        cs.main_path(ca, cm, f"{label}: {name}", cfg, lambda qc=qc: device_dummy_params(cfg, seed=0, quant=qc),
                     prompts, qc.kv_cache_dtype, {kernel: per_fwd}, timed=True)
    if "gates" in paths:
        lcfg = get_config("llama-3-8b")
        cs.main_path(ca, cm, f"{label}: llama-3-8b, unfused projections, bf16 KV", lcfg,
                     lambda: device_dummy_params(lcfg, seed=0), cs.llama_prompts(lcfg), "none", {}, timed=True,
                     runtime={"fuse_projections": False}, ab=("fused_mlp", {"fused_mlp": lcfg.num_layers * steps}))

    if "int8kv" in paths:
        from lia_tpu_torch.config import RuntimeConfig
        from lia_tpu_torch.engine.engine import InferenceEngine

        cs.main_path(ca, cm, f"{label}: bf16 weights, int8 KV", cfg, lambda: device_dummy_params(cfg, seed=0),
                     prompts, "int8", {}, timed=True)
        lcfg = get_config("llama-3-8b")
        cs.main_path(ca, cm, f"{label}: llama-3-8b, int8 KV", lcfg, lambda: device_dummy_params(lcfg, seed=0),
                     cs.llama_prompts(lcfg), "int8", {}, timed=True)
        engine = InferenceEngine(cfg, fuse_projections(cfg, device_dummy_params(cfg, seed=0)),
                                 RuntimeConfig(quant=QuantConfig(kv_cache_dtype="int8")))
        bprompts = [p[:n] for p, n in zip(prompts, cs.BEAM_PROMPT_LENS)]
        cs.beam_path(ca, cm, f"{label}: beam-nb4-int8kv", cfg, engine, bprompts, "int8", True, False, True, None)
        del engine
        torch.cuda.empty_cache()

    if "beam" in paths:
        from lia_tpu_torch.config import RuntimeConfig
        from lia_tpu_torch.engine.engine import InferenceEngine

        engine = InferenceEngine(cfg, fuse_projections(cfg, device_dummy_params(cfg, seed=0)), RuntimeConfig())
        bprompts = [p[:n] for p, n in zip(prompts, cs.BEAM_PROMPT_LENS)]
        cs.beam_path(ca, cm, f"{label}: beam-nb4", cfg, engine, bprompts, "none", True, False, True, None)
        del engine
        torch.cuda.empty_cache()

    if args.serving_repeats < 1:
        return 0
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=0))
    sprompts, new_tokens = cs.serving_workload(cfg.vocab_size)
    warm = ContinuousBatcher(cfg, params, max_batch=4, max_len=cs.SERVE_MAX_LEN, block_size=cs.SERVE_BLOCK,
                             gen=GenerationConfig(max_new_tokens=8), paged=True)
    for p in sprompts[:4]:
        warm.submit(p)
    warm.run()
    del warm
    opts = dict(cs.SERVING)
    for _ in range(args.serving_repeats):
        for name in SERVING_CELLS:
            cs.serving_path(ca, cm, name, opts[name], cfg, params, sprompts, new_tokens)
    return 0


if __name__ == "__main__":
    sys.exit(main())
