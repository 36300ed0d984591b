"""Benchmark and generation CLI (port of the repo's ``run.py``)::

    python -m lia_tpu_torch.run --benchmark -m opt-1.3b --dummy-weights --batch-size 8 \\
        --input-tokens 256 --max-new-tokens 32
    python -m lia_tpu_torch.run --benchmark -m llama-2-7b --dummy-weights --batch-size 16 \\
        --input-tokens 256 --prefill-policy auto --decoding-policy auto --hbm-percentage auto --calibrate

The reference's flags for what the port does, and ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions). The quantization
algorithms run on the device before the engine is built, over
``--calib-iters`` synthetic prompts: ``--gptq`` (with ``--gptq-actorder``;
4 or 8 bits by ``--weight-dtype``; retagged onto W4A8 with ``--act-quant
dynamic``), ``--smoothquant ALPHA|auto`` with a weight-only
``--weight-dtype`` (``auto`` sweeps ``--alpha-min`` to ``--alpha-max`` by
``--alpha-step``) and ``--weight-dtype static-int8`` (W8A8, at the
``--smoothquant`` alpha or 0.5). ``--tp`` raises ``NotImplementedError``
naming its ``ROADMAP.md`` item; ``--no-pallas`` is refused as the engine
refuses ``use_pallas=False``. ``--prompt`` and
``--tokenizer`` are left out (they need ``transformers`` and a local
tokenizer). ``--profile`` writes a ``torch.profiler`` trace. Prints the
reference's ``[warmup i]`` / ``[iter i]`` lines, the latency summary and one
JSON line; :func:`main` takes ``argv`` and runs in process.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from lia_tpu_torch.api import _default_calib, load_params_for, quant_flow, refuse_unported
from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.utils.metrics import format_summary


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LIA inference benchmark (PyTorch/CUDA port)", allow_abbrev=False)
    p.add_argument("-m", "--model", default="opt-1.3b", help="model name (see the registry)")
    p.add_argument("--checkpoint", default=None, help="local HF safetensors dir")
    p.add_argument("--dummy-weights", action="store_true", help="random weights from a fixed seed")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--input-tokens", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--num-iter", type=int, default=3)
    p.add_argument("--num-warmup", type=int, default=1)
    p.add_argument("--greedy", action="store_true", default=True)
    p.add_argument("--sample", dest="greedy", action="store_false")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--repetition-penalty", type=float, default=1.0)
    p.add_argument("--min-new-tokens", type=int, default=0, help="suppress EOS until this many tokens are out")
    p.add_argument("--no-repeat-ngram-size", type=int, default=0)
    p.add_argument("--num-beams", type=int, default=1, help="beam search width")
    p.add_argument("--length-penalty", type=float, default=0.0, help="beam final-score normalization exponent")
    p.add_argument("--fused-decode", action="store_true", help="decode loop with tokens kept on the device")
    # --- LIA policy knobs; 'auto' = the cost model's pick ---
    policy = lambda v: -1 if v == "auto" else int(v)
    p.add_argument("--prefill-policy", type=policy, default=3, help="0|1|2|3|auto (LIA policy semantics)")
    p.add_argument("--decoding-policy", type=policy, default=3, help="0|1|2|3|4|auto")
    p.add_argument("--hbm-percentage", type=policy, default=100,
                   help="%% of layers resident on the card (gpu-percentage) or 'auto'")
    p.add_argument("--calibrate", action="store_true", help="run live microbenchmarks for the auto cost model")
    p.add_argument("--num-minibatch", type=int, default=1)
    p.add_argument("--stream-weights", action="store_true", help="host-resident weights streamed per layer")
    p.add_argument("--no-overlap", action="store_true", help="serialize transfers")
    p.add_argument("--max-inflight-layers", type=int, default=2,
                   help="streamed layers whose copies may run ahead of their use")
    p.add_argument("--no-pallas", action="store_true", help="run without the kernels (refused by the port)")
    p.add_argument("--tp", type=int, default=1, metavar="N", help="tensor-parallel degree (not ported)")
    # --- quantization ---
    p.add_argument("--weight-dtype", default="none", choices=["none", "int8", "int4", "nf4", "static-int8"])
    p.add_argument("--group-size", type=int, default=-1)
    p.add_argument("--kv-cache-dtype", default="none", choices=["none", "int8"])
    p.add_argument("--act-quant", default="none", choices=["none", "dynamic"],
                   help="dynamic: per-token int8 activations")
    p.add_argument("--gptq", action="store_true",
                   help="GPTQ-quantize at load on calibration prompts; bits follow --weight-dtype (int4/int8)")
    p.add_argument("--gptq-actorder", action="store_true", help="GPTQ act-order (desc Hessian diagonal), static groups")
    p.add_argument("--smoothquant", default=None, metavar="ALPHA",
                   help="SmoothQuant outlier migration before WOQ: a float alpha, or 'auto' to sweep")
    p.add_argument("--alpha-min", type=float, default=0.3, help="smoothquant autotune sweep start")
    p.add_argument("--alpha-max", type=float, default=0.8, help="smoothquant autotune sweep end")
    p.add_argument("--alpha-step", type=float, default=0.1, help="smoothquant autotune sweep step")
    p.add_argument("--calib-iters", type=int, default=4, help="calibration prompts for the quantization flows")
    p.add_argument("--save-quantized", default=None, metavar="PATH",
                   help="save the (quantized) parameter tree after load")
    p.add_argument("--quantized-checkpoint", default=None, metavar="PATH",
                   help="load a saved (quantized) parameter tree")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace (lia_trace.json in --output-dir, else here)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding with K-token proposals")
    p.add_argument("--ngram", type=int, default=3, help="n-gram width for --speculative history matching")
    p.add_argument("--draft-model", type=str, default=None,
                   help="registry name of a draft model for two-model speculation (dummy weights)")
    p.add_argument("--streaming", action="store_true", help="print sequence 0's tokens as they decode")
    p.add_argument("--output-dir", default=None, metavar="DIR", help="also write the summary JSON to DIR/summary.json")
    return p


def _alpha_sweep(args):
    return [round(float(a), 4) for a in np.arange(args.alpha_min, args.alpha_max + 1e-9, args.alpha_step)]


def _flow(cfg, runtime, args):
    """The quantization algorithm the flags ask for (:func:`quant_flow`),
    printing the reference's ``[lia-tpu]`` line when it has run, or None."""
    sq = args.smoothquant if runtime.quant.enabled else None
    return quant_flow(cfg, runtime.quant, _default_calib(cfg, args.calib_iters), gptq=args.gptq,
                      gptq_actorder=args.gptq_actorder,
                      smoothquant=None if sq is None else ("auto" if sq == "auto" else float(sq)),
                      alphas=_alpha_sweep(args), log=print)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = get_config(args.model).replace(dtype=args.dtype)
    if not args.benchmark:
        print(f"[lia-tpu] {cfg.name}: params≈{cfg.num_params/1e9:.2f}B; pass --benchmark to run")
        return 0
    refuse_unported(cfg, tp=args.tp)
    runtime = RuntimeConfig(
        prefill_policy=args.prefill_policy,
        decode_policy=args.decoding_policy,
        hbm_percentage=args.hbm_percentage,
        num_minibatch=args.num_minibatch,
        stream_weights=args.stream_weights,
        overlap=not args.no_overlap,
        max_inflight_layers=args.max_inflight_layers,
        use_pallas=not args.no_pallas,
        quant=QuantConfig(weight_dtype=args.weight_dtype, group_size=args.group_size,
                          kv_cache_dtype=args.kv_cache_dtype, act_quant=args.act_quant),
    )
    if -1 in (args.prefill_policy, args.decoding_policy, args.hbm_percentage):
        from lia_tpu_torch.runtime.cost_model import resolve_auto_policies

        runtime = resolve_auto_policies(cfg, runtime, args.batch_size, args.input_tokens, args.max_new_tokens,
                                        calibrate=args.calibrate)
        print(f"[lia-tpu] auto placement: prefill={runtime.prefill_policy} "
              f"decode={runtime.decode_policy} hbm%={runtime.hbm_percentage}")
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        do_sample=not args.greedy,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        min_new_tokens=args.min_new_tokens,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        num_beams=args.num_beams,
        length_penalty=args.length_penalty,
    )

    print(f"[lia-tpu] model={cfg.name} params≈{cfg.num_params/1e9:.2f}B dtype={cfg.dtype} device={args.device}")

    t0 = time.perf_counter()
    if args.quantized_checkpoint:
        from lia_tpu_torch.utils.checkpoint import load_params

        params = load_params(args.quantized_checkpoint)
    else:  # a checkpoint, or dummy weights (drawn in quantized form where no algorithm runs)
        params = load_params_for(cfg, runtime.quant, checkpoint=args.checkpoint, dummy=not args.checkpoint,
                                 device=args.device, flow=_flow(cfg, runtime, args))
    if args.save_quantized:
        from lia_tpu_torch.utils.checkpoint import save_params

        save_params(params, args.save_quantized)
        print(f"[lia-tpu] saved quantized checkpoint → {args.save_quantized}")
    print(f"[lia-tpu] weights ready in {time.perf_counter()-t0:.1f}s")
    engine = InferenceEngine(cfg, params, runtime, device=args.device)
    del params

    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(10, min(cfg.vocab_size - 10, 30000), size=args.input_tokens))
               for _ in range(args.batch_size)]

    on_token = None
    if args.streaming:
        if args.fused_decode or gen.num_beams > 1:
            raise SystemExit("--streaming needs the stepwise loop (drop --fused-decode/--num-beams)")
        if engine.scheduler is not None:
            raise SystemExit("--streaming needs the resident stepwise loop (drop the tiered/streaming policy knobs)")

        def on_token(toks):
            print(f" {int(toks[0])}", end="", flush=True)

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if engine.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    draft_engine = None
    if args.draft_model and args.speculative > 0:
        dcfg = get_config(args.draft_model).replace(dtype=args.dtype)
        draft_engine = InferenceEngine(dcfg, load_params_for(dcfg, QuantConfig(), dummy=True, device=args.device),
                                       RuntimeConfig(), device=args.device)
        print(f"[lia-tpu] draft model: {dcfg.name} (two-model speculation)")
    results = []
    for it in range(args.num_warmup + args.num_iter):
        tag = "warmup" if it < args.num_warmup else "iter"
        t0 = time.perf_counter()
        if args.speculative > 0:
            if draft_engine is not None:
                seqs, steps = engine.generate_speculative_draft(draft_engine, prompts, gen, k=args.speculative)
            else:
                seqs, steps = engine.generate_speculative(prompts, gen, ngram=args.ngram, k=args.speculative)
            dt = time.perf_counter() - t0
            print(f"[{tag} {it}] {dt:.3f}s  ({seqs.size / dt:.1f} tok/s; {steps} verify passes for "
                  f"{gen.max_new_tokens} tokens)")
            continue
        if gen.num_beams > 1:
            res = engine.generate_beam(prompts, gen)
        else:
            res = engine.generate(prompts, gen, fused=args.fused_decode, on_token=on_token)
        if on_token is not None:
            print(flush=True)
        dt = time.perf_counter() - t0
        print(f"[{tag} {it}] {dt:.3f}s  ({res.sequences.size / dt:.1f} tok/s)")
        if it >= args.num_warmup:
            results.append(res)
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(args.output_dir or ".", "lia_trace.json")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prof.export_chrome_trace(path)
        print(f"[lia-tpu] trace written to {path}")

    if results:
        best = max(results, key=lambda r: r.summary()["total_tokens_per_s"])
        s = best.summary()
        print(format_summary(s))
        line = {"model": cfg.name, **{k: round(v, 6) for k, v in s.items()}}
        print(json.dumps(line))
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            out = os.path.join(args.output_dir, "summary.json")
            with open(out, "w") as f:
                json.dump(line, f, indent=1)
            print(f"[lia-tpu] summary written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
