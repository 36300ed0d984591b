"""Accuracy runner: last-token prediction accuracy and perplexity on a token
dataset (port of the repo's ``run_accuracy.py``)::

    python -m lia_tpu_torch.run_accuracy -m opt-6.7b --dummy-weights --self-test --limit 32 \\
        --batch-size 16 --weight-dtype static-int8

It reads a local JSONL of token-id records, ``{"context": [1, 523, 88, ...],
"continuation": [42]}`` (``--dataset``), or makes a self-consistency probe
set with ``--self-test`` (the model's own greedy next tokens, which must
score as its argmax: a structural check, not a quality metric), and prints
one JSON line: ``n``, ``accuracy`` (greedy exact match of one-token
continuations, lambada's metric), ``loglikelihood`` and ``ppl``. Weights:
``--checkpoint`` (Hugging Face shards) or ``--dummy-weights`` (random from
seed 0); ``--weight-dtype static-int8`` and ``--gptq`` quantize the fp tree
on the device (``--act-quant dynamic`` retags 4-bit GPTQ onto W4A8).
``--device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain versions.
``--lm-eval`` drives lm-eval-harness tasks through
:mod:`lia_tpu_torch.utils.lm_eval_adapter` and needs ``lm_eval`` and a local
``--tokenizer``. Encoder-decoder models (T5) are not ported (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from lia_tpu_torch.api import _default_calib, load_params_for, quant_flow, refuse_unported
from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LIA accuracy runner (PyTorch/CUDA port)", allow_abbrev=False)
    p.add_argument("-m", "--model", default="opt-125m")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--dummy-weights", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--dataset", default=None, help="JSONL of {context, continuation} token ids")
    p.add_argument("--self-test", action="store_true", help="synthesize a probe set from the model")
    p.add_argument("--limit", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--weight-dtype", default="none", choices=["none", "int8", "int4", "static-int8"])
    p.add_argument("--group-size", type=int, default=-1)
    p.add_argument("--act-quant", default="none", choices=["none", "dynamic"])
    p.add_argument("--kv-cache-dtype", default="none", choices=["none", "int8"])
    p.add_argument("--gptq", action="store_true", help="GPTQ-quantize at load (Hessian-guided; needs fp weights)")
    p.add_argument("--lm-eval", action="store_true", help="run lm-eval-harness tasks (requires lm_eval + --tokenizer)")
    p.add_argument("--tasks", default="lambada_openai", help="comma-separated lm-eval task names")
    p.add_argument("--tokenizer", default=None, help="local tokenizer directory")
    return p


def main(argv=None) -> int:
    p = build_argparser()
    args = p.parse_args(argv)
    cfg = get_config(args.model).replace(dtype=args.dtype)
    refuse_unported(cfg)
    quant = QuantConfig(weight_dtype=args.weight_dtype, group_size=args.group_size,
                        kv_cache_dtype=args.kv_cache_dtype, act_quant=args.act_quant)
    params = load_params_for(cfg, quant, checkpoint=args.checkpoint, dummy=not args.checkpoint,
                             device=args.device, flow=quant_flow(cfg, quant, _default_calib(cfg), gptq=args.gptq))
    engine = InferenceEngine(cfg, params, RuntimeConfig(quant=quant), device=args.device)
    del params

    if args.lm_eval:
        if not args.tokenizer:
            p.error("--lm-eval requires --tokenizer <local dir>")
        try:
            import lm_eval
        except ImportError:
            p.error("lm_eval is not installed in this environment")
        from transformers import AutoTokenizer

        from lia_tpu_torch.utils.lm_eval_adapter import make_lm_eval_model

        tok = AutoTokenizer.from_pretrained(args.tokenizer, local_files_only=True)
        lm = make_lm_eval_model(engine, tok, batch_size=args.batch_size)
        results = lm_eval.simple_evaluate(model=lm, tasks=args.tasks.split(","), limit=args.limit or None)
        print(json.dumps(results.get("results", results), default=str))
        return 0

    records = []
    if args.dataset:
        with open(args.dataset) as f:
            for line in f:
                if line.strip():
                    records.append(json.loads(line))
                if len(records) >= args.limit:
                    break
    elif args.self_test:
        rng = np.random.default_rng(0)
        gen = GenerationConfig(max_new_tokens=1)
        for _ in range(args.limit // args.batch_size):
            prompts = [list(rng.integers(10, min(cfg.vocab_size - 10, 30000), size=32))
                       for _ in range(args.batch_size)]
            out = engine.generate(prompts, gen)
            for pr, tok in zip(prompts, out.sequences[:, 0]):
                records.append({"context": pr, "continuation": [int(tok)]})
    else:
        p.error("provide --dataset or --self-test")

    correct, total_ll, total_toks = 0, 0.0, 0
    for i in range(0, len(records), args.batch_size):
        chunk = records[i : i + args.batch_size]
        ctxs = [r["context"] for r in chunk]
        conts = [r["continuation"] for r in chunk]
        ll = engine.loglikelihood(ctxs, conts)
        greedy = engine.generate(ctxs, GenerationConfig(max_new_tokens=1)).sequences[:, 0]
        for r, l, g in zip(chunk, ll, greedy):
            total_ll += float(l)
            total_toks += len(r["continuation"])
            if len(r["continuation"]) == 1 and int(g) == r["continuation"][0]:
                correct += 1
    acc = correct / max(len(records), 1)
    ppl = float(np.exp(-total_ll / max(total_toks, 1)))
    print(json.dumps({"n": len(records), "accuracy": acc, "loglikelihood": total_ll, "ppl": ppl}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
