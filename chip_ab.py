"""A/B of two checkouts of the port on one card, in turns within one call.

Runs this checkout's ``chip_smoke.py`` phases over the ``lia_tpu_torch`` of
another checkout (``--root``), so two trees (a parent and a change) run the
same measurement code: the device times of the quantized-matmul entry points
(``w4a8_matmul``, ``w4a8_matmul_stacked``, ``woq_matmul`` int4 g128,
``woq4z_matmul``) at OPT-6.7B's wqkv, fc2 and head with 16 and 4096 rows, and
of the flash body at its table shapes (B1: b16 s256; B6: a 256-row chunk at
base 768); then OPT-6.7B at full width and depth, b16 x 256 prompt tokens and
32 new tokens through ``generate(fused=True)`` (prefill ms and decode
tokens/s, the median of 3 runs after a warm-up) with bf16 weights, with
bench.py's w4a8+int8kv and with weight-only int4 g128; then the
serving cells serve-paged-chunk256 and serve-paged (64 requests through a
ContinuousBatcher, as chip_smoke's serving phase, each ``--serving-repeats``
times in turns; ``--serving-repeats 0`` skips them). Every line chip_smoke
prints carries ``"tree": <label>``. Each tree builds its kernels into its own
``lia_tpu_torch/_build``. Run the trees in turns (A, B, B, A), one process
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
from pathlib import Path

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
        if rec.get("phase") == "main_path":
            for key in ("prefill_ms", "decode_tokens_per_s"):
                cells.setdefault((rec["config"].split(": ", 1)[1] + " " + key, tree), []).extend(rec[key + "_runs"])
        elif rec.get("phase") == "ab_kernel":
            cells.setdefault((f"{rec['kernel']} {rec['shape']} M={rec['M']} ms", tree), []).append(rec["ms"])
        elif rec.get("phase") == "serving":
            for key in ("tokens_per_s", "wall_s"):
                cells.setdefault((rec["config"] + " " + key, tree), []).append(rec[key])
            splits = rec.get("flash_split_launches")
            if splits:
                cells.setdefault((rec["config"] + " B6 split share", tree), []).append(
                    splits["flash_attention_cached"] / max(rec["launches"]["flash_attention_cached"], 1))
    for (cell, tree), vals in sorted(cells.items()):
        print(json.dumps({"cell": cell, "tree": tree, "median": statistics.median(vals), "runs": vals}))


def kernel_times(cs, ca, cm) -> None:
    """Device times (chip_smoke's profiler timing, L2 cold) of the four
    quantized-matmul entry points at chip_smoke's table shapes, and of B1 and
    B6 at theirs."""
    import torch

    from lia_tpu_torch.ops.quant import quantize_act

    picked = {("w4a8_matmul", "g128"), ("woq_matmul", "int4 g128"), ("woq4z_matmul", "g128"),
              ("w4a8_matmul_stacked", "g128")}
    for c in itertools.chain(cs.matmul_cases(cm, quantize_act), cs.stacked_cases(cm, quantize_act)):
        if (c["name"], c["variant"]) in picked:
            cs.emit({"phase": "ab_kernel", "kernel": c["name"], "shape": c["shape"], "M": c["M"],
                     "ms": cs.device_ms(c["kernel"])})
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = randn(cs.B, cs.PROMPT, cs.N, cs.D), randn(cs.B, cs.N, cs.PROMPT, cs.D), randn(cs.B, cs.N, cs.PROMPT, cs.D)
    mask = torch.ones(cs.B, cs.PROMPT, dtype=torch.bool, device="cuda")
    for b, p in enumerate(cs.PADS):
        mask[b, :p] = False
    cs.emit({"phase": "ab_kernel", "kernel": "flash_attention_prefill", "shape": "b16 s256", "M": cs.B * cs.PROMPT,
             "ms": cs.device_ms(lambda: ca.flash_attention_prefill(q, k, v, mask))})
    a6 = cs.cached_case(randn, 1, 256, 768, [0])
    cs.emit({"phase": "ab_kernel", "kernel": "flash_attention_cached", "shape": "C256 base 768", "M": 256,
             "ms": cs.device_ms(lambda: ca.flash_attention_cached(*a6))})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose lia_tpu_torch is measured")
    ap.add_argument("--label", help="name of the tree in every line")
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
    _build.build_all()

    kernel_times(cs, ca, cm)
    cfg = get_config("opt-6.7b")
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (16, cs.PROMPT)).tolist()
    cs.main_path(ca, cm, f"{label}: bf16 weights, none KV", cfg, lambda: device_dummy_params(cfg, seed=0), prompts,
                 "none", {}, timed=True)
    per_fwd = 4 * cfg.num_layers + 1  # wqkv, wo, fc1, fc2 per layer, the head
    for name, qkw, kernel in (("w4a8+int8kv", cs.CANDIDATES["w4a8+int8kv"][0], "w4a8_matmul"),
                              ("woq-int4-g128", cs.WEIGHT_ONLY["woq-int4-g128"], "woq_matmul")):
        qc = QuantConfig(**qkw)
        cs.main_path(ca, cm, f"{label}: {name}", cfg, lambda qc=qc: device_dummy_params(cfg, seed=0, quant=qc),
                     prompts, qc.kv_cache_dtype, {kernel: per_fwd}, timed=True)

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
