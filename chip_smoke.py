"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per item:

1. device: the card's name and power limit (nvidia-smi) and torch's view of
   it; host: the machine's MemTotal, CPU count and torch threads, and the
   card's memory free to this process;
2. build: every CUDA kernel of lia_tpu_torch/csrc, built with nvcc in parallel;
   the flash, quantized-matmul, paged-decode, fused-MLP, int8-decode, bf16
   beam and plane-decode libraries' kernels as ptxas built them (registers,
   spills: none allowed; the attention bodies with and without their ALiBi
   template flag) and their blocks' dynamic shared memory (and ring stages);
   then MPT-30B (the slice's widest model, ALiBi, D 112) through
   alibi_phase before any check holds the card's memory;
3. kernel checks: each kernel against its plain PyTorch version on the card at
   the main path's shapes. Attention (OPT-6.7B: B=16, N=N_kv=32, D=128;
   prefill S=256 with left pads; decode past length 272 in a 320-slot bf16 /
   384-slot int8 cache; write-then-attend decode over a 320-slot plane holding
   273 tokens, also at G = 4 and through the stacked entry at a layer offset;
   paged decode over a shuffled 2-layer pool, bs 16, 16 rows of 1-1000 tokens
   with the fresh merge, also at C = 4, G = 4 (both) and D = 64, and at the
   timing variants' shapes; chunk-over-cache
   attention as a prefix-cache suffix (C=256 at base 768 of 1024 slots, also
   at G = 4), as a left-padded first chunk (B=2, C=128), with a window, and as
   a short suffix that the host splits (C=48 at base 960, also at G = 4 with a
   window); grouped-beam decode,
   bf16 and int8, over 4 groups of 4 beams with a 256-slot prompt (group pads
   0/7/31/100) and a 16-token tail, also at G = 4, D = 64 and tail 0; B9's
   bf16 body also at tail 32, G = 8 (32 queries a group) and over a 1024-slot
   prompt, each with the host's parts and forced to 1 and 3); the
   int8 decode body (B3, B10) with the host's split and forced to 1 and 3
   parts: B3 over rows of length 0, start = length, starts off 4, a window
   and ~1000 tokens at G = 1 and 4, B10 with tails of 0, 16 and 100, at
   Llama-3-8B's heads and over a 1024-slot prompt; flash
   prefill and bf16 / int8 decode at Llama-3-8B's heads (32 over 8 KV heads,
   D 128), without and with a sliding window of 64 that binds; every
   attention kernel (B1, B2, B7/B8, B3, B6, B5 at C = 1 and 4, B9, B10) at
   Falcon-7B's heads (71 over one KV head, D 64: G = 71, a ragged last run
   of queries) and ChatGLM3-6B's (32 over 2, D 128: G = 16), and at the head
   dims 80, 96 and 256 (the padded bodies): OPT-2.7B's heads (32 over 32, D
   80), GPT-NeoX-20B's (64 over 64, D 96) and GPT-J-6B's (16 over 16, D 256),
   each D also at G = 4; B2 and B7 (plane_checks) on the host's route (the
   plane body at G = 1, the bf16 beam body past it) at OPT-6.7B's and
   Llama-3-8B's heads, at G = 2, at D = 256, G = 4 and at G = 8, each with
   its parts and forced to 1 and 3. Each check draws its inputs
   from a generator of its own, seeded from its name (check_randn). Quantized
   matmuls at M = 16 (decode rows) and 4096
   (prefill rows) for the wqkv, fc2 and head (K, N) of OPT-6.7B: w4a8 with and
   without zero-points, woq int8 per-channel / int4 g128 / NF4 g128, woq4z g128;
   the stacked w4a8 entry over a 3-layer stack at wqkv and fc2, every layer
   bit for bit against w4a8_matmul on its view. The fused MLP at OPT-6.7B's
   relu, gelu and gelu_new arms (LayerNorm, biases) and Llama-3-8B's SwiGLU
   (RMSNorm), at 1, 16, 17 and 256 rows, twice (the same bits: its sums run in
   a fixed order), its grid barrier's counters left zero. ALiBi
   (alibi_kernel_checks): every attention kernel with slopes at MPT-7B's,
   MPT-30B's (D 112) and Baichuan-13B's (N 40) heads, on left-padded rows,
   the splits forced both ways, timed with and without slopes;
4. main path: InferenceEngine.generate(fused=True) for opt-6.7b at full width
   and depth with random weights, 16 prompts x 256 tokens, 32 new tokens:
   bf16 weights with bf16 and with int8 KV; bench.py's two candidates
   (int8dyn+int8kv, w4a8+int8kv); weight-only int8, int4 g128 and NF4 g128
   with bf16 KV; a GPTQ checkpoint (OPT-6.7B width at 2 layers,
   synthesized in AutoGPTQ's packing) as woq_int4z and retagged as
   woq_int4z_dyn; and a llama-layout GPTQ checkpoint (Llama-2-7B width at 2
   layers: q/k/v, o, gate, up and down as woq_int4z) with projections fused
   (4 woq4z launches a layer and forward) and unfused (7). Two gate A/Bs, each on its gate-off run's engine, the two
   sides in turns: bf16 with the fused-MLP gate on (992 fused MLPs: every
   decode step's layers), w4a8+int8kv with the stacked-W4A8 gate on (3968
   stacked launches, 160 w4a8_matmul: the prefill and the heads). Then
   llama-3-8b at full width and
   depth (dummy bf16 weights made once on the card), the same prompts' shape:
   the default engine with bf16 and with int8 KV, and with projections
   unfused, the fused-MLP gate off and on in turns (32 flash prefills, 992 decode
   attention launches, 992 fused MLPs with the gate on). Then Falcon-7B at
   full width (H 4544, 71 heads over one KV head, F 18176, vocab 65024; 8
   of its 32 layers (FAMILY_CELLS); bf16 weights drawn on the card) with
   bf16 and int8 KV (median of 3), and ChatGLM3-6B, Baichuan2-7B and
   StableLM-2-1.6B at full width and 4 layers with bf16 KV (L flash
   prefills and L * 31 decode launches, no fused MLP); the head
   dims 80, 96 and 256: OPT-2.7B at full width and 8 layers (D 80) with bf16
   and int8 KV (median of 3), GPT-J-6B (D 256, 7 of 28 layers) with both and
   GPT-NeoX-20B (D 96, 11 of its 44 layers) with bf16 KV, one run each, and
   StableLM-3B, CodeGen-2B and CodeGen-6B at 4 layers (L flash prefills and
   L * 31 decode launches each, no plain version on the card); the ALiBi
   families (alibi_phase): MPT-7B at full width and depth with bf16 KV, the
   fused-MLP gate off and on in turns (B14's exact gelu), and int8 KV; the
   ALiBi parities (alibi_parity) at 4 layers; then the
   checkpoint round trips on the card's machine, with the port's own
   safetensors module: ChatGLM3-6B's 4-layer tree through save_params and
   load_params, Falcon-7B, CodeGen-2B (mp_num = 4 qkv_proj) and
   StarCoderBase-1B (GPTBigCode) at 2 layers written as two Hugging Face shards and read by load_hf_checkpoint (equal
   to params_from_hf_state_dict on the same dict), each giving the tokens of
   the tree it came from, with the save's and load's seconds and GB/s (the
   `checkpoint` lines). The launch
   counters, zeroed just before one run and read just after it, must show
   each path's kernels exactly, and no plain version may run on the card in
   that run; for the bf16 paths, the two candidates, the
   gate A/Bs and the Llama runs prefill ms and decode tokens/s are the median
   of 3 runs. Each configuration's engine is freed before the next is made;
5. tiered: LIA's offload path, InferenceEngine.generate over a tiering
   RuntimeConfig at OPT-6.7B full width and depth, same prompts, from one
   host tree (bf16) made once on the card from the seed and copied out: h2d
   (copy rates of one streamed layer's bytes), then tier-h50-p3 (half
   resident, the rest streamed; 4 layers), tier-h50-p3-ring3 (the same with
   max_inflight_layers=3: a ring of 3, two layers in flight ahead),
   tier-h0-p3-int8kv (all streamed, int8 KV),
   tier-h50-p0 (KV on the host), tier-h50-p0-p2-mb4 (prefill policy 0 in 4
   minibatches, decode policy 2: host attention), the last four at 4 layers
   of the same tree (TIER_DEPTH), tier-p1-2layer (policy 1,
   2 layers, 2 prompts of 64 tokens, all on the CPU) and, over an int8dyn
   tree, tier-h50-p3-int8dyn (4 layers) against the resident engine on the
   same tree.
   Each line: prefill ms and decode tokens/s (median of 3 runs where timed),
   bytes streamed and copy-stream ms per step, peak device memory under a
   residency limit, exact launch counts;
6. serving: ContinuousBatcher at OPT-6.7B full width, SERVING_LAYERS layers (bf16 weights
   made once), one seeded workload of 64 requests submitted together (32
   share a 256-token prefix and add 16-256 tokens, 32 have 64-512 unique
   tokens; 16-128 new tokens each, no EOS), max_batch 16, max_len 1024, pages
   of 16, after a warm-up of a few requests: serve-slab (bf16 KV),
   serve-slab-int8kv, serve-paged (prefix caching), serve-paged-noapc,
   serve-paged-chunk256 (prefill_chunk 256, no prefix cache) and
   serve-paged-fused8 (fused_steps 8). Each line: stats() (tokens/s, TTFT
   and TPOT percentiles, steps, dispatches, prefix hits), wall time, peak
   memory and the launch counts, checked exactly against the batcher's own
   counters, and how many flash and paged calls split their walks (parts >
   1); every request's length and vocabulary, and every page back at
   the end. serve_http: the HTTP front end over serve-paged's batcher, 8
   concurrent /generate requests, /stats and /health. serving_parity:
   OPT-6.7B width at 2 layers, the batcher's functions in its order (prefill,
   page commit, a prefix-cache admission, 4 paged decode steps; insert_slot
   and 4 ragged steps over a bf16 and an int8 slab), card against CPU, also
   at OPT-2.7B's and GPT-J-6B's widths (D 80 and 256);
7. beam and score: InferenceEngine.generate_beam at OPT-6.7B full width and
   depth, 4 seeded prompts cut to 256/240/200/160 tokens, 4 beams, 32 new
   tokens, no EOS: beam-nb4 (grouped, bf16 KV) and beam-nb4-int8kv (median of
   3), beam-nb4-expanded, beam-nb4-proc (repetition penalty 1.2,
   no_repeat_ngram_size 3), tier-h50-p3-beam (grouped under the scheduler)
   and tier-h50-p0-beam (expanded, host KV), at 4 layers, one run each. Each line: prefill
   ms, decode row-tokens/s (16 rows x 31 steps over the decode seconds), the
   bytes a step's beam shuffle rewrites, peak memory, exact launch counts.
   score: loglikelihood of 16 records of 256 + 32 tokens, resident and
   tier-h50-p3, ms per call, the two agreeing. beam_parity: OPT-6.7B width at
   2 layers, a grouped beam cache and 4 beam_decode_step calls (the CPU run's
   tokens and shuffles forced on both sides) and score_logprobs, card against
   CPU, bf16 and int8 KV, also at OPT-2.7B's and GPT-J-6B's widths;
7b. speculative: OPT-6.7B at full width and SPEC_LAYERS layers, 16 prompts of 256
   tokens (each a seeded 32-token pattern repeated), 32 new tokens, k = 4:
   spec-lookup over bf16 and int8 KV (generate_speculative, ngram 3),
   spec-draft with opt-125m (full width and depth) drafting greedy,
   spec-draft-sampled (temperature 0.8, top_p 0.95) and spec-draft-topk1
   (sampled at top_k 1: its tokens and steps must equal spec-draft's), each
   greedy cell checked against a teacher-forced score pass over prompt and
   emitted tokens (every emitted token's log-prob within SPEC_GREEDY_BOUND
   of the top one) and beside plain greedy generate's tokens;
   serve-slab-spec4, serve-paged-spec4 and serve-paged-draft (the serving
   workload with speculate_k 4, the last with the opt-125m draft);
   tier-h50-p3-spec4 (prompt lookup under tier-h50-p3 at its 4 layers, the
   weight stream's bytes per emitted token beside tier-h50-p3's plain decode
   in this run).
   Each line: verify steps, tokens emitted and per step, prefill ms and
   tokens/s (serving: TTFT and TPOT percentiles), exact launch counts (B1
   once per model and layer, B6 per verify layer, B5 per paged verify
   layer, B2 per draft layer and step; B6's splits as flash_split_parts
   plans). speculative_parity: OPT-6.7B width at 2 layers, the slab, paged
   and tiered verify passes (two chunks of 5 with an uneven accept between)
   on the card against the CPU;
7c. serving over the tiered scheduler: ContinuousBatcher over the tiered
   phase's host tree at OPT-6.7B width, the serving workload's first 32
   requests, max_batch 16, max_len 1024: serve-tier-h50-p3 (2 layers,
   slab, bf16 KV), serve-tier-h50-p3-paged, serve-tier-h50-p0-p2 (host KV,
   host attention at decode) and serve-tier-h50-p3-spec4 (prompt lookup,
   k = 4), each at 2 (SERVING_TIERED); then serve-paged-proc, resident at full depth over the
   whole 64-request workload, every second request with repetition penalty
   1.2 and min_new_tokens 8, every fourth a no_repeat_ngram_size of 3 (no
   such request may repeat a 3-gram). Each line: stats() (tokens/s, TTFT and
   TPOT percentiles, steps), wall and init time, peak memory, exact launch
   counts (B1 per layer and admission, B2 per resident layer and step, B7 per
   streamed layer and step where the decode plan attends on the card, B5 per
   layer and step paged, B6 per layer and verify), no plain version on the
   card, every request's length and vocabulary, the pool clean; over the
   scheduler one copy of each streamed layer a pass (admission or step), the
   bytes, copy-stream ms and host attention ms a pass. serving_tier_parity:
   OPT-6.7B width at 4 layers, half resident, three slots (the middle one
   inactive), insert_slot_state and 4 ragged steps under policies 3 (bf16
   and int8 KV), 0 and 0/2, and 4 paged steps at policy 3, card against CPU;
7d. automatic placement and the CLI: calibrate, Microbench.calibrate() from
   the detected card's profile (the pinned copy's alpha and beta with a
   matmul in flight, beta beside the h2d phase's pinned rate; the host's fp32
   and the card's bf16 matmul rates; the host's copy rate), every calibrated
   field off its default; cost_model, the calibrated model's decode step (and
   the H100 defaults') beside the measured one for every resident main-path
   cell and every tiered cell at its depth, with their ratio (no generate
   call); auto_placement, Hypertune at OPT-6.7B's width and 4 layers, hbm
   50, prefill (0, 3) x decode (0, 1, 2, 3), b4, 64 in, 8 new (no candidate
   may fail, no plain version on the card), its measured ranking beside
   CostModel.choose on the same config with the calibrated profile's memory
   set to hold two of the four layers (the pick's percentage must be 50);
   cli, lia_tpu_torch.run.main in process at Llama-2-7B full width and depth
   (dummy weights drawn on the card), b16, 256 + 32, auto on all three knobs
   with --calibrate (the pick must be (3, 3, 100); exact B1 and B2 launches
   over the warm-up and the timed run, no plain version, the JSON line with
   the reference's keys), then with int8 KV (B3);
7e. quantization algorithms (quant_algos_phase): OPT-6.7B at full width
   from one bf16 tree drawn on the card, the default calibration prompts (4
   x 64 tokens), each flow quantizing on the card (its seconds and peak
   memory, no plain version on the card), then generate through main_path
   (b16, 256 + 32, exact launches, median of 3): w8a8-static+int8kv
   (static_int8_quantize at alpha 0.5, 32 layers; B1, B3), smoothquant-
   auto-int8 (autotune_alpha's KL for each alpha, the fold at the best, int8
   weight-only records; B1, B2, B14), gptq-int4-g128 (gptq_quantize_params,
   4 bits, g 128, the first 4 layers, the seconds a layer of the solves and
   of the Hessians; B13), the same tree retagged onto W4A8 (B11) and
   act-order over one layer (B13); accuracy (lia_tpu_torch.run_accuracy.main
   --self-test, 32 records at b16, OPT-6.7B static-int8: n 32, a finite ppl,
   exact B1 launches); modules (indirect_access_kv_cache_attention over a
   bf16 and an int8 cache, B2 and B3, paged_attention, B5, each against its
   kernel's plain version, varlen_attention against attention one sequence
   at a time); quant_parity (OPT-6.7B width at 2 layers: the fold, the
   static records and a GPTQ solve on equal inputs, card against CPU; the
   bf16 calibration on the card against the CPU's fp32 one; the three
   flows' trees, card against CPU logits);
8. parity: OPT-6.7B width at 2 layers, prefill + 4 decode steps on the card
   (bf16, kernels) against the CPU (fp32, plain versions) over the same tree:
   bf16 weights with both KV types, and int8dyn+int8kv, w4a8+int8kv (gate
   off, then with the stacked W4A8 route: 32 stacked launches) and
   weight-only int4 g128; Llama-3-8B width at 2 layers, projections unfused,
   both gates on (the fused MLP at every layer), bf16 and int8 KV;
   Falcon-7B and ChatGLM3-6B widths (bf16 and int8 KV), Baichuan2-7B's and
   StableLM-2-1.6B's (bf16 KV), OPT-2.7B's and GPT-J-6B's (both KV types),
   GPT-NeoX-20B's, StableLM-3B's, CodeGen-2B's and CodeGen-6B's (bf16 KV),
   Llama-2-7B's (both KV types);
   and the tiered scheduler at 4 layers (half resident) under policies 3, 0
   and 0/2 with bf16 and with int8 KV, and policy 3 over int8dyn weights and
   int8 KV, and policy 3 with both KV types at OPT-2.7B's and GPT-J-6B's
   widths;
9. device breakdown: one more main-path run per timed OPT configuration and
   of llama-3-8b with bf16 KV under the
   profiler (weights made anew), device time by kernel and the idle share;
   for tier-h50-p3 and tier-h50-p0-p2-mb4, device compute, copies and host
   attention per step, and the same for serve-tier-h50-p3's batcher over a
   wave of 16 more requests (per pass); one more beam-nb4 and beam-nb4-int8kv run each (with
   every launch of the port's kernels: the beam kernel's device ms a run);
10. kernel times: each kernel's, its plain version's and a PyTorch library
   call's device time (profiler trace, mean of 20 calls, L2 flushed before
   each, the flush's own events (traced once alone: its argmax and memset)
   left out, and none of their names launched by a wrapper, after a
   discarded warm-up step; each kernel's mean over the
   launches traced; a kernel's trace must hold each of its launches in at
   least three quarters of the calls, else it is taken again and, after
   five, the run fails; the kernel's time also from CUDA events, as a
   cross-check)
   and the wrapper's host time, beside the least time the card could take for the
   same bytes or operations; the library call's time both from the trace
   (with the kernels it held per call) and from events, the events' where
   the trace reads under the bound (the stacked w4a8 entry's library call is
   torch._int_mm, as w4a8_matmul's; the fused MLP's, where no single PyTorch
   call computes the block, the unfused chain of torch calls); torch._int_mm
   over a row- and a column-major int8 weight; the flash body also at B1's
   Llama-3-8B heads (G = 4), a short prefix-cache suffix (C=48 at base 960) and
   a chunk256 first chunk, each with its number of parts and SDPA's time; the
   every attention kernel at OPT-2.7B's, GPT-NeoX-20B's and GPT-J-6B's heads
   (D 80, 96, 256), with its parts, beside SDPA, bound from the bytes at the
   real D; B2 and B7 at G = 2, Llama-3-8B's heads, D = 256, G = 4 and G =
   8, with the host's parts beside SDPA, at D = 256, G = 4 with the split
   forced the other way, and at OPT-6.7B's heads on the bf16 beam body (the
   body past PLANE_MAX_GROUP, against the plane body's row of the kernels
   line); the
   paged body at Llama-3-8B's heads (G = 4, 8 KV heads) and over rows of ~1000
   tokens, with its parts and SDPA's time; B3 at Llama-3-8B's heads and over
   ~1000-token rows and B10 over a 1024-slot prompt, with their parts and
   SDPA's time over the keys dequantized, each over ~1000 keys (B3 at G = 4
   also ~2000) also with the split forced the other way, and B10 at
   Llama-3-8B's heads (two blocks a group); B9 at Llama-3-8B's heads (16
   queries a block), D = 64, tail 0, over a 1024-slot prompt at both heads,
   with its parts and SDPA's time, and each split shape with the split forced
   the other way; every attention kernel at Falcon-7B's and ChatGLM3-6B's
   heads, with its parts, beside SDPA over K/V repeated to the query heads
   (B5's pages gathered, B9's and B10's [prompt | tail | fresh] joined, B3's
   and B10's dequantized; none of it timed); the fused MLP at OPT-6.7B's
   relu (16 rows, biases) beside its unfused chain; the speculative
   verify's shapes (B6 over 16 rows of a 5-row chunk at bases 256-300, B5
   at C = 5, G = 1) beside SDPA.
   Profiling comes last because a profiler session slows the process's later
   launches.

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
import re
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
REPS = 20  # calls a kernel time averages over
TIME_VARIANTS = []  # kernel times at other shapes than the kernels line's, filled by the checks
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
    ("tier-h50-p0-p2-mb4", "none", 50, (0, 2), 4, 2, False),  # host attention: ~40 s a run at 32 layers
]
# the configurations that run at a cut depth (OPT-6.7B's width, the first n
# layers of the same tree), to make room in the time limit for the
# speculative phase (the host-KV and host-attention cells decode at 15-84
# tokens/s and the fully streamed one at 56) and for the head-dim phases
# (tier-h50-p3-ring3, tier-h50-p3's ring of 3, tier-h50-p3-beam,
# tier-h50-p3-int8dyn and tier-h50-p0-beam at 4), for the ALiBi
# families' phases tier-h50-p3 (with its breakdown and tier-h50-p3-spec4)
# from 32 to 8 layers and tier-h50-p0, tier-h0-p3-int8kv,
# tier-h50-p0-p2-mb4 and tier-h50-p3-ring3 from 8 to 4, and, for the
# quantization algorithms' phase, tier-h50-p3, tier-h50-p3-beam and
# tier-h50-p3-int8dyn from 8 to 4
TIER_DEPTH = {"tier-h50-p3": 4, "tier-h50-p0": 4, "tier-h0-p3-int8kv": 4, "tier-h50-p0-p2-mb4": 4,
              "tier-h50-p0-beam": 4, "tier-h50-p3-ring3": 4, "tier-h50-p3-beam": 4, "tier-h50-p3-int8dyn": 4}
TIER_COPY_BYTES = {}  # the weight stream's bytes per decode step of each tiered configuration
TIERED_MEASURED = {}  # each tiered configuration's model, residency, policies and median decode rate
H2D = {}  # the h2d phase's copy rates
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
TIER_PARITY_HEAD_DIMS = TIER_PARITY[0:1] + TIER_PARITY[3:4]  # policy 3 over bf16 and int8 KV, at HEAD_DIM_PARITY
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
# the serving and speculative phases' depth: the first layers of OPT-6.7B
# (32 before the ALiBi families' phases came, 16 before the quantization
# algorithms' phase)
SERVING_LAYERS = SPEC_LAYERS = 8
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
    step reaches them). A read leaves no dirty lines to write back. Every event
    it launches (the argmax kernel, and the memset that clears the reduction's
    semaphores) is dropped from a trace by name (flush_events)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    _flush_buf.argmax()


_FLUSH_EVENTS = []


def flush_events() -> dict:
    """The device events one _flush() launches, name -> launches a flush, from
    a trace of the flush alone (taken once, and printed): device_trace leaves
    them out of a call's time."""
    if not _FLUSH_EVENTS:
        from torch.profiler import ProfilerActivity, profile

        _flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                _flush()
            torch.cuda.synchronize()
        events = {e.key: e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
        emit({"phase": "flush_events", "calls": REPS, "events": events})
        check(any("ArgMax" in k for k in events), f"the flush's trace holds no argmax kernel: {events}")
        _FLUSH_EVENTS.append({k: c / REPS for k, c in events.items()})
    return _FLUSH_EVENTS[0]


def device_trace(fn):
    """Device time of one call of ``fn`` (every kernel it launches), L2 cold,
    from the profiler's trace of REPS (flush, fn) pairs without the flush's
    events (flush_events); with the launches the trace holds per call, by name
    (the flush's among them). The trace starts with a warm-up step whose
    events are dropped. It still loses launches now and then, whole (flush,
    fn) pairs at a time (seen on the card: 19 or 18 of 20 calls, for some
    shapes in every trace, and once none), so trace_time takes each kernel's
    mean over the launches traced. Host time between launches is not in it
    (see host_us)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    flush = flush_events()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for reps in (3, REPS):  # the warm-up step, then the traced one
            for _ in range(reps):
                _flush()
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ms, _ = trace_time([e for e in events if e.key not in flush])
    _, per_call = trace_time(events)
    return ms, per_call


def trace_time(events):
    """(ms of one call, launches a call by name) from the profiler's averages
    over a trace of REPS calls: each kernel's mean time over the launches
    traced, times its launches a call (the traced count over REPS, rounded:
    a kernel traced in fewer than half of the calls counts for none)."""
    total_us, per_call = 0.0, {}
    for e in events:
        if e.count:
            total_us += e.self_device_time_total / e.count * round(e.count / REPS)
        per_call[e.key[:80]] = per_call.get(e.key[:80], 0.0) + e.count / REPS
    return total_us / 1e3, per_call


def device_ms(fn) -> float:
    return device_trace(fn)[0]


# the port's own kernels in a trace, by their CUDA names (csrc/*.cu, *.cuh)
OWN_KERNEL = re.compile(r"lia_(dec8?|flash|paged|qmm|beam|plane)::|fused_mlp_kernel")
TRACE_TRIES = 5


def own_launches(ca, fn) -> int:
    """Kernels one call of the wrapper call ``fn`` launches: one, and a merge
    launch where the call splits its walk (the wrappers' split counters)."""
    before = sum(ca.split_counts().values())
    fn()
    return 1 + sum(ca.split_counts().values()) - before


def kernel_trace(name: str, fn, launches=None):
    """device_trace of a kernel wrapper call, held to what a call launches:
    each of the port's own kernels traced in at least three quarters of the
    calls, a whole number of times a call, ``launches`` of them in all (at
    least one where None). A trace that missed more is taken again, up to
    TRACE_TRIES times, and the run fails if every trace misses. Other events
    are not held to a count (the trace drops some of the flush's memsets
    too), but no event of a name the flush launches may show more than once a
    call: the wrappers zero their tickets and workspaces once, not per call,
    and a launch of such a name would fall out of the kernel's time."""
    flush = {k[:80]: n for k, n in flush_events().items()}  # trace_time's names
    for attempt in range(TRACE_TRIES):
        ms, traced = device_trace(fn)
        extra = {k: c for k, c in traced.items() if k in flush and c > flush[k] + 0.5}
        check(not extra, f"{name}: the call launches events the flush's are dropped as: {extra}")
        own = [c for k, c in traced.items() if OWN_KERNEL.search(k)]
        kept = all(round(c) >= 1 and abs(c - round(c)) <= 0.25 for c in own)
        n = sum(round(c) for c in own)
        if kept and (n == launches if launches is not None else n >= 1):
            return ms, traced
        emit({"phase": "trace_retry", "kernel": name, "attempt": attempt, "launches": launches, "traced": traced})
    raise AssertionError(f"{name}: {TRACE_TRIES} traces missed launches (expected {launches} a call): {traced}")


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


def flash_build_report(_build, paths) -> None:
    """Each flash library's kernels as ptxas built them (registers, spill stores
    and loads: widths 64 and 128 with one and two consumer warpgroups, 256
    with one, each with whole positions a tile and, for groups past 64, flat
    rows, each with and without the ALiBi term; the merge at each width) and the body's dynamic shared memory a
    block at each head dim; a spill fails the run."""
    import re

    from lia_tpu_torch.ops.cuda_attention import KERNEL_DIMS

    for lib in ("flash_prefill", "flash_cached"):
        kernels, cur = [], None
        for line in open(f"{paths[lib]}.log").read().splitlines():
            m = re.search(r"Function properties for \S*?(flash_kernel|merge_kernel)ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?"
                          r"(?:Lb(\d)E)?", line)
            if m:  # flash_kernel<D, warpgroups, flat rows, alibi>, merge_kernel<D>
                args = ([m.group(2)] + ([m.group(3)] if m.group(3) else []) + (["flat"] if m.group(4) == "1" else [])
                        + (["alibi"] if m.group(5) == "1" else []))
                cur = {"kernel": f"{m.group(1)}<{', '.join(args)}>"}
                kernels.append(cur)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        smem = {f"D={dh}, {nw} warpgroups": _build.library(lib).lia_flash_smem_bytes(dh, nw)
                for dh in KERNEL_DIMS for nw in (1, 2) if dh <= 128 or nw == 1}
        emit({"phase": "flash_build", "library": lib, "kernels": kernels, "dynamic_smem_bytes": smem})
        check(len(kernels) == 23 and all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in kernels),
              f"{lib}: ptxas reports spills (or no report): {kernels}")


def qmatmul_build_report(_build, paths) -> None:
    """Each quantized-matmul library's kernels as ptxas built them (the body's
    instantiations by kind, zero-points, regime (decode, prefill, prefill
    stepwise) and stacked entry, and the row sums' first launch: registers,
    spill stores and loads) and a block's
    dynamic shared memory at OPT-6.7B's wqkv in g128 and per-channel; a spill
    fails the run."""
    import re

    kinds = {0: "int8", 1: "int4", 2: "nf4", 3: "int4z", 4: "w4a8"}
    for lib in ("w4a8_matmul", "woq_matmul"):
        kernels, cur = [], None
        for line in open(f"{paths[lib]}.log").read().splitlines():
            m = re.search(r"Function properties for \S*?(qmm_kernel|rowsum_kernel)I"
                          r"(?:Li(\d+)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E|Lb(\d)E)", line)
            if m:
                if m.group(1) == "qmm_kernel":
                    regime = "decode" if m.group(4) == "1" else "prefill" if m.group(6) == "1" else "prefill stepwise"
                    name = f"qmm_kernel<{kinds[int(m.group(2))]}, zp={m.group(3)}, {regime}, stacked={m.group(5)}>"
                else:
                    name = f"rowsum_kernel<s8={m.group(7)}>"
                cur = {"kernel": name}
                kernels.append(cur)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        K = OPT_KN["wqkv"][0]
        if lib == "w4a8_matmul":
            smem = {f"{r}, {grp}{', zero-points' if zp else ''}":
                    _build.library(lib).lia_w4a8_smem_bytes(int(r == "decode"), K, K // GROUP if grp == "g128" else 1, zp)
                    for r in ("decode", "prefill") for grp in ("g128", "per-channel") for zp in (0, 1)}
        else:
            smem = {f"{kind}, {r}": _build.library(lib).lia_woq_smem_bytes(code, int(r == "decode"), K,
                                                                           1 if kind == "int8" else K // GROUP)
                    for kind, code in (("int8", 0), ("int4", 1), ("nf4", 2), ("int4z", 3)) for r in ("decode", "prefill")}
        emit({"phase": "qmatmul_build", "library": lib, "kernels": kernels, "dynamic_smem_bytes": smem})
        # 12 instantiations of the body and the row sums
        check(len(kernels) == 13 and all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in kernels),
              f"{lib}: ptxas reports spills (or no report): {kernels}")


def paged_mlp_build_report(_build, paths) -> None:
    """The paged-decode and fused-MLP libraries' kernels as ptxas built them
    (registers, spill stores and loads; a spill fails the run), each block's
    dynamic shared memory and the ring stages it holds: the paged body at bs
    16 (bf16 and fp32, widths 64, 128 and 256 (D 64, 80, 96, 112, 128, 256), one or four queries a consumer warp,
    with and without the ALiBi term: 24 instances, and the merge at each type and width), the
    fused MLP at H 4096 (with the rows one phase-1 pass normalizes, and the
    persistent grid's blocks at Llama-3-8B's F on this card)."""
    import re

    from lia_tpu_torch.ops.cuda_attention import KERNEL_DIMS

    patterns = {"paged_decode": r"Function properties for \S*?(paged_kernel|merge_kernel)I(13__nv_bfloat16|f)Li(\d+)E"
                                r"(?:Li(\d+)ELb(\d)E)?",
                "fused_mlp": r"Function properties for \S*?(fused_mlp_kernel)ILb(\d)ELb(\d)E"}
    for lib, expect in (("paged_decode", 30), ("fused_mlp", 4)):
        kernels, cur = [], None
        for line in open(f"{paths[lib]}.log").read().splitlines():
            m = re.search(patterns[lib], line)
            if m:
                if lib == "paged_decode":
                    t = "bf16" if m.group(2) != "f" else "fp32"
                    name = f"{m.group(1)}<{t}, width={m.group(3)}" + (
                        f", qpw={m.group(4)}{', alibi' if m.group(5) == '1' else ''}>" if m.group(4) else ">")
                else:
                    name = f"fused_mlp_kernel<rms={m.group(2)}, gated={m.group(3)}>"
                cur = {"kernel": name}
                kernels.append(cur)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        L = _build.library(lib)
        if lib == "paged_decode":
            smem = {f"{t}, D={dh}, bs 16, qpw={qpw}": {"bytes": L.lia_paged_smem_bytes(es, dh, SERVE_BLOCK, qpw),
                                                       "stages": L.lia_paged_stages(es, dh, SERVE_BLOCK, qpw)}
                    for t, es in (("bf16", 2), ("fp32", 4)) for dh in KERNEL_DIMS for qpw in (1, 4)}
        else:
            smem = {f"H {H}": {"bytes": L.lia_fused_mlp_smem_bytes(H), "stages": L.lia_fused_mlp_stages(H),
                               "rows_a_pass": L.lia_fused_mlp_row_chunk(H), f"blocks at F {Fd}": L.lia_fused_mlp_blocks(H, Fd)}
                    for H, Fd in ((4096, 14336), (8192, 28672), (12288, 49152))}
        emit({"phase": "kernel_build", "library": lib, "kernels": kernels, "dynamic_smem": smem})
        check(len(kernels) == expect and all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0
                                             for k in kernels), f"{lib}: ptxas reports spills (or no report): {kernels}")


def int8_build_report(_build, paths) -> None:
    """The int8 decode libraries' kernels as ptxas built them (the body's
    instantiations by type, width (64, 128, 256) and D, and the merge launch's:
    registers, spill stores and loads; a spill fails the run), and a block's
    dynamic shared memory and ring stages at the main path's grids on this
    card (B3 at OPT-6.7B b16 and at Llama-3-8B's heads, B10 at 4 x 4 beams,
    and each split in 2 over its ~1000-key walk), at each head dim."""
    import re

    from lia_tpu_torch.ops.cuda_attention import KERNEL_DIMS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lib in ("decode_fresh_int8", "beam_decode_int8"):
        kernels, cur = [], None
        for line in open(f"{paths[lib]}.log").read().splitlines():
            m = re.search(r"Function properties for \S*?(int8_kernel|merge_kernel)I(13__nv_bfloat16|f)Li(\d+)E"
                          r"(?:Li(\d+)ELb)?", line)
            if m:  # int8_kernel<type, width, D>, merge_kernel<type, width>
                cur = {"kernel": f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'fp32'}, width={m.group(3)}"
                                 + (f", D={m.group(4)}>" if m.group(4) else ">")}
                kernels.append(cur)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        L = _build.library(lib)
        grids = {"decode_fresh_int8": (("OPT-6.7B b16", 32 * 16), ("Llama-3-8B b16", 8 * 16),
                                       ("Llama-3-8B b16 over ~1000 tokens, 2 parts", 8 * 16 * 2)),
                 "beam_decode_int8": (("4 x 4 beams", 32 * 4), ("4 x 4 beams, 1024-slot prompt, 2 parts", 32 * 4 * 2))}[lib]
        smem = {f"{label}, D={dh}": {"blocks": blocks, "stages": L.lia_dec8_stages(dh, blocks, sms),
                                     "bytes": L.lia_dec8_smem_bytes(dh, L.lia_dec8_stages(dh, blocks, sms))}
                for label, blocks in grids for dh in KERNEL_DIMS}
        emit({"phase": "kernel_build", "library": lib, "kernels": kernels, "dynamic_smem": smem})
        # the body at bf16 / fp32 and each D (64, 80, 96, 112, 128, 256), the merge launch at each width
        check(len(kernels) == 18 and all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in kernels),
              f"{lib}: ptxas reports spills (or no report): {kernels}")


def beam_build_report(_build, paths) -> None:
    """The bf16 beam body's kernels (beam_decode.cu, beam_attn.cuh) as ptxas
    built them: beam_kernel at D 64, 80, 96, 112 and 128 with one and two
    column tiles and at 256 with one, each with and without the ALiBi term, and its split's merge launch at each width
    (registers, spill stores and loads; a spill fails the run); the fp32 warp
    body's instantiations are listed with their registers. A block's dynamic
    shared memory and ring stages at the main path's grids on this card, at
    each head dim."""
    import re

    from lia_tpu_torch.ops.cuda_attention import KERNEL_DIMS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels, cur = [], None
    for line in open(f"{paths['beam_decode']}.log").read().splitlines():
        m = re.search(r"Function properties for \S*?(?:beam_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E|merge_kernelI"
                      r"13__nv_bfloat16Li(\d+)E|decode_kernelIfLi(\d+)ELi(\d+)ELi(\d+)E)", line)
        if m:
            g = m.groups()
            if g[0]:
                name = (f"beam_kernel<width={g[0]}, D={g[1]}, column tiles={g[2]}"
                        f"{', alibi' if g[3] == '1' else ''}>")
            elif g[4]:
                name = f"merge_kernel<bf16, width={g[4]}>"
            else:
                name = f"decode_kernel<fp32, width={g[5]}, D={g[6]}, G={g[7]}> (warp body)"
            cur = {"kernel": name}
            kernels.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    L = _build.library("beam_decode")
    grids = (("OPT-6.7B 4 x 4 beams", 32 * 4), ("Llama-3-8B 4 x 4 beams, 4 parts", 8 * 4 * 4),
             ("16 x 4 beams at OPT-6.7B's heads", 32 * 16))
    smem = {f"{label}, D={dh}": {"blocks": blocks, "stages": L.lia_beam_stages(dh, blocks, sms),
                                 "bytes": L.lia_beam_smem_bytes(dh, L.lia_beam_stages(dh, blocks, sms))}
            for label, blocks in grids for dh in KERNEL_DIMS}
    emit({"phase": "kernel_build", "library": "beam_decode", "kernels": kernels, "dynamic_smem": smem})
    body = [k for k in kernels if "warp body" not in k["kernel"]]
    check(len(body) == 25 and all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in body),
          f"beam_decode: ptxas reports spills (or no report): {body}")


def decode_build_report(_build, paths) -> None:
    """The plane decode libraries' kernels (decode.cu: B7/B8, decode_fresh.cu:
    B2) as ptxas built them: the bf16 plane body (plane_attn.cuh) by width and
    D, the bf16 beam body behind it past
    PLANE_MAX_GROUP and the split's merge at each width, and the fp32 warp
    body (decode_attn.cuh) by width, D and heads (registers, spill stores and
    loads), with a plane block's dynamic shared memory and ring stages at the
    timed shapes on this card. A spill in the plane or beam body, or in a
    warp body at D 80, 96, 112 or 256, fails the run (at 64 and 128 the fp32
    G = 3 runs spill a few bytes, as before these head dims)."""
    import re

    from lia_tpu_torch.ops import cuda_attention as ca

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lib in ("decode", "decode_fresh"):
        kernels, cur = [], None
        for line in open(f"{paths[lib]}.log").read().splitlines():
            m = re.search(r"Function properties for \S*?(?:plane_kernelILi(\d+)ELi(\d+)ELb\dELb(\d)E|decode_kernelIf"
                          r"Li(\d+)ELi(\d+)ELi(\d+)ELb\dELi\dELb(\d)E|beam_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E|"
                          r"merge_kernelI13__nv_bfloat16Li(\d+)E)", line)
            if m:
                g = m.groups()
                alibi = ", alibi" if g[2] == "1" or g[10] == "1" else ""
                if g[0]:
                    name = f"plane_kernel<width={g[0]}, D={g[1]}{alibi}> (plane body)"
                elif g[3]:
                    name = (f"decode_kernel<fp32, width={g[3]}, D={g[4]}, heads={g[5]}"
                            f"{', chunked' if g[6] == '1' else ''}> (warp body)")
                elif g[7]:
                    name = f"beam_kernel<width={g[7]}, D={g[8]}, column tiles={g[9]}{alibi}>"
                else:
                    name = f"merge_kernel<bf16, width={g[11]}>"
                cur = {"kernel": name}
                kernels.append(cur)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        L = _build.library(lib)
        smem = {}
        for label, Bq, Nq, Nkv, Dh in (("OPT-6.7B b16", B, N, N, D), ("OPT-2.7B b16", B, 32, 32, 80),
                                       ("GPT-NeoX-20B b16", B, 64, 64, 96), ("MPT-30B b16", B, 64, 64, 112),
                                       ("GPT-J-6B b16", B, 16, 16, 256)):
            plan = ca.plane_plan(Bq, Nq, Nkv, 384, True, sms, Dh)
            smem[label] = {"parts": plan.parts, "stages": plan.stages,
                           "bytes": L.lia_plane_smem_bytes(Dh, plan.stages)}
        emit({"phase": "kernel_build", "library": lib, "kernels": kernels, "dynamic_smem": smem})
        counts = {kind: sum(kind in k["kernel"] for k in kernels) for kind in ("plane body", "warp body", "beam_kernel",
                                                                              "merge_kernel")}
        held = [k for k in kernels if "warp body" not in k["kernel"] or re.search(r"D=(80|96|112|256),", k["kernel"])]
        # the plane body at 6 head dims, the fp32 warp body's 31 instances, the
        # beam body's 11 (each plane and beam instance with and without the
        # ALiBi term) and its merge at 3 widths
        check(counts == {"plane body": 12, "warp body": 31, "beam_kernel": 22, "merge_kernel": 3}
              and all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in held),
              f"{lib}: ptxas reports spills (or another set of kernels): {counts} {kernels}")


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------


def check_randn(name: str):
    """Normal draws on the card for the check ``name`` (in ``dtype``, bf16 by
    default) from a generator of its own, seeded from the name: adding,
    moving or resizing a check leaves every other check's inputs as they were."""
    g = torch.Generator(device="cuda")
    g.manual_seed(zlib.crc32(name.encode()))

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return randn


def kernel_checks(ca, quantize_kv):
    import torch.nn.functional as F

    randn = check_randn("kernel_checks")
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
    # the function reads q and K/V at valid positions only and writes all of out
    nbytes = 3 * sum(n_valid) * N * D * 2 + q.numel() * 2 + mask.numel()
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
    # yardstick, as the beam int8 row's: SDPA over layer li's plane dequantized
    # to bf16 before the timing, the fresh token written (another function: no
    # PyTorch call attends over an int8 cache with per-token scales)
    from lia_tpu_torch.ops.quant import QuantizedKV, dequantize_kv

    kd, vd = (dequantize_kv(QuantizedKV(c.q[li], c.s[li])) for c in (kq, vq))
    kd[:, :, PAST], vd[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
    sm8_inc = sm8.clone()
    sm8_inc[:, PAST] = True
    rows["decode_attention_fresh_int8"] = dict(
        source="lia_tpu_torch/csrc/decode_fresh_int8.cu",
        replaces="lia_tpu/ops/pallas_attention.py:1170",
        max_abs_err=(out.float() - ref.float()).abs().max().item(),
        kernel=lambda: ca.decode_attention_fresh_int8(*args),
        plain=lambda: ca.decode_attention_fresh_int8_plain(*args),
        library=lambda: F.scaled_dot_product_attention(qdt, kd, vd, attn_mask=sm8_inc[:, None, None, :]),
        library_kind="one call over K/V dequantized to bf16 (another function)",
        bound=bound(past_keys * N * (D + 4) * 2 + io_bytes + sm8.numel(), 4 * D * N * (past_keys + B)),
    )
    rows.update(serving_kernel_checks(ca, check_randn("serving_kernel_checks"), dpads))
    rows.update(beam_kernel_checks(ca, quantize_kv, check_randn("beam_kernel_checks")))
    int8_decode_checks(ca, quantize_kv, check_randn("int8_decode_checks"))
    llama_attention_checks(ca, quantize_kv, check_randn("llama_attention_checks"))
    head_kernel_checks(ca, quantize_kv, GROUP_HEADS + HEAD_DIM_HEADS)
    alibi_kernel_checks(ca, quantize_kv, ALIBI_HEADS)
    plane_checks(ca)
    verify_kernel_checks(ca, check_randn("verify_kernel_checks"))
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
    import torch.nn.functional as F

    from lia_tpu_torch.ops.attention import decode_attn_ctx

    q, k, v = randn(B, PROMPT, LLAMA_N, D), randn(B, LLAMA_NKV, PROMPT, D), randn(B, LLAMA_NKV, PROMPT, D)
    mask = torch.ones(B, PROMPT, dtype=torch.bool, device="cuda")
    for b, p in enumerate(PADS):
        mask[b, :p] = False
    valid = mask[:, :, None, None]
    # B1's time at G = 4 beside SDPA over K/V repeated to the 32 query heads
    # (the repeat is not timed)
    causal = torch.tril(torch.ones(PROMPT, PROMPT, dtype=torch.bool, device="cuda"))
    sdpa_mask = (causal[None] & mask[:, None, :])[:, None]
    G4 = LLAMA_N // LLAMA_NKV
    qt, kr, vr = q.transpose(1, 2), k.repeat_interleave(G4, 1), v.repeat_interleave(G4, 1)
    n_valid = [PROMPT - p for p in PADS]
    TIME_VARIANTS.append(dict(
        kernel_name="flash_attention_prefill", variant="llama-3-8b heads G=4 (B 16, S 256, N 32, N_kv 8)",
        parts=ca.flash_split_parts(B, PROMPT, LLAMA_N, LLAMA_NKV, PROMPT,
                                   torch.cuda.get_device_properties(0).multi_processor_count),
        kernel=lambda: ca.flash_attention_prefill(q, k, v, mask),
        library=lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=sdpa_mask),
        bound=bound(sum(n_valid) * (LLAMA_N + 2 * LLAMA_NKV) * D * 2 + q.numel() * 2 + mask.numel(),
                    4 * D * LLAMA_N * sum(n * (n + 1) / 2 for n in n_valid))))
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
FUSED_MLP_ROWS = (1, 16, 17, 256)  # one sequence, the b16 decode step, a second chunk of rows, the kernel's most
# Llama-3-70B's and OPT-175B's widths: phase 1 takes their rows in chunks of 8 and 4
FUSED_MLP_WIDE_CASES = [
    ("llama-3-70b swiglu", 8192, 28672, "silu", True, False),
    ("opt-175b relu", 12288, 49152, "relu", False, True),
]
FUSED_MLP_WIDE_ROWS = (1, 16, 256)
FUSED_MLP_TOL = 2e-2  # |kernel - plain| <= tol * (1 + |plain|): bf16 outputs of O(1)
# round once at the end (one step is 2^-7 relative); the fp32 sums run in
# another (fixed) order, which can also move a rounding of the normed input or
# of the activation by one step


def fused_mlp_checks(cuda_mlp) -> dict:
    """B14 against its plain version at each case and row count (the main
    path's widths, and the wide cases), twice (the sums' order is fixed: the
    two calls give the same bits), the grid barrier's counters left zero; returns the kernels line's row: Llama-3-8B's
    SwiGLU at 16 rows, timed against the plain version and the unfused torch
    chain (norm, matmuls, activation, add), the yardstick where no single
    PyTorch call computes the block; and OPT-6.7B's relu at 16 rows (with
    biases) as a timing variant beside it."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    row = None
    cases = [(c, FUSED_MLP_ROWS) for c in FUSED_MLP_CASES] + [(c, FUSED_MLP_WIDE_ROWS) for c in FUSED_MLP_WIDE_CASES]
    for (label, H, Fd, act, rms, biases), row_counts in cases:
        def r(*shape, sc=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * sc).to(torch.bfloat16)

        # weights of std 0.02 at H 4096, F <= 16384, scaled down past them so
        # that the up-projection and the sum over F stay O(1), as the tolerance assumes
        up, down = 0.02 * min(1.0, (4096 / H) ** 0.5), 0.02 * min(1.0, (16384 / Fd) ** 0.5)
        w = dict(ln_scale=(1 + r(H, sc=0.1).float()).to(torch.bfloat16), ln_bias=r(H, sc=0.1) if biases else None,
                 w1=r(H, Fd, sc=up), b1=r(Fd, sc=0.1) if biases else None,
                 wg=r(H, Fd, sc=up) if act == "silu" else None, w2=r(Fd, H, sc=down),
                 b2=r(H, sc=0.1) if biases else None)
        for rows in row_counts:
            x = r(rows, H)
            out = cuda_mlp.fused_mlp(x, **w, activation=act, rms=rms)
            again = cuda_mlp.fused_mlp(x, **w, activation=act, rms=rms)
            ref = cuda_mlp.fused_mlp_plain(x, **w, activation=act, rms=rms)
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            excess = (d - FUSED_MLP_TOL * (1 + ref.float().abs())).max().item()
            _, barrier = cuda_mlp._workspace(torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream,
                                             rows, Fd)
            line = {"phase": "kernel_check", "kernel": "fused_mlp", "variant": label, "rows": rows,
                    "max_abs_err": d.max().item(),
                    "max_abs_err_rerun": (again.float() - out.float()).abs().max().item(),
                    "max_abs_plain": ref.float().abs().max().item(), "tol": f"{FUSED_MLP_TOL} * (1 + |plain|)",
                    "barrier_zero": not bool(barrier.any())}
            emit(line)
            check(bool(torch.isfinite(out.float()).all()), f"fused_mlp {label} rows={rows}: non-finite output")
            check(excess <= 0 and line["barrier_zero"] and torch.equal(again, out),
                  f"fused_mlp {label} rows={rows}: {line}")
            if rows == B and label in ("llama-3-8b swiglu", "opt-6.7b relu"):
                swiglu = act == "silu"

                def chain(x=x, w=w, rms=rms, act=act, swiglu=swiglu, H=H):
                    h = (F.rms_norm(x, (H,), w["ln_scale"], 1e-5) if rms
                         else F.layer_norm(x, (H,), w["ln_scale"], w["ln_bias"], 1e-5))
                    if swiglu:
                        a = F.silu(h @ w["wg"]) * (h @ w["w1"])
                    else:
                        a = {"relu": F.relu, "gelu": F.gelu}[act](torch.addmm(w["b1"], h, w["w1"]))
                    return x + (a @ w["w2"] if w["b2"] is None else torch.addmm(w["b2"], a, w["w2"]))

                weight_bytes = 2 * H * Fd * (3 if swiglu else 2)
                vector_bytes = 2 * (H + (H + Fd + H if biases else 0))  # ln scale (and bias), b1, b2
                nbytes = 2 * 2 * rows * H + weight_bytes + vector_bytes
                kernel = lambda x=x, w=w, a=act, n=rms: cuda_mlp.fused_mlp(x, **w, activation=a, rms=n)  # noqa: E731
                if swiglu:
                    row = dict(source="lia_tpu_torch/csrc/fused_mlp.cu", replaces="lia_tpu/ops/pallas_mlp.py:98",
                               max_abs_err=line["max_abs_err"], kernel=kernel,
                               plain=lambda x=x, w=w, a=act, n=rms: cuda_mlp.fused_mlp_plain(x, **w, activation=a,
                                                                                             rms=n),
                               library=chain, library_kind="chain of torch calls: norm, matmuls, activation, add",
                               bound=bound(nbytes, 2 * rows * H * Fd * 3))
                else:
                    TIME_VARIANTS.append(dict(kernel_name="fused_mlp", variant=f"{label}, {rows} rows, biases",
                                              parts=None, kernel=kernel, library=chain,
                                              bound=bound(nbytes, 2 * rows * H * Fd * 2)))
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


def cached_case(randn, Bq: int, C: int, base: int, pads, S_max: int = SERVE_MAX_LEN, Nkv: int = N):
    """A chunk of C rows over an S_max-slot plane that holds it at [base, base +
    C), each row's validity starting at its pad (a first chunk's pad rows, or
    0 over a cached prefix); N query heads over Nkv kv heads."""
    q = randn(Bq, C, N, D)
    kc, vc = randn(Bq, Nkv, S_max, D), randn(Bq, Nkv, S_max, D)
    sm = torch.zeros(Bq, S_max, dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        sm[b, p : base + C] = True
    return q, kc, vc, torch.tensor(base, dtype=torch.int32, device="cuda"), sm


def split_forced(ca, parts, fn, plan: str = "flash_split_parts"):
    """``fn`` with the split of the kernels whose parts ``ca.<plan>`` chooses
    (the flash kernels', ``int8_split_parts``: B3's and B10's, or
    ``beam_plan``: B9's (beams a block, parts)) forced to ``parts`` (None:
    the host's own choice)."""
    def call():
        real = getattr(ca, plan)
        if parts is not None:
            setattr(ca, plan, (lambda *a: (real(*a)[0], parts)) if plan == "beam_plan" else (lambda *a: parts))
        try:
            return fn()
        finally:
            setattr(ca, plan, real)
    return call


def plane_forced(ca, fn, parts=None, beam=False):
    """``fn`` with bf16 plane decode (B2, B7/B8) split into ``parts`` parts
    (None: the host's choice) and, with ``beam``, on the bf16 beam body at
    every group (as the host's route past PLANE_MAX_GROUP: a group of one
    beam, planned by beam_plan)."""
    def call():
        real = ca.plane_plan

        def plan(B_, N_, Nkv, S_max, bf16, sms, D_=128):
            if beam and bf16:
                bpc, host = ca.beam_plan(B_, 1, N_, Nkv, S_max, 0, sms, D_)
                return ca.PlanePlan("beam", parts or host, 0, bpc)
            return real(B_, N_, Nkv, S_max, bf16, sms, D_, parts)
        ca.plane_plan = plan
        try:
            return fn()
        finally:
            ca.plane_plan = real
    return call


# the plane decode shapes beyond the table's, past PLANE_MAX_GROUP (where the
# bf16 beam body takes them): G = 2 (N 32 over 16, D 128), Llama-3-8B's heads
# (G 4, D 128), D = 256 at G = 4 (N 16 over 4) and G = 8 (N 32 over 4)
PLANE_HEADS = [("G=2 (N 32, N_kv 16, D 128)", 32, 16, 128), ("llama-3-8b heads G=4 (N 32, N_kv 8, D 128)", 32, 8, 128),
               ("D=256 G=4 (N 16, N_kv 4)", 16, 4, 256), ("G=8 (N 32, N_kv 4, D 128)", 32, 4, 128)]


def plane_checks(ca) -> None:
    """B2 and B7 against their plain versions on the host's route (the plane
    body, csrc/plane_attn.cuh, at G = 1; the bf16 beam body past
    PLANE_MAX_GROUP), each with its own parts and forced to 1 and 3: at
    OPT-6.7B's heads (the kernels line's shape) and at PLANE_HEADS (B 16,
    past 272 with left pads, a 384-slot cache). Then their timing variants at
    each shape on the host's route beside SDPA over K/V repeated to the query
    heads (the repeat not timed); at OPT-6.7B's heads also on the bf16 beam
    body (the other side of PLANE_MAX_GROUP); at D = 256, G = 4 also with the
    split forced to 2 parts (64 blocks, where plane_plan leaves out
    beam_plan's split)."""
    import torch.nn.functional as F

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dpads = [0, 3, 7, 15] * 4
    past_keys = sum(PAST - p for p in dpads)
    for label, Nq, Nkv, Dh in [("opt-6.7b heads (N 32, N_kv 32, D 128)", N, N, D)] + PLANE_HEADS:
        randn, G = check_randn("plane_checks " + label), Nq // Nkv
        qd, kf, vf = randn(B, 1, Nq, Dh), randn(B, Nkv, 1, Dh), randn(B, Nkv, 1, Dh)
        sm = torch.zeros(B, 384, dtype=torch.bool, device="cuda")
        for b, p in enumerate(dpads):
            sm[b, p:PAST] = True
        kc, vc = randn(2, B, Nkv, 384, Dh), randn(2, B, Nkv, 384, Dh)
        ln = torch.tensor(PAST, dtype=torch.int32, device="cuda")
        kp, vp = kc[1].clone(), vc[1].clone()
        kp[:, :, PAST], vp[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
        sm_inc = sm.clone()
        sm_inc[:, PAST] = True
        args2, args7 = (qd, kf, vf, kc, vc, 1, sm, ln), (qd, kp, vp, sm_inc, ln + 1)
        calls = {"decode_attention_fresh": (lambda a=args2: ca.decode_attention_fresh(*a),
                                            ca.decode_attention_fresh_plain(*args2)),
                 "decode_attention": (lambda a=args7: ca.decode_attention(*a), ca.decode_attention_plain(*args7))}
        host = ca.plane_plan(B, Nq, Nkv, 384, True, sms, Dh)
        check(host.body == ("plane" if G <= ca.PLANE_MAX_GROUP else "beam"), f"{label}: plan {host}")
        for kernel, (fn, ref) in calls.items():
            for parts in (None, 1, 3):
                out = plane_forced(ca, fn, parts)()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                emit({"phase": "kernel_check", "kernel": kernel, "variant": f"{label}, {host.body} body, parts "
                      f"{parts or 'host'}", "max_abs_err": err, "tol": KERNEL_TOL})
                check(bool(torch.isfinite(out).all()) and err <= KERNEL_TOL,
                      f"{kernel} {label}, {host.body} body, parts {parts}: max abs err {err}")
        nbytes = {"decode_attention_fresh": past_keys * Nkv * Dh * 4 + 4 * qd.numel() * 2 + 4 + sm.numel(),
                  "decode_attention": (past_keys + B) * Nkv * Dh * 4 + 2 * qd.numel() * 2 + 4 + sm.numel()}
        work = 4 * Dh * Nq * (past_keys + B)
        qdt, dmask = qd.transpose(1, 2), sm_inc[:, None, None, :]
        kr, vr = kp.repeat_interleave(G, 1), vp.repeat_interleave(G, 1)
        beam_parts = ca.beam_plan(B, 1, Nq, Nkv, 384, 0, sms, Dh)[1]
        for kernel, (fn, _) in calls.items():
            TIME_VARIANTS.append(dict(
                kernel_name=kernel, variant=f"{label}, host's route ({host.body} body)", parts=host.parts, kernel=fn,
                library=lambda a=(qdt, kr, vr, dmask): F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                                                      attn_mask=a[3]),
                bound=bound(nbytes[kernel], work)))
            if host.body == "plane":  # the other side of PLANE_MAX_GROUP
                TIME_VARIANTS.append(dict(
                    kernel_name=kernel, variant=f"{label}, bf16 beam body", parts=beam_parts,
                    kernel=plane_forced(ca, fn, beam=True), library=None, bound=bound(nbytes[kernel], work)))
            elif Dh == 256:  # 64 blocks: beam_plan's split, which plane_plan leaves out, forced
                TIME_VARIANTS.append(dict(
                    kernel_name=kernel, variant=f"{label}, {host.body} body, 2 parts forced", parts=2,
                    kernel=plane_forced(ca, fn, 2), library=None, bound=bound(nbytes[kernel], work)))


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
                                   ("C=4 GQA G=4", 4, N // 4, 4, D), ("D=64", 1, N, 1, 64)):
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
    # timing variants: Llama-3-8B's G = 4 (8 kv heads, B 16) over the same
    # lengths, and rows of ~1000 tokens (1000 - pad) at both head layouts,
    # each beside SDPA over its keys gathered into a plane (K/V repeated to the
    # 32 query heads at G = 4; the gather is not timed) and with the host's parts
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for variant, v_lengths, Nkv in (("llama-3-8b heads G=4 (N_kv 8), lengths 272 - pad", t_lengths, N // 4),
                                    ("lengths 1000 - pad", [1000 - p for p in dpads], N),
                                    ("llama-3-8b heads G=4, lengths 1000 - pad", [1000 - p for p in dpads], N // 4)):
        G = N // Nkv
        P = -(-(max(v_lengths) + 1) // SERVE_BLOCK)
        va = paged_case(randn, v_lengths, 1, Nkv, G, D, P=P, L=1)  # one layer: these live to the timing phase
        vargs = (va[0], va[1], va[2], 0, *va[3:])
        compare("paged_decode_attention", variant, ca.paged_decode_attention(*vargs),
                ca.paged_decode_attention_plain(*vargs))
        S = P * SERVE_BLOCK
        vk = va[1][0][va[3].long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, D)
        vv = va[2][0][va[3].long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, D)
        vk[rows_idx, :, va[4].long()] = va[5][:, :, 0]
        vv[rows_idx, :, va[4].long()] = va[6][:, :, 0]
        vk, vv = vk.repeat_interleave(G, 1), vv.repeat_interleave(G, 1)
        vmask = (torch.arange(S, device="cuda")[None, :] <= va[4][:, None].long())[:, None, None, :]
        vkeys = sum(v_lengths)
        TIME_VARIANTS.append(dict(
            kernel_name="paged_decode_attention", variant=variant,
            parts=ca.paged_split_parts(B, 1, N, Nkv, P, sms),
            kernel=lambda a=vargs: ca.paged_decode_attention(*a),
            library=lambda a=(va[0].transpose(1, 2), vk, vv, vmask): F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=a[3]),
            bound=bound(vkeys * Nkv * D * 2 * 2 + (2 * N + 2 * Nkv) * B * D * 2 + va[3].numel() * 4 + B * 4,
                        4 * D * N * (vkeys + B))))

    # B6: a prefix-cache suffix (B=1, C=256, base=768 of 1024 slots), a first
    # chunk with left pads (B=2, C=128, base=0), a sliding window, the same
    # suffix at Llama-3-8B's G = 4, and a short suffix (C=48 at base 960, which
    # the host splits), also at G = 4 with a window
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for variant, Bq, C, base, pads, window, Nkv in (("APC suffix", 1, 256, 768, [0], None, N),
                                                    ("first chunk, left pads", 2, 128, 0, [5, 77], None, N),
                                                    ("window 300", 1, 256, 768, [0], 300, N),
                                                    ("APC suffix G=4", 1, 256, 768, [0], None, LLAMA_NKV),
                                                    ("short suffix C=48", 1, 48, 960, [0], None, N),
                                                    ("short suffix C=48 G=4 window 100", 1, 48, 960, [0], 100,
                                                     LLAMA_NKV)):
        q6, kc6, vc6, b6, sm6 = cached_case(randn, Bq, C, base, pads, Nkv=Nkv)
        valid = torch.zeros(Bq, C, 1, 1, dtype=torch.bool, device="cuda")
        for b, p in enumerate(pads):
            valid[b, max(p - base, 0):] = True
        parts = ca.flash_split_parts(Bq, C, N, Nkv, SERVE_MAX_LEN, sms)
        err6 = compare("flash_attention_cached", f"{variant}, {parts} parts",
                       ca.flash_attention_cached(q6, kc6, vc6, b6, sm6, window=window),
                       ca.flash_attention_cached_plain(q6, kc6, vc6, b6, sm6, window=window), valid)
        if variant == "APC suffix":
            timed6 = (q6, kc6, vc6, b6, sm6, err6)
    # timing variants beside the kernels line's row, with the host's parts: the
    # short suffix, a serve-paged prefix-cache hit (a 100-row suffix over the
    # 256-token shared prefix) and a chunk256 first chunk (a 456-token prompt:
    # 56 left pads at base 0); and the split's other choices, forced (1: no
    # split, two warpgroups a block)
    for variant, C, base, pad, forced in (("short suffix C=48 base 960", 48, 960, 0, (None, 1, 2, 8)),
                                          ("serve-paged suffix C=100 base 256", 100, 256, 0, (None, 1)),
                                          ("chunk256 first chunk, 56 pads", 256, 0, 56, (None,)),
                                          ("APC suffix C=256 base 768", 256, 768, 0, (2,))):
        q7, kc7, vc7, b7, sm7 = cached_case(randn, 1, C, base, [pad])
        qpos = base + torch.arange(C, device="cuda")
        slots = torch.arange(SERVE_MAX_LEN, device="cuda")[None, :]
        cmask7 = ((slots <= qpos[:, None]) & sm7[0][None, :])[None, None]
        keys7 = sum(max(base + t + 1 - pad, 0) for t in range(C))
        rows7 = C - max(pad - base, 0)  # chunk rows at valid slots: the q the function reads
        q7t = q7.transpose(1, 2)
        for parts in forced:
            TIME_VARIANTS.append(dict(
                kernel_name="flash_attention_cached",
                variant=variant + ("" if parts is None else f", {parts} parts forced"),
                parts=parts or ca.flash_split_parts(1, C, N, N, SERVE_MAX_LEN, sms),
                kernel=split_forced(ca, parts, lambda a=(q7, kc7, vc7, b7, sm7): ca.flash_attention_cached(*a)),
                library=None if parts else (
                    lambda a=(q7t, kc7, vc7, cmask7): F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])),
                bound=bound(2 * N * (base + C - pad) * D * 2 + rows7 * N * D * 2 + q7.numel() * 2 + sm7.numel() + 4,
                            4 * D * N * keys7)))
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
        # every slot of the plane and every chunk row is valid here
        bound=bound(2 * kc6.numel() * 2 + 2 * q6.numel() * 2 + sm6.numel() + 4, 4 * D * N * keys6),
    )
    return rows


VERIFY_BASES = np.linspace(256, 300, B).astype(int).tolist()  # per-row bases after uneven acceptance


def verify_kernel_checks(ca, randn) -> None:
    """The speculative verify's two shapes, against the plain versions and as
    timing variants beside SDPA over the same keys: B6 over 16 rows of a C =
    k + 1 = 5 chunk at per-row bases 256-300 of a 384-slot plane (the slab
    and tiered verify of the speculative cells; left pads PADS), and B5 at C
    = 5, G = 1 over the pages of rows with as many real tokens, the chunk
    merged causally (serve-paged-spec4's verify)."""
    import torch.nn.functional as F
    from lia_tpu_torch.engine.lookahead import spec_slots

    C, S_max = SPEC_K + 1, spec_slots(PROMPT, NEW_TOKENS, SPEC_K + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q = randn(B, C, N, D)
    kc, vc = randn(B, N, S_max, D), randn(B, N, S_max, D)
    sm = torch.zeros(B, S_max, dtype=torch.bool, device="cuda")
    for b, (p, base) in enumerate(zip(PADS, VERIFY_BASES)):
        sm[b, p : base + C] = True
    bases = torch.tensor(VERIFY_BASES, dtype=torch.int32, device="cuda")
    out, ref = ca.flash_attention_cached(q, kc, vc, bases, sm), ca.flash_attention_cached_plain(q, kc, vc, bases, sm)
    err = (out.float() - ref.float()).abs().max().item()
    emit({"phase": "kernel_check", "kernel": "flash_attention_cached", "variant": "verify C=5, bases 256-300",
          "max_abs_err": err, "tol": KERNEL_TOL})
    check(err <= KERNEL_TOL, f"flash_attention_cached verify shape: max abs err {err} > {KERNEL_TOL}")
    qpos = bases[:, None] + torch.arange(C, device="cuda")[None, :]  # [B, C]
    cmask = ((torch.arange(S_max, device="cuda")[None, None, :] <= qpos[:, :, None]) & sm[:, None, :])[:, None]
    keys = sum(base + t + 1 - p for p, base in zip(PADS, VERIFY_BASES) for t in range(C))
    valid = sum(base + C - p for p, base in zip(PADS, VERIFY_BASES))
    TIME_VARIANTS.append(dict(
        kernel_name="flash_attention_cached", variant="verify C=5 (16 rows, bases 256-300)",
        parts=ca.flash_split_parts(B, C, N, N, S_max, sms),
        kernel=lambda a=(q, kc, vc, bases, sm): ca.flash_attention_cached(*a),
        library=lambda a=(q.transpose(1, 2), kc, vc, cmask): F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]),
        bound=bound(2 * valid * N * D * 2 + 2 * q.numel() * 2 + sm.numel() + B * 4, 4 * D * N * keys)))

    lengths = [base - p for p, base in zip(PADS, VERIFY_BASES)]  # each row's real tokens
    P = -(-(max(lengths) + C) // SERVE_BLOCK)
    pq, kp, vp, table, lens, kf, vf = paged_case(randn, lengths, C, N, 1, D, P=P, L=1)
    args = (pq, kp, vp, 0, table, lens, kf, vf)
    out, ref = ca.paged_decode_attention(*args), ca.paged_decode_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    emit({"phase": "kernel_check", "kernel": "paged_decode_attention", "variant": "verify C=5, G=1",
          "max_abs_err": err, "tol": KERNEL_TOL})
    check(err <= KERNEL_TOL, f"paged_decode_attention verify shape: max abs err {err} > {KERNEL_TOL}")
    # SDPA's side: the pages gathered into a plane with the chunk written at
    # [length, length + C), causal over it (the gather is not timed)
    S = P * SERVE_BLOCK
    kg = kp[0][table.long()].permute(0, 2, 1, 3, 4).reshape(B, N, S, D)
    vg = vp[0][table.long()].permute(0, 2, 1, 3, 4).reshape(B, N, S, D)
    for b, n in enumerate(lengths):
        kg[b, :, n : n + C] = kf[b]
        vg[b, :, n : n + C] = vf[b]
    kpos = lens[:, None].long() + torch.arange(C, device="cuda")[None, :]
    gmask = (torch.arange(S, device="cuda")[None, None, :] <= kpos[:, :, None])[:, None]
    pkeys = sum(n + t + 1 for n in lengths for t in range(C))
    TIME_VARIANTS.append(dict(
        kernel_name="paged_decode_attention", variant="verify C=5, G=1 (16 rows of 256-300 tokens less pads)",
        parts=ca.paged_split_parts(B, C, N, N, P, sms),
        kernel=lambda a=args: ca.paged_decode_attention(*a),
        library=lambda a=(pq.transpose(1, 2), kg, vg, gmask): F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]),
        bound=bound((sum(lengths) + B * C) * N * D * 2 * 2 + 2 * pq.numel() * 2 + table.numel() * 4 + B * 4,
                    4 * D * N * pkeys)))


def beam_case(ca, quantize_kv, randn, int8: bool, Nkv: int = N, Dh: int = D, tlen: int = BEAM_TLEN, L: int = 2,
              S_p: int = BEAM_PROMPT):
    """Grouped-beam kernel inputs at the beam path's shapes (OPT-6.7B heads,
    BEAM_GROUPS groups of BEAM_NB beams over an ``S_p``-slot prompt with the
    groups' left pads BEAM_PADS, ``tlen`` tail slots of a 32-slot bf16 or
    128-slot int8 tail), over layer 1 of a 2-layer cache: (kernel, plain
    version, args, prompt keys per group)."""
    B = BEAM_GROUPS * BEAM_NB
    q = randn(B, 1, N, Dh)
    kf, vf = randn(B, Nkv, 1, Dh), randn(B, Nkv, 1, Dh)
    pm = torch.zeros(BEAM_GROUPS, S_p, dtype=torch.bool, device="cuda")
    for g, p in enumerate(BEAM_PADS):
        pm[g, p:] = True
    lens = (pm, torch.tensor(S_p, dtype=torch.int32, device="cuda"),
            torch.tensor(tlen, dtype=torch.int32, device="cuda"), BEAM_NB)
    T_max = 128 if int8 else 32
    if int8:
        planes = [x for rows, S in ((BEAM_GROUPS, S_p), (B, T_max)) for _ in range(2)
                  for x in quantize_kv(randn(L, rows, Nkv, S, Dh, dtype=torch.float32))]
        return ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain, (q, kf, vf, *planes, 1, *lens)
    planes = [randn(L, rows, Nkv, S, Dh) for rows, S in ((BEAM_GROUPS, S_p), (B, T_max)) for _ in range(2)]
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
    for int8, name, source, replaces in ((False, "decode_beam_attention", "lia_tpu_torch/csrc/beam_attn.cuh",
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
    beam_bf16_checks(ca, quantize_kv, check_randn("beam_bf16_checks"))
    return rows


def beam_bf16_checks(ca, quantize_kv, randn):
    """B9's bf16 body against its plain version with the host's parts and
    forced to 1 and 3: the kernels line's case, tails of 0 and 32 (T_max),
    Llama-3-8B's heads (G = 4: a group's 16 queries in one block), G = 8 (32
    queries a group: two blocks of 2 beams), D = 64 and a 1024-slot prompt.
    Then its timing variants beside the kernels line's case, with the host's
    parts: Llama-3-8B's heads, D = 64, tail 0, a 1024-slot prompt, and Llama's
    heads over it, each beside SDPA over each beam's [prompt | tail | fresh]
    view (K/V repeated to the query heads at G = 4; neither timed); and each
    split shape (4 x 4 beams over either prompt at either heads) with the split
    forced the other way."""
    import torch.nn.functional as F

    for label, kw in (("4 x 4 beams", {}), ("tail 0", dict(tlen=0)), ("tail 32", dict(tlen=32)),
                      ("llama heads G=4, 16 queries a block", dict(Nkv=N // 4)),
                      ("G=8, 32 queries a group", dict(Nkv=N // 8)), ("D=64", dict(Dh=64)),
                      ("prompt 1024", dict(S_p=1024))):
        _, plain, args = beam_case(ca, quantize_kv, randn, False, **kw)
        ref = plain(*args)
        for parts in (None, 1, 3):
            out = split_forced(ca, parts, lambda a=args: ca.decode_beam_attention(*a), "beam_plan")()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            emit({"phase": "kernel_check", "kernel": "decode_beam_attention", "variant": f"{label}, parts {parts or 'host'}",
                  "max_abs_err": err, "tol": KERNEL_TOL})
            check(bool(torch.isfinite(out).all()) and err <= KERNEL_TOL,
                  f"decode_beam_attention {label}, parts {parts}: max abs err {err}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (label, beam_case arguments, whether the split is timed both ways)
    for label, kw, both in (("opt-6.7b heads, 256-slot prompt", {}, True),
                            ("llama-3-8b heads G=4 (N_kv 8), 256-slot prompt", dict(Nkv=N // 4), True),
                            ("D=64, 256-slot prompt", dict(Dh=64), False), ("tail 0, 256-slot prompt", dict(tlen=0), False),
                            ("opt-6.7b heads, 1024-slot prompt", dict(S_p=1024), True),
                            ("llama-3-8b heads G=4 (N_kv 8), 1024-slot prompt", dict(Nkv=N // 4, S_p=1024), True)):
        _, _, args = beam_case(ca, quantize_kv, randn, False, **kw)  # layer 1 of 2
        q, kf, vf, kp, vp, kt, vt = (x if i < 3 else x[1] for i, x in enumerate(args[:7]))
        Bq, Nkv, S_p, Dh = q.shape[0], kf.shape[1], kp.shape[2], q.shape[3]
        G, tlen = N // Nkv, kw.get("tlen", BEAM_TLEN)
        group = torch.arange(Bq, device="cuda") // BEAM_NB
        k_all = torch.cat([kp[group], kt, kf], dim=2).repeat_interleave(G, 1)
        v_all = torch.cat([vp[group], vt, vf], dim=2).repeat_interleave(G, 1)
        pm = args[-4]
        tail_ok = (torch.arange(kt.shape[2], device="cuda") < tlen)[None].expand(Bq, kt.shape[2])
        amask = torch.cat([pm[group], tail_ok, torch.ones(Bq, 1, dtype=torch.bool, device="cuda")], 1)[:, None, None]
        prompt_keys = sum(S_p - p for p in BEAM_PADS)
        nbytes = ((prompt_keys + Bq * tlen) * Nkv * 2 * Dh * 2 + (2 * q.numel() + 2 * kf.numel()) * 2
                  + pm.numel() + 8)
        bpc, host = ca.beam_plan(Bq, BEAM_NB, N, Nkv, S_p, kt.shape[2], sms)
        # the host's choice, then (split shapes) the other side of the split; the
        # kernels line's row is the first's host choice
        for parts in ((1 if host > 1 else 2,) if not kw else (None, 1 if host > 1 else 2) if both else (None,)):
            TIME_VARIANTS.append(dict(
                kernel_name="decode_beam_attention",
                variant=f"4 x 4 beams, {label}, tail {tlen}, {bpc} beams a block"
                        + (f", {parts} part{'s' * (parts > 1)} forced" if parts else ""),
                parts=parts or host,
                kernel=split_forced(ca, parts, lambda a=args: ca.decode_beam_attention(*a), "beam_plan"),
                library=None if parts else (lambda a=(q.transpose(1, 2), k_all, v_all, amask):
                                            F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3])),
                bound=bound(nbytes, 4 * Dh * N * (BEAM_NB * prompt_keys + Bq * tlen + Bq))))


def int8_plane_case(randn, quantize_kv, rows, Nkv: int = N, G: int = 1, S_max: int = 384, L: int = 2):
    """B3's inputs over layer L - 1 of an S_max-slot int8 cache: rows (length,
    start) each valid on [start, length), G query heads a kv head."""
    Bq = len(rows)
    q, kf, vf = randn(Bq, 1, Nkv * G, D), randn(Bq, Nkv, 1, D), randn(Bq, Nkv, 1, D)
    kq = quantize_kv(randn(L, Bq, Nkv, S_max, D, dtype=torch.float32))
    vq = quantize_kv(randn(L, Bq, Nkv, S_max, D, dtype=torch.float32))
    sm = torch.zeros(Bq, S_max, dtype=torch.bool, device="cuda")
    for b, (n, s0) in enumerate(rows):
        sm[b, s0:n] = True
    lens = torch.tensor([n for n, _ in rows], dtype=torch.int32, device="cuda")
    return (q, kf, vf, kq.q, kq.s, vq.q, vq.s, L - 1, sm, lens)


def int8_decode_checks(ca, quantize_kv, randn):
    """B3 and B10 (the int8 decode body) against their plain versions at the
    split's shapes and edges, each with the host's parts and forced to 1 and
    3: rows of length 0, start = length, starts off a multiple of 4, a window
    of 64, and ~1000 tokens, at G = 1 and 4; the beam cache with its prompt /
    tail boundary inside a part, tail 0, Llama-3-8B's heads (two blocks of 2
    beams a group) and a 1024-slot prompt. Then the timing variants: B3 at
    Llama-3-8B's heads and over ~1000-token rows, B10 over a 1024-slot prompt,
    each with its parts, beside SDPA over its keys dequantized to bf16 (K/V
    repeated to the query heads at G = 4; neither timed)."""
    import torch.nn.functional as F

    from lia_tpu_torch.ops.quant import QuantizedKV, dequantize_kv

    def compare(name, variant, fn, plain):
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        emit({"phase": "kernel_check", "kernel": name, "variant": variant, "max_abs_err": err, "tol": KERNEL_TOL})
        check(bool(torch.isfinite(out).all()) and err <= KERNEL_TOL, f"{name} {variant}: max abs err {err}")

    edge_rows = [(0, 0), (19, 19), (277, 3), (300, 236), (384, 0), (272, 5), (1, 0), (150, 149)] * 2
    for label, Nkv, G, rows, S_max in (("edges", N, 1, edge_rows, 384), ("edges G=4", N // 4, 4, edge_rows, 384),
                                       ("rows ~1000", N, 1, [(1000 - p, p) for p in (0, 3, 7, 15)] * 4, 1024),
                                       ("rows ~1000 G=4", N // 4, 4, [(1000 - p, p) for p in (0, 3, 7, 15)] * 4,
                                        1024)):
        args = int8_plane_case(randn, quantize_kv, rows, Nkv, G, S_max)
        for parts in (None, 1, 3):
            compare("decode_attention_fresh_int8", f"{label}, parts {parts or 'host'}",
                    split_forced(ca, parts, lambda a=args: ca.decode_attention_fresh_int8(*a), "int8_split_parts"),
                    lambda a=args: ca.decode_attention_fresh_int8_plain(*a))
    for label, kw in (("4 x 4 beams", {}), ("tail 0", dict(tlen=0)), ("tail 100", dict(tlen=100)),
                      ("llama heads G=4", dict(Nkv=N // 4)), ("prompt 1024", dict(S_p=1024))):
        _, _, args = beam_case(ca, quantize_kv, randn, True, **kw)
        for parts in (None, 1, 3):
            compare("decode_beam_attention_int8", f"{label}, parts {parts or 'host'}",
                    split_forced(ca, parts, lambda a=args: ca.decode_beam_attention_int8(*a), "int8_split_parts"),
                    lambda a=args: ca.decode_beam_attention_int8_plain(*a))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pads = [0, 3, 7, 15] * 4
    # the split forced where the host does not split (each part's start and
    # the merge launch against the extra blocks)
    g4 = int8_plane_case(randn, quantize_kv, [(PAST, p) for p in pads], N // 4, 4, 384, L=1)
    keys = sum(PAST - p for p in pads)
    TIME_VARIANTS.append(dict(
        kernel_name="decode_attention_fresh_int8", variant="llama-3-8b heads G=4, past 272 - pad, 4 parts forced",
        parts=4, kernel=split_forced(ca, 4, lambda a=g4: ca.decode_attention_fresh_int8(*a), "int8_split_parts"),
        library=None, bound=bound(keys * (N // 4) * (D + 4) * 2 + 2 * g4[0].numel() * 2 + 2 * g4[1].numel() * 2
                                  + g4[8].numel() + 4, 4 * D * N * (keys + B))))
    _, _, bargs = beam_case(ca, quantize_kv, randn, True)
    bkeys = sum(BEAM_PROMPT - p for p in BEAM_PADS)
    TIME_VARIANTS.append(dict(
        kernel_name="decode_beam_attention_int8", variant=f"4 x 4 beams, {BEAM_PROMPT}-slot prompt, 4 parts forced",
        parts=4, kernel=split_forced(ca, 4, lambda a=bargs: ca.decode_beam_attention_int8(*a), "int8_split_parts"),
        library=None, bound=bound((bkeys + B * BEAM_TLEN) * N * (D + 4) * 2 + 4 * bargs[0].numel() * 2
                                  + bargs[-4].numel() + 8, 4 * D * N * (BEAM_NB * bkeys + B * BEAM_TLEN + B))))
    for variant, Nkv, past, S_max in (("llama-3-8b heads G=4 (N_kv 8), past 272 - pad", N // 4, PAST, 384),
                                      ("past ~1000 (1000 - pad)", N, 1000, 1024),
                                      ("llama-3-8b heads G=4, past ~1000", N // 4, 1000, 1024),
                                      ("llama-3-8b heads G=4, past ~2000", N // 4, 2000, 2048)):
        G = N // Nkv
        args = int8_plane_case(randn, quantize_kv, [(past, p) for p in pads], Nkv, G, S_max, L=1)
        q, kf, vf, kq, ks, vq, vs, li, sm, lens = args
        kd, vd = (dequantize_kv(QuantizedKV(c[li], sc[li])) for c, sc in ((kq, ks), (vq, vs)))
        kd[:, :, past], vd[:, :, past] = kf[:, :, 0], vf[:, :, 0]
        kd, vd = kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)
        amask = sm.clone()
        amask[:, past] = True
        keys = sum(past - p for p in pads)
        host = ca.int8_decode_parts(B, N, Nkv, S_max, sms)
        # over ~1000 keys and more also the other side of the split: 1 part
        # where the host splits, 2 where it does not
        for parts in (None, 1 if host > 1 else 2) if S_max > 1000 else (None,):
            TIME_VARIANTS.append(dict(
                kernel_name="decode_attention_fresh_int8",
                variant=variant + (f", {parts} part{'s' * (parts > 1)} forced" if parts else ""),
                parts=parts or host,
                kernel=split_forced(ca, parts, lambda a=args: ca.decode_attention_fresh_int8(*a), "int8_split_parts"),
                library=lambda a=(q.transpose(1, 2), kd, vd, amask[:, None, None, :]):
                    F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3]),
                bound=bound(keys * Nkv * (D + 4) * 2 + 2 * q.numel() * 2 + 2 * kf.numel() * 2 + sm.numel() + 4,
                            4 * D * N * (keys + B))))

    def beam_bound(args, S_p, Nkv, prompt_reads=1):
        """B10's bound over ``args``: each group's prompt read ``prompt_reads``
        times, each beam's tail once."""
        q, kf, pm = args[0], args[1], args[-4]
        prompt_keys = sum(S_p - p for p in BEAM_PADS)
        return bound((prompt_reads * prompt_keys + q.shape[0] * BEAM_TLEN) * Nkv * (D + 4) * 2
                     + (2 * q.numel() + 2 * kf.numel()) * 2 + pm.numel() + 8,
                     4 * D * N * (BEAM_NB * prompt_keys + q.shape[0] * BEAM_TLEN + q.shape[0]))

    S_p = 1024
    kernel, _, args = beam_case(ca, quantize_kv, randn, True, S_p=S_p)  # layer 1 of 2
    q, kf, vf = args[:3]
    Bq = q.shape[0]
    group = torch.arange(Bq, device="cuda") // BEAM_NB
    kp, vp, kt, vt = (dequantize_kv(QuantizedKV(c[1], sc[1])) for c, sc in zip(args[3:11:2], args[4:11:2]))
    k_all, v_all = torch.cat([kp[group], kt, kf], dim=2), torch.cat([vp[group], vt, vf], dim=2)
    pm = args[-4]
    tail_ok = (torch.arange(kt.shape[2], device="cuda") < BEAM_TLEN)[None].expand(Bq, kt.shape[2])
    amask = torch.cat([pm[group], tail_ok, torch.ones(Bq, 1, dtype=torch.bool, device="cuda")], 1)[:, None, None]
    host = ca.int8_beam_plan(Bq, BEAM_NB, N, N, S_p, kt.shape[2], sms)[1]
    for parts in (None, 1 if host > 1 else 2):  # the host's choice, then the other side of the split
        TIME_VARIANTS.append(dict(
            kernel_name="decode_beam_attention_int8",
            variant=f"4 x 4 beams, {S_p}-slot prompt, tail {BEAM_TLEN}"
                    + (f", {parts} part{'s' * (parts > 1)} forced" if parts else ""),
            parts=parts or host,
            kernel=split_forced(ca, parts, lambda: kernel(*args), "int8_split_parts"),
            library=lambda a=(q.transpose(1, 2), k_all, v_all, amask): F.scaled_dot_product_attention(
                a[0], a[1], a[2], attn_mask=a[3]),
            bound=beam_bound(args, S_p, N)))
    # Llama-3-8B's heads (G = 4): a block holds INT8_QUERIES queries, so two
    # blocks share a group's 16 and each reads its prompt; the bound counts the
    # prompt once, and ``bound_ms_prompt_per_block`` once a block of beams
    bpc, parts = ca.int8_beam_plan(Bq, BEAM_NB, N, N // 4, BEAM_PROMPT, kt.shape[2], sms)
    _, _, largs = beam_case(ca, quantize_kv, randn, True, Nkv=N // 4)
    TIME_VARIANTS.append(dict(
        kernel_name="decode_beam_attention_int8",
        variant=f"llama-3-8b heads G=4 (N_kv 8), 4 x 4 beams, {BEAM_PROMPT}-slot prompt, {bpc} beams a block",
        parts=parts, kernel=lambda: ca.decode_beam_attention_int8(*largs), library=None,
        bound=beam_bound(largs, BEAM_PROMPT, N // 4),
        extra={"bound_ms_prompt_per_block": beam_bound(largs, BEAM_PROMPT, N // 4, -(-BEAM_NB // bpc))[0]}))


def int4pack_call(codes, s, z=None):
    """``torch._weight_int4pack_mm`` over the same 4-bit codes (``[K, N]``,
    0..15) and g128 scales, its weight packed here, before any timing: the
    function of ``woq_matmul`` int4 (and, with zero-points ``z``, of
    ``woq4z_matmul``) up to its bf16 scales, zeros and output, as tinygemm
    dequantizes ``(c - 8) * s + zero``; None where this PyTorch has no such
    call."""
    try:
        wt = codes.t().contiguous().to(torch.int32)
        wp = torch._convert_weight_to_int4pack((wt[:, ::2] << 4 | wt[:, 1::2]).to(torch.uint8), 8)
        zero = torch.zeros_like(s) if z is None else (8.0 - z) * s
        sz = torch.stack([s, zero], dim=-1).to(torch.bfloat16).contiguous()
    except (AttributeError, RuntimeError):
        return None
    return lambda x: torch._weight_int4pack_mm(x, wp, GROUP, sz)


def int8pack_call(codes, s):
    """``torch._weight_int8pack_mm`` over the same int8 codes (``[K, N]``) and
    per-channel scales (``[1, N]``), its weight laid out ``[N, K]`` here,
    before any timing: the function of ``woq_matmul`` int8 per-channel (the
    integer codes summed exactly, the scale after the sum) up to its bf16
    scales and output; None where this PyTorch has no such call on the card."""
    try:
        w = codes.t().contiguous()
        sc = s[0].to(torch.bfloat16).contiguous()
        torch._weight_int8pack_mm(torch.zeros(1, w.shape[1], dtype=torch.bfloat16, device=w.device), w, sc)
    except (AttributeError, RuntimeError):
        return None
    return lambda x: torch._weight_int8pack_mm(x, w, sc)


def matmul_cases(cm, quantize_act):
    """The quantized-matmul kernel cases, one shape at a time (each yields its
    inputs, made from a seeded generator, so the timing phase makes the same
    ones anew): kernel, plain version, yardsticks and bound. ``library`` is a
    PyTorch call of the same function: ``torch._weight_int4pack_mm`` for the
    int4 weight-only kinds and ``torch._weight_int8pack_mm`` for per-channel
    int8 (bf16 scales); no single call computes W4A8 or NF4 here. ``split``
    (fc2 at 16 rows, where the plan splits the weight rows 11 ways) is the
    split's plain version, :func:`cuda_matmul.split_plain`, at the plan's
    slices. ``other`` is a call of another function that
    reads more bytes: ``torch._int_mm`` over the unpacked int8 codes (no group
    scales; twice the packed bytes, column-major; its 16 decode rows padded to
    32, the least it takes) for W4A8, ``torch.mm`` over the weight
    dequantized to bf16 (2x int8, 4x int4) for the weight-only kinds. None
    of them is on the port's path."""
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
        codes = unpack_nibbles(packed)
        # the other-function yardstick's operand, column-major: _int_mm's fast layout
        codes8 = (codes - 8).to(torch.int8).t().contiguous().t()
        i8 = randint(-127, 128, K, N, dtype=torch.int8)
        s, s1 = scales(ng, N), scales(1, N)
        z = randint(0, 16, ng, N, dtype=torch.float32)
        deq = {kind: dequantize(QuantizedWeight(q, sc, fmt, zz), torch.bfloat16) for kind, (q, sc, fmt, zz) in {
            "int8": (i8, s1, "woq_int8", None), "int4": (packed, s, "woq_int4", None),
            "nf4": (packed, s, "woq_nf4", None), "int4z": (packed, s, "woq_int4z", z)}.items()}
        same = {"int4": int4pack_call(codes, s), "int4z": int4pack_call(codes, s, z),
                "int8": int8pack_call(i8, s1)}
        for M in MATMUL_M:
            x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
            xq, sx = quantize_act(x)
            xq_pad = torch.cat([xq, xq.new_zeros(max(0, 32 - M), K)])
            io = 4 * M * N  # f32 output

            def split(fn, a, q, sc, zz, fmt):
                if (shape, M) != ("fc2", 16):
                    return None
                rows = cm.plan(M, N, K, sc.shape[0], fmt, zz is not None).split_rows
                return lambda: cm.split_plain(fn, a, q, sc, zz, split_rows=rows, packed=fmt != "int8")

            def w4a8(zz):
                nbytes = M * K + 4 * M + K * N // 2 + 4 * ng * N * (1 if zz is None else 2) + io
                return dict(kernel=lambda: cm.w4a8_matmul(xq, sx, packed, s, zz),
                            plain=lambda: cm.w4a8_matmul_plain(xq, sx, packed, s, zz),
                            split=split(lambda a, qq, ss, zs: cm.w4a8_matmul_plain(a, sx, qq, ss, zs), xq, packed, s,
                                        zz, "w4a8"),
                            library=None, other=lambda: torch._int_mm(xq_pad, codes8),
                            bound=bound(nbytes, 2 * M * K * N, PEAK_INT8_OP_PER_S))

            def woq(kind, q, sc, zz=None):
                nbytes = 2 * M * K + q.numel() + 4 * sc.numel() * (1 if zz is None else 2) + io
                if zz is None:
                    k, p = (lambda: cm.woq_matmul(x, q, sc, kind)), (lambda: cm.woq_matmul_plain(x, q, sc, kind))
                    fn = lambda a, qq, ss, zs: cm.woq_matmul_plain(a, qq, ss, kind)  # noqa: E731
                else:
                    k, p = (lambda: cm.woq4z_matmul(x, q, sc, zz)), (lambda: cm.woq4z_matmul_plain(x, q, sc, zz))
                    fn = cm.woq4z_matmul_plain
                w, lib = deq[kind], same.get(kind)
                return dict(kernel=k, plain=p, split=split(fn, x, q, sc, zz, kind),
                            library=None if lib is None else (lambda: lib(x)),
                            other=lambda: torch.mm(x, w, out_dtype=torch.float32), bound=bound(nbytes, 2 * M * K * N))

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


# The Hopper body's tile edges: (M, K, N, group size or -1 for per-channel).
# Decode takes M <= 16 and prefill 128-row blocks; blocks take 128 weight
# columns, whose rows TMA reads where N is a multiple of 16 (40, 200 and 4100
# are copied by the kernel's warps); K 16384 splits at decode in whole groups
# (and per-channel in walk units); 50304 is OPT's head.
MATMUL_EDGES = [(1, 4096, 40, 128), (16, 4096, 200, 128), (17, 1024, 4100, 128), (64, 16384, 4096, 128),
                (65, 4096, 200, -1), (128, 4096, 50304, 128), (4096, 1024, 4100, 64), (16, 16384, 4096, -1)]


def matmul_edge_checks(cm, quantize_act) -> None:
    """Every quantized-matmul kind (W4A8 with and without zero-points, int8
    per-channel, int4, NF4, int4 with zero-points) against its plain version
    at the tile edges of MATMUL_EDGES."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for M, K, N, gs in MATMUL_EDGES:
        ng = 1 if gs < 0 else K // gs
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        xq, sx = quantize_act(x)
        packed = torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.uint8)
        i8 = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
        s = torch.rand(ng, N, generator=gen, device="cuda") * 1e-3 + 1e-3
        s1 = s[:1].contiguous()
        z = torch.randint(0, 16, (ng, N), generator=gen, device="cuda").float()
        for name, variant, kernel, plain in (
            ("w4a8_matmul", "", lambda: cm.w4a8_matmul(xq, sx, packed, s), lambda: cm.w4a8_matmul_plain(xq, sx, packed, s)),
            ("w4a8_matmul", "zero-points", lambda: cm.w4a8_matmul(xq, sx, packed, s, z),
             lambda: cm.w4a8_matmul_plain(xq, sx, packed, s, z)),
            ("woq_matmul", "int8 per-channel", lambda: cm.woq_matmul(x, i8, s1, "int8"),
             lambda: cm.woq_matmul_plain(x, i8, s1, "int8")),
            ("woq_matmul", "int4", lambda: cm.woq_matmul(x, packed, s, "int4"),
             lambda: cm.woq_matmul_plain(x, packed, s, "int4")),
            ("woq_matmul", "nf4", lambda: cm.woq_matmul(x, packed, s, "nf4"),
             lambda: cm.woq_matmul_plain(x, packed, s, "nf4")),
            ("woq4z_matmul", "", lambda: cm.woq4z_matmul(x, packed, s, z), lambda: cm.woq4z_matmul_plain(x, packed, s, z)),
        ):
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name} {variant} M={M} K={K} N={N}: non-finite output")
            abs_err = (out - ref).abs().max().item()
            rel = abs_err / max(ref.abs().max().item(), 1e-30)
            variant = f"{variant} {'per-channel' if gs < 0 else f'g{gs}'} edge".strip()
            emit({"phase": "kernel_check", "kernel": name, "variant": variant, "M": M, "K": K, "N": N,
                  "max_abs_err": abs_err, "rel_err": rel, "tol": MATMUL_TOL})
            check(rel <= MATMUL_TOL, f"{name} {variant} M={M} K={K} N={N}: relative error {rel} > {MATMUL_TOL}")
            del out, ref


STACK_LAYERS = 3  # B13's checks: a stack of this many layers, each layer read in turn


def stacked_cases(cm, quantize_act):
    """B13 (the stacked W4A8 entry) over a 3-layer stack at OPT-6.7B's wqkv,
    fc2 and head, M = 16 and 4096, with and without zero-points; the layer index lives
    in device memory. Each case checks every layer bit for bit against B4 on
    the layer's view (``b4_equal``) and times layer 1 against the plain
    version and the other-function yardstick (``torch._int_mm`` over the
    layer's unpacked codes, as B4's row)."""
    from lia_tpu_torch.ops.quant import unpack_nibbles

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    L, li = STACK_LAYERS, 1
    layers = torch.arange(L, dtype=torch.int32, device="cuda")
    for shape in ("wqkv", "fc2", "head"):
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
                           library=None, other=lambda xq_pad=xq_pad: torch._int_mm(xq_pad, codes8),
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
        if c.get("split"):  # the split call against the split's plain version at the plan's slices
            sref = c["split"]()
            line["split_rel_err"] = (out - sref).abs().max().item() / max(sref.abs().max().item(), 1e-30)
            check(line["split_rel_err"] <= MATMUL_TOL, f"{c['name']} {c['variant']} M={c['M']} K={c['K']}: split "
                                                       f"relative error {line['split_rel_err']} > {MATMUL_TOL}")
            del sref
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
    """Device times of every quantized-matmul case (kernel, plain version, the
    same-function library call where there is one, the other-function call)
    beside its bound, and of the stacked entry at the wqkv shape (its other
    cases run B4's body at the same shapes); the representative cases fill
    the kernels line."""
    stacked = (c for c in stacked_cases(cm, quantize_act) if c["shape"] == "wqkv" and c["variant"] == "g128")
    for c in itertools.chain(matmul_cases(cm, quantize_act), stacked):
        t = dict(ms=kernel_trace(c["name"], c["kernel"])[0], event_ms=event_ms(c["kernel"]),
                 host_us=host_us(c["kernel"]),
                 plain_ms=device_ms(c["plain"]), library_ms=c["library"] and device_ms(c["library"]),
                 other_function_ms=device_ms(c["other"]), bound_ms=c["bound"][0], bound_by=c["bound"][1])
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


def kernel_times(ca, rows) -> None:
    """Device times of each kernel, its plain version and the library call, and
    the wrapper's host time. Runs last: a profiler session leaves the process's
    launches slower (measured on the card: eager decode loses ~40% after one).
    The kernel's time is its checked trace's (kernel_trace); the events' time
    beside it is a cross-check that includes the host's gaps."""
    for name, r in rows.items():
        r["ms"], traced = kernel_trace(name, r["kernel"], own_launches(ca, r["kernel"]))
        r["event_ms"] = event_ms(r["kernel"])
        r["host_us"] = host_us(r["kernel"])
        r["plain_ms"] = device_ms(r["plain"])
        lib = dict(library_ms=None, library_timed_by=None)
        if r["library"]:
            # both readings, with the kernels the trace held per call: a trace
            # that misses kernels (none at all where a library launches a CUDA
            # graph; the fused MLP's torch chain once read 0.039 ms against its
            # 0.105 ms bound) reads under the bound, and the events measure it
            prof_ms, lib_traced = device_trace(r["library"])
            ev_ms = event_ms(r["library"])
            below = prof_ms < r["bound"][0]
            lib = dict(library_ms=ev_ms if below else prof_ms, library_timed_by="events" if below else "profiler",
                       library_profiler_ms=prof_ms, library_event_ms=ev_ms, library_kernels_traced=lib_traced)
        r["library_ms"] = lib["library_ms"]
        emit({"phase": "kernel_time", "kernel": name, "ms": r["ms"], "kernels_traced": traced,
              "event_ms": r["event_ms"], "host_us": r["host_us"],
              "plain_ms": r["plain_ms"], **lib,
              "library_kind": r.get("library_kind", "one call"), "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    for v in TIME_VARIANTS:  # the kernels at their other shapes: kernel (both launches of a split) and library
        lib = {"library_ms": device_ms(v["library"]), "library_event_ms": event_ms(v["library"])} if v["library"] else {}
        ms, traced = kernel_trace(v["kernel_name"], v["kernel"], own_launches(ca, v["kernel"]))
        emit({"phase": "kernel_time", "kernel": v["kernel_name"], "variant": v["variant"], "parts": v["parts"],
              "ms": ms, "kernels_traced": traced, "event_ms": event_ms(v["kernel"]), **lib,
              "bound_ms": v["bound"][0], "bound_by": v["bound"][1], **v.get("extra", {})})


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
def plain_calls(*mods):
    """Calls of the plain versions (every ``*_plain`` function of ``mods``)
    with a CUDA tensor among their arguments for the duration, by name: a
    path on the card must run none (a wrapper takes its plain version only
    for a tensor on the CPU)."""
    calls, saved = {}, []
    for mod in mods:
        for name in dir(mod):
            fn = getattr(mod, name)
            if name.endswith("_plain") and callable(fn):
                def counted(*args, _fn=fn, _name=name, **kw):
                    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in (*args, *kw.values())):
                        calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*args, **kw)

                saved.append((mod, name, fn))
                setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
    No plain version may run on the card in that run (:func:`plain_calls`).
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
    from lia_tpu_torch.ops import cuda_mlp
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
            with plain_calls(ca, cm, cuda_mlp) as plain:
                res = engine.generate(prompts, gen, fused=True)
            launches[name] = launch_counts(ca, cm)
            check(launches[name] == want, f"{name}: launches {launches[name]} != expected {want}")
            check(not plain, f"{name}: plain versions ran on the card: {plain}")
            check(ca.split_counts()["flash_attention_prefill"] == 0, f"{name}: B1 split its walks at b16 s256")
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
            "launches": launches[name], "plain_calls_on_card": 0, "peak_mem_gb": peak[name] / 1e9,
        }
        for key, field, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                                  ("decode_tokens_per_s", "decode_tokens_per_s", 1.0),
                                  ("total_latency_s", "total_s", 1.0)):
            vals = [r[key] * scale for r in runs[name]]
            record[field], record[field + "_runs"] = statistics.median(vals), vals
        emit(record)
        out[name] = (launches[name], record["total_s"])
        MEASURED[name] = dict(cfg=cfg, kv=kv, gate=gate, runtime=runtime or {}, batch=len(prompts),
                              prompt=len(prompts[0]), decode_tokens_per_s=record["decode_tokens_per_s"])
    del engine, cache, logits, logits2
    torch.cuda.empty_cache()
    return out


MEASURED = {}  # each main_path cell's config and median decode rate (the cost model's anchors)
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


def _gptq_pack(codes, zeros):
    """AutoGPTQ's packing: 8 codes per int32 along K, zero - 1 along N."""
    qweight = np.zeros((codes.shape[0] // 8, codes.shape[1]), np.uint32)
    qzeros = np.zeros((zeros.shape[0], zeros.shape[1] // 8), np.uint32)
    for i in range(8):
        qweight |= codes[i::8].astype(np.uint32) << (4 * i)
        qzeros |= (zeros[:, i::8] - 1).astype(np.uint32) << (4 * i)
    return qweight.view(np.int32), qzeros.view(np.int32)


def _gptq_linear(sd, rng, prefix: str, K: int, N: int) -> None:
    """One linear in AutoGPTQ form under ``prefix``: random codes and
    zero-points in g = GROUP, trivial g_idx, scales of 0.006/4.3205 (weights of
    about the fp dummy's spread)."""
    codes = rng.integers(0, 16, (K, N), dtype=np.uint8)
    zeros = rng.integers(1, 16, (K // GROUP, N), dtype=np.uint8)
    sd[prefix + ".qweight"], sd[prefix + ".qzeros"] = _gptq_pack(codes, zeros)
    sd[prefix + ".scales"] = np.full((K // GROUP, N), 0.006 / 4.3205, np.float16)
    sd[prefix + ".g_idx"] = (np.arange(K) // GROUP).astype(np.int32)


def gptq_params(cfg, seed: int):
    """An OPT tree from a synthesized AutoGPTQ state dict (numpy): random
    codes, zero-points and scales in GPTQ's packing (g = 128, trivial g_idx),
    the rest random fp, through ``params_from_gptq_state_dict`` (lossless
    woq_int4z records)."""
    from lia_tpu_torch.utils.gptq import params_from_gptq_state_dict

    rng = np.random.default_rng(seed)
    H, F, V = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size

    def r(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.006).astype(np.float32)

    pre = "model.decoder."
    sd = {pre + "embed_tokens.weight": r(V, H), pre + "embed_positions.weight": r(cfg.max_position_embeddings + 2, H),
          pre + "final_layer_norm.weight": np.ones(H, np.float32), pre + "final_layer_norm.bias": np.zeros(H, np.float32)}
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        for name, (K, N) in (("self_attn.q_proj", (H, H)), ("self_attn.k_proj", (H, H)),
                             ("self_attn.v_proj", (H, H)), ("self_attn.out_proj", (H, H)),
                             ("fc1", (H, F)), ("fc2", (F, H))):
            _gptq_linear(sd, rng, lp + name, K, N)
            sd[lp + name + ".bias"] = np.zeros(N, np.float32)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[lp + ln + ".weight"], sd[lp + ln + ".bias"] = np.ones(H, np.float32), np.zeros(H, np.float32)
    return params_from_gptq_state_dict(cfg, sd, group_size=GROUP)


def gptq_llama_params(cfg, seed: int):
    """A llama-layout tree from a synthesized AutoGPTQ state dict in the
    ``model.layers.*`` names (q/k/v, o, up, gate and down projections in
    GPTQ form, g = 128, trivial g_idx; fp embeddings, norms and an untied
    head), through ``params_from_gptq_state_dict``: every projection a
    lossless woq_int4z record."""
    from lia_tpu_torch.utils.gptq import params_from_gptq_state_dict

    rng = np.random.default_rng(seed)
    H, F, V = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    QD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    sd = {"model.embed_tokens.weight": (rng.standard_normal((V, H), dtype=np.float32) * 0.006),
          "lm_head.weight": (rng.standard_normal((V, H), dtype=np.float32) * 0.006),
          "model.norm.weight": np.ones(H, np.float32)}
    for i in range(cfg.num_layers):
        lp = f"model.layers.{i}."
        for name, (K, N) in (("self_attn.q_proj", (H, QD)), ("self_attn.k_proj", (H, KD)),
                             ("self_attn.v_proj", (H, KD)), ("self_attn.o_proj", (QD, H)),
                             ("mlp.gate_proj", (H, F)), ("mlp.up_proj", (H, F)), ("mlp.down_proj", (F, H))):
            _gptq_linear(sd, rng, lp + name, K, N)
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[lp + ln + ".weight"] = np.ones(H, np.float32)
    tree = params_from_gptq_state_dict(cfg, sd, group_size=GROUP)
    fmts = {w.fmt for g in ("attn", "mlp") for w in tree["layers"][g].values()}
    check(fmts == {"woq_int4z"}, f"{cfg.name} GPTQ: projections in {fmts}, not all woq_int4z")
    return tree


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

    H2D.update({"bytes": nbytes,
                "h2d_pinned_gb_s": gbps(lambda: dev.copy_(pinned, non_blocking=True)),
                "h2d_pageable_gb_s": gbps(lambda: dev.copy_(pageable)),
                "d2h_pinned_gb_s": gbps(lambda: pinned.copy_(dev, non_blocking=True)),
                "d2h_pageable_gb_s": gbps(lambda: pageable.copy_(dev))})
    emit({"phase": "h2d", **H2D})


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
    TIER_COPY_BYTES[name] = copies["bytes"] / passes
    med = {}
    for key, out_key, scale in (("first_token_latency_s", "prefill_ms", 1e3),
                                ("decode_tokens_per_s", "decode_tokens_per_s", 1.0)):
        vals = [r[key] * scale for r in runs]
        med[out_key], med[out_key + "_runs"] = statistics.median(vals), vals
    TIERED_MEASURED[name] = dict(cfg=cfg, n_res=wm.n_resident, kv=kv, policies=policies, batch=B,
                                 prompt=len(prompts[0]), decode_tokens_per_s=med["decode_tokens_per_s"])
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


def tier_model(name: str, cfg, tree):
    """(config, host tree) of a tiering configuration: full depth, or the
    first TIER_DEPTH[name] layers."""
    n = TIER_DEPTH.get(name)
    return (cfg, tree) if n is None else (cfg.replace(num_layers=n), first_layers(tree, n))


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


def copy_compute_split(name: str, config: str, run, passes) -> None:
    """Where the time of ``run()`` goes, under the profiler: device time in
    kernels (compute) and in copies (the weight stream, KV and activations
    crossing), host attention (policies 2/4: host clock around the host
    tier's attention calls), and the wall time, each also per pass
    (``passes()``, read after the run)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with host_attention_clock() as spent, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = passes()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    copy_s = sum(e.self_device_time_total for e in events if "Memcpy" in e.key) / 1e6
    compute_s = sum(e.self_device_time_total for e in events if "Memcpy" not in e.key) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": name, "config": config, "passes": n, "wall_s": wall, "device_compute_s": compute_s,
          "device_copy_s": copy_s, "host_attention_s": spent[0], "per_step_ms": {
              "wall": wall / n * 1e3, "compute": compute_s / n * 1e3, "copy": copy_s / n * 1e3,
              "host_attention": spent[0] / n * 1e3},
          "top": [{"kernel": _short(e.key), "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top]})
    check(n > 0 and compute_s > 0, f"{name} {config}: no pass ran on the card")


def tiered_breakdown(name: str, engine, prompts) -> None:
    """:func:`copy_compute_split` of one tiered generate (NEW_TOKENS passes:
    the prompt and each decode step)."""
    from lia_tpu_torch.config import GenerationConfig

    copy_compute_split("tiered_breakdown", name,
                       lambda: engine.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS)), lambda: NEW_TOKENS)


def tiered_parity(model: str = "opt-6.7b", configs=TIER_PARITY, tree=None) -> None:
    """``model``'s width (OPT-6.7B by default) at 4 layers, half resident:
    prefill and 4 decode steps of the scheduler on the card (bf16, kernels,
    streamed weights) against the CPU (fp32, plain versions and the host
    tier's golden attention) over the same tree, for each of ``configs``
    (TIER_PARITY entries; int8 KV: the streamed layers dequantize each plane
    and run decode_attention on the card). ``tree``: the bf16 configs' (card,
    CPU fp32) pair, already made (:func:`parity_tree`)."""
    from lia_tpu_torch.config import QuantConfig, RuntimeConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.runtime.scheduler import StreamingScheduler
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config(model).replace(num_layers=4)
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
    for label, (p, d), kv, quant in configs:
        key = json.dumps(quant)
        if key not in trees and quant is None and tree is not None:
            trees.clear()
            trees[key] = tree
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
        emit({"phase": "parity", "config": label, "model": model, "layers": 4, "hbm_percentage": 50, "prefill_policy": p,
              "decode_policy": d, "kv": kv, "weights": (quant or {}).get("weight_dtype", "bf16"), "batch": 2,
              "prompt": 64, "decode_steps": 4, "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
              "tol": tol, "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
        check(bool(torch.isfinite(gpu).all()), f"parity {label}: non-finite logits on the card")
        check(err <= tol, f"parity {label}: max abs logit err {err} > {tol}")
    trees.clear()
    torch.cuda.empty_cache()


def tiered_phase(ca, cm, cfg, prompts):
    """The tiering configurations at OPT-6.7B full width (full depth, or the
    TIER_DEPTH cut): bf16 weights from one pinned host tree (h50-p3, h0-p3
    over int8 KV, h50-p0, h50-p0-p2 with 4 minibatches, and policy 1 at 2
    layers over 2 short prompts), then int8dyn weights (h50-p3 over int8 KV)
    against the resident engine on the same tree. Returns (launches by configuration, the bf16 host
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
        _, launches[name], engine = tiered_path(ca, cm, name, *tier_model(name, cfg, tree), prompts, kv, hbm,
                                                policies, nm, inflight, timed)
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
    cfg8 = cfg.replace(num_layers=TIER_DEPTH["tier-h50-p3-int8dyn"])
    tree8, make_s = host_tree(cfg8, qc)
    emit({"phase": "host_tree", "weights": "int8dyn", "gb": tree_bytes(tree8) / 1e9, "seconds": make_s})
    seqs, launches["tier-h50-p3-int8dyn"], engine = tiered_path(ca, cm, "tier-h50-p3-int8dyn", cfg8, tree8, prompts,
                                                               "int8", 50, (3, 3), 1, 2, timed=False)
    wm = engine.scheduler.wm
    streamed = wm.get_layer(cfg8.num_layers - 1)["attn"]["wqkv"].q
    check(streamed.stride(-2) == 1, f"int8dyn: streamed codes are not column-major (strides {streamed.stride()})")
    from lia_tpu_torch.ops import kv_cache as kvc

    tokens, mask = pack_prompts(prompts, 1)
    pos = torch.from_numpy(mask.sum(1).astype(np.int32)).cuda()
    with torch.inference_mode():
        tier_logits, state = engine.scheduler.prefill_pass(tokens, mask, 384)
        nxt = tier_logits.argmax(-1).to(torch.int32)
        tier_step, _ = engine.scheduler.decode_pass(nxt, pos, state)
    del engine, state
    resident = InferenceEngine(cfg8, tree8, RuntimeConfig(quant=QuantConfig(kv_cache_dtype="int8")))
    ref = resident.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS)).sequences
    with torch.inference_mode():
        cache = kvc.init_cache(cfg8, len(prompts), 384, torch.bfloat16, quantized=True, device="cuda")
        res_logits, cache = T.prefill(cfg8, resident.params, torch.from_numpy(tokens).cuda(),
                                      torch.from_numpy(mask).cuda(), cache)
        res_step, _ = T.decode_step(cfg8, resident.params, nxt[:, None], pos[:, None], cache)
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


def serving_expected(cfg, opts: dict, stats: dict, prompts, names, dcfg=None) -> dict:
    """Kernel launches of one serving run, from the batcher's own counters:
    every decode step runs one attention kernel per layer (the paged kernel
    over the pool, the fresh-merge kernel over the slab); with
    ``speculate_k`` every step is a verify instead, the paged kernel at k + 1
    queries over the pool or flash_attention_cached over the slab, and a
    draft (``dcfg``) adds its k + 1 fresh-merge decode steps per layer and a
    flash prefill per layer of each admission. Every admission runs one
    prefill attention per layer: flash_attention_cached per chunk of a
    chunked admission (prefill_chunk, no prefix cache: ceil(n / chunk) chunks)
    and per prefix-cache hit (one suffix chunk), flash_attention_prefill for
    every other admission. Nothing else launches (bf16 weights: cuBLAS)."""
    L, steps = cfg.num_layers, int(stats["decode_steps"])
    k = opts.get("speculate_k")
    out = {name: 0 for name in names}
    if k:
        out["paged_decode_attention" if opts.get("paged") else "flash_attention_cached"] = L * steps
        if dcfg is not None:
            out["decode_attention_fresh"] = dcfg.num_layers * (k + 1) * steps
            out["flash_attention_prefill"] = dcfg.num_layers * len(prompts)
    elif opts.get("paged"):
        out["paged_decode_attention"] = L * steps
    else:
        out["decode_attention_fresh_int8" if opts.get("kv_quantized") else "decode_attention_fresh"] = L * steps
    chunk = opts.get("prefill_chunk")
    hits = int(stats.get("prefix_hits", 0))
    if chunk:
        out["flash_attention_cached"] += L * sum(-(-len(p) // chunk) for p in prompts)
    else:
        out["flash_attention_cached"] += L * hits
        out["flash_attention_prefill"] += L * (len(prompts) - hits)
    return out


def serving_path(ca, cm, name: str, opts: dict, cfg, params, prompts, new_tokens, draft=None, runtime=None,
                 submit_kw=None):
    """One serving configuration: the requests through a fresh
    ContinuousBatcher (with ``draft``, a (config, params) draft model; with
    ``runtime``, over the tiered scheduler; with ``submit_kw``, each request's
    processors, the processors on), counters zeroed just before the run and
    read just after it and checked exactly, no plain version on the card,
    every request's length and vocabulary, and (paged) the pool's accounting
    at the end. Over the scheduler also one copy of each streamed layer a pass
    (each admission's prefill and each step stream every streamed layer
    once), the bytes, copy-stream ms and host attention ms a pass. Returns
    (launches, the batcher)."""
    import gc

    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.ops import cuda_mlp

    gc.collect()  # the HTTP handler class of serve_http holds the last batcher in a reference cycle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the weights, and the kernel checks' inputs
    t0 = time.perf_counter()
    cb = ContinuousBatcher(cfg, params, max_batch=SERVE_MAX_BATCH, max_len=SERVE_MAX_LEN,
                           gen=GenerationConfig(max_new_tokens=128), block_size=SERVE_BLOCK, draft=draft,
                           runtime=runtime, enable_processors=submit_kw is not None or None, **opts)
    init_s = time.perf_counter() - t0
    wm = cb.sched.wm if cb.sched is not None else None
    if wm is not None:
        check(all(t.is_pinned() for t in wm._packed), f"{name}: a streamed layer is not in pinned memory")
        wm.copy_stats()
    reset_counts(ca, cm)
    with plain_calls(ca, cm, cuda_mlp) as plain, host_attention_clock() as host_attn:
        t0 = time.perf_counter()
        ids = [cb.submit(p, max_new_tokens=n, **kw)
               for p, n, kw in zip(prompts, new_tokens, submit_kw or [{}] * len(prompts))]
        done = {r.req_id: r.output for r in cb.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts(ca, cm)
    splits = ca.split_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = cb.stats()
    check(not plain, f"{name}: plain versions ran on the card: {plain}")
    check(sorted(done) == sorted(ids), f"{name}: {len(done)} of {len(ids)} requests finished")
    for i, n in zip(ids, new_tokens):
        out = done[i]
        check(len(out) == n, f"{name}: request {i} returned {len(out)} tokens, asked for {n}")
        check(all(0 <= t < cfg.vocab_size for t in out), f"{name}: request {i}: a token outside the vocabulary")
    if cb.paged:
        check(bool((cb.page_rc == 0).all()), f"{name}: nonzero page refcounts after the run")
        n_back = len(cb.free_blocks) + len(cb.cached_pages)
        check(n_back == cb.num_blocks - 1, f"{name}: {n_back} pages back of {cb.num_blocks - 1}")
    if wm is not None:
        expected = serving_tier_expected(cfg, cb, stats, len(prompts), launches)
    else:
        expected = serving_expected(cfg, opts, stats, prompts, launches, None if draft is None else draft[0])
    check(launches == expected, f"{name}: launches {launches} != expected {expected}")
    if name == "serve-paged":
        check(stats["prefix_hits"] >= 1, f"{name}: no prefix-cache hit")
    keys = ("tokens_per_s", "p50_ttft_s", "p90_ttft_s", "p99_ttft_s", "p50_tpot_s", "p90_tpot_s", "p99_tpot_s",
            "decode_steps", "decode_dispatches", "steps_per_dispatch", "prefix_hits", "prefix_tokens_reused")
    record = {"phase": "serving" if wm is None else "serving_tiered", "config": name, "model": cfg.name,
              "layers": cfg.num_layers, **opts, "draft": None if draft is None else draft[0].name,
              "requests": len(prompts), "max_batch": SERVE_MAX_BATCH, "max_len": SERVE_MAX_LEN,
              "block_size": SERVE_BLOCK, "prompt_tokens": sum(len(p) for p in prompts), "new_tokens": sum(new_tokens),
              **{k: stats[k] for k in keys if k in stats}, "wall_s": wall, "init_s": init_s,
              "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9, "launches": launches, "split_launches": splits}
    if wm is not None:
        copies = wm.copy_stats()
        passes = len(prompts) + int(stats["decode_steps"])
        n_str = cfg.num_layers - wm.n_resident
        check(copies["copies"] == passes * n_str, f"{name}: {copies['copies']} layer copies, "
                                                  f"{passes} passes of {n_str} streamed layers")
        record.update(hbm_percentage=runtime.hbm_percentage, prefill_policy=runtime.prefill_policy,
                      decode_policy=runtime.decode_policy, resident_layers=wm.n_resident, kv_host=cb.sched.kv_host,
                      bytes_per_pass=copies["bytes"] / passes, copy_ms_per_pass=copies["copy_ms"] / passes,
                      copy_gb_per_s=copies["bytes"] / max(copies["copy_ms"], 1e-9) / 1e6,
                      host_attention_ms_per_step=host_attn[0] / stats["decode_steps"] * 1e3,
                      wall_ms_per_pass=wall / passes * 1e3)
    emit(record)
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


def serving_parity(model: str = "opt-6.7b", layers: int = 2, tree=None, only=None) -> None:
    """``model``'s width (OPT-6.7B by default) at ``layers`` layers, the functions the batcher calls in its order,
    on the card (bf16, kernels) against the CPU (fp32, plain versions) over the
    same tree: a prompt's prefill into a one-row cache, its commit to pages,
    a second prompt sharing its first 64 tokens admitted from the prefix
    cache (seed_prefix_cache + prefill_chunk + commit), then 4 paged decode
    steps of both; and both prompts through insert_slot into a slab, then 4
    ragged decode steps, over bf16 and over int8 KV. Logits within PARITY_TOL.
    ``tree``: the (card, CPU fp32) pair, already made (:func:`parity_tree`);
    ``only``: the runs to make, by label (all by default)."""
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops import paged as pg
    from lia_tpu_torch.engine.engine import bucket_length, pack_prompts

    cfg = get_config(model).replace(num_layers=layers)
    cfg32 = cfg.replace(dtype="float32")
    params, params32 = tree or parity_tree(model, layers)
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
        if only is not None and label not in only:
            continue
        gpu = fn("cuda", cfg, params, torch.bfloat16)
        cpu = fn("cpu", cfg32, params32, torch.float32)
        errs = [(g - c_).abs().max().item() for g, c_ in zip(gpu, cpu)]
        err = max(errs)
        emit({"phase": "serving_parity", "config": label, "model": model, "layers": layers, "prompts": [len(a), len(b)],
              "shared_prefix": 64, "decode_steps": len(steps), "max_abs_err": err, "max_abs_err_by_call": errs,
              "max_abs_logit": max(c_.abs().max().item() for c_ in cpu), "tol": PARITY_TOL,
              "argmax_agree": float(np.mean([bool((g.argmax(-1) == c_.argmax(-1)).all()) for g, c_ in zip(gpu, cpu)]))})
        check(all(bool(torch.isfinite(g).all()) for g in gpu), f"serving_parity {label}: non-finite logits")
        check(err <= PARITY_TOL, f"serving_parity {label}: max abs logit err {err} > {PARITY_TOL}")
    del params, params32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7b: speculative decoding (prompt lookup, a draft model, sampled
# acceptance) through generate, the tiered verify pass and serving
# ---------------------------------------------------------------------------

SPEC_K, SPEC_NGRAM, SPEC_PATTERN = 4, 3, 32  # 256-token prompts: a seeded 32-token pattern, repeated
SPEC_DRAFT = "opt-125m"  # the draft model, full width and depth
SPEC_SAMPLED = dict(do_sample=True, temperature=0.8, top_p=0.95)
SPEC_RUNS = 3  # generate calls of each greedy generate cell (median and all)
# the teacher-forced check: every greedy token the speculative paths emit lies
# within this of the top log-prob of a score pass over prompt + emitted tokens
# (the same as the logit gap). Two times the logit tolerance of the 2-layer
# parity of PARITY_TOL, the bf16 model against fp32, whose observed error was
# about 0.012: the verify and the score pass run different kernels (B6 at C = 5
# against B1 over the whole sequence), and a random model's top logits lie
# within bf16 noise of one another, so the argmax may flip where the gap is
# smaller than that noise
SPEC_GREEDY_BOUND = 2 * PARITY_TOL
SPEC_SERVING = [
    ("serve-slab-spec4", dict(speculate_k=SPEC_K), False),
    ("serve-paged-spec4", dict(paged=True, speculate_k=SPEC_K), False),
    ("serve-paged-draft", dict(paged=True, speculate_k=SPEC_K), True),
]


def spec_prompts(vocab: int):
    """B prompts of PROMPT tokens, each a seeded SPEC_PATTERN-token pattern repeated."""
    rng = np.random.default_rng(6)
    return [rng.integers(2, vocab, SPEC_PATTERN).tolist() * (PROMPT // SPEC_PATTERN) for _ in range(B)]


def spec_expected(names, cfg, steps: int, verify: str, dcfg=None) -> dict:
    """Kernel launches of one speculative generate: the target's flash prefill
    per layer, its verify kernel per layer per step (B6 over a slab or the
    scheduler's segments), and with a draft its flash prefill per layer and
    its k + 1 fresh-merge decode steps per layer per step (B2; bf16 KV)."""
    out = {name: 0 for name in names}
    out[verify] = cfg.num_layers * steps
    out["flash_attention_prefill"] = cfg.num_layers + (dcfg.num_layers if dcfg else 0)
    if dcfg is not None:
        out["decode_attention_fresh"] = dcfg.num_layers * (SPEC_K + 1) * steps
    return out


def teacher_forced_gaps(engine, prompts, seqs) -> np.ndarray:
    """The score pass (``loglikelihood``'s path, :meth:`InferenceEngine._logprob_matrix`)
    over each prompt with its emitted tokens: per emitted token, the top
    log-prob at its position less its own, [B, new]."""
    from lia_tpu_torch.engine.engine import pack_prompts

    new = seqs.shape[1]
    tokens, mask = pack_prompts([list(p) + [int(t) for t in s_] for p, s_ in zip(prompts, seqs)], 1)
    S = tokens.shape[1]
    with torch.inference_mode():
        lp = engine._logprob_matrix(tokens, mask)[:, S - new - 1 : S - 1]  # position t scores token t + 1
        emitted = torch.from_numpy(tokens[:, S - new :]).to(lp.device).long()
        gaps = lp.max(dim=-1).values - lp.gather(-1, emitted[..., None])[..., 0]
    del lp
    torch.cuda.empty_cache()
    return gaps.cpu().numpy()


def spec_cell(ca, cm, name: str, cfg, engine, prompts, run, verify: str, dcfg=None, timed: bool = True,
              greedy_ref=None, extra=None):
    """One speculative generate cell: ``run()`` gives (sequences, verify
    steps). Counters zeroed just before one run and read just after it, and
    checked exactly (no plain version: the CPU path launches nothing the
    counters see, and every kernel of the path is counted); the split
    launches of B6 against flash_split_parts' plan at this shape; sequences'
    shape and vocabulary, steps within [ceil(new / (k+1)), new]. With
    ``timed``, SPEC_RUNS runs (median and all). With ``greedy_ref`` (plain
    greedy generate's sequences on the card), the teacher-forced check and the
    agreement. Returns (sequences, steps, launches)."""
    from lia_tpu_torch.engine.lookahead import spec_slots

    torch.cuda.synchronize()
    reset_counts(ca, cm)
    t0 = time.perf_counter()
    seqs, steps = run()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches, splits = launch_counts(ca, cm), ca.split_counts()
    expected = spec_expected(launches, cfg, steps, verify, dcfg)
    check(launches == expected, f"{name}: launches {launches} != expected {expected}")
    if verify == "flash_attention_cached":
        parts = ca.flash_split_parts(B, SPEC_K + 1, cfg.num_heads, cfg.num_kv_heads,
                                     spec_slots(PROMPT, NEW_TOKENS, SPEC_K + 1),
                                     torch.cuda.get_device_properties(0).multi_processor_count)
        want = cfg.num_layers * steps if parts > 1 else 0
        check(splits["flash_attention_cached"] == want, f"{name}: {splits['flash_attention_cached']} split B6 calls, "
                                                         f"{want} planned")
    check(seqs.shape == (B, NEW_TOKENS), f"{name}: sequences shape {seqs.shape}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab_size)).all()), f"{name}: token outside the vocabulary")
    check(-(-NEW_TOKENS // (SPEC_K + 1)) <= steps <= NEW_TOKENS, f"{name}: {steps} verify steps")
    for _ in range(SPEC_RUNS - 1 if timed else 0):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    record = {"phase": "speculative", "config": name, "model": cfg.name, "layers": cfg.num_layers, "batch": B,
              "prompt": PROMPT, "new_tokens": NEW_TOKENS, "k": SPEC_K, "draft": dcfg.name if dcfg else None,
              "verify_steps": steps, "tokens_emitted": int(seqs.size),
              # the first token of each row comes from the prefill; the rest from the verifies
              "tokens_per_step_per_row": (seqs.size - B) / (steps * B),
              "wall_s": statistics.median(walls), "wall_s_runs": walls,
              "tokens_per_s": seqs.size / statistics.median(walls), "launches": launches,
              "split_launches": splits, **(extra or {})}
    if greedy_ref is not None:
        gaps = teacher_forced_gaps(engine, prompts, seqs)
        same = seqs == greedy_ref
        record.update(teacher_forced_max_gap=float(gaps.max()), teacher_forced_bound=SPEC_GREEDY_BOUND,
                      tokens_agree_with_greedy=float(same.mean()),
                      rows_equal_to_greedy=int(same.all(axis=1).sum()))
        check(gaps.max() <= SPEC_GREEDY_BOUND, f"{name}: an emitted greedy token lies {gaps.max()} below the "
                                               f"teacher-forced top log-prob (bound {SPEC_GREEDY_BOUND})")
    emit(record)
    return seqs, steps, launches


def prefill_ms(engine, prompts) -> float:
    """The target's prompt pass alone (the speculative cells' first step), on
    the host's clock around a synchronized call: resident prefill or the
    scheduler's prefill pass."""
    from lia_tpu_torch.engine.engine import pack_prompts
    from lia_tpu_torch.engine.lookahead import spec_slots
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.ops import kv_cache as kvc

    tokens, mask = pack_prompts(prompts, 1)
    max_len = spec_slots(tokens.shape[1], NEW_TOKENS, SPEC_K + 1)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if engine.scheduler is not None:
            engine.scheduler.prefill_pass(tokens, mask, max_len)
        else:
            cache = kvc.init_cache(engine.cfg, len(prompts), max_len, torch.bfloat16,
                                   quantized=engine.runtime.quant.kv_cache_dtype == "int8", device="cuda")
            T.prefill(engine.cfg, engine.params, torch.from_numpy(tokens).cuda(), torch.from_numpy(mask).cuda(), cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def speculative_phase(ca, cm, cfg, tree) -> dict:
    """The speculative cells at OPT-6.7B full width (``cfg``'s depth), b16, 256-token
    repetitive prompts, 32 new tokens, k = 4: prompt lookup over bf16 and int8
    KV, the opt-125m draft greedy, sampled (temperature 0.8, top_p 0.95) and
    sampled at top_k = 1 (whose tokens must equal greedy's), the three
    speculative serving cells over the serving workload, and prompt lookup
    under tier-h50-p3 (the weight stream's bytes per emitted token beside
    plain tiered decode's, from this run's tier-h50-p3 cell). Returns the
    launches by cell."""
    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    prompts = spec_prompts(cfg.vocab_size)
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=0))
    dcfg = get_config(SPEC_DRAFT)
    dparams = fuse_projections(dcfg, device_dummy_params(dcfg, seed=0))
    draft = InferenceEngine(dcfg, dparams)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    launches = {}
    for kv in ("none", "int8"):
        engine = InferenceEngine(cfg, params, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
        engine.generate_speculative(prompts[:2], GenerationConfig(max_new_tokens=4), ngram=SPEC_NGRAM, k=SPEC_K)  # warm-up
        greedy = engine.generate(prompts, gen).sequences
        pre = {"prefill_ms": prefill_ms(engine, prompts)}
        name = "spec-lookup" + ("-int8kv" if kv == "int8" else "")
        _, _, launches[name] = spec_cell(
            ca, cm, name, cfg, engine, prompts,
            lambda: engine.generate_speculative(prompts, gen, ngram=SPEC_NGRAM, k=SPEC_K), "flash_attention_cached",
            greedy_ref=greedy, extra=pre)
        if kv == "none":
            greedy_draft, steps_draft, launches["spec-draft"] = spec_cell(
                ca, cm, "spec-draft", cfg, engine, prompts,
                lambda: engine.generate_speculative_draft(draft, prompts, gen, k=SPEC_K), "flash_attention_cached",
                dcfg, greedy_ref=greedy, extra=pre)
            _, _, launches["spec-draft-sampled"] = spec_cell(
                ca, cm, "spec-draft-sampled", cfg, engine, prompts,
                lambda: engine.generate_speculative_draft(draft, prompts, gen.replace(**SPEC_SAMPLED), k=SPEC_K,
                                                          seed=3), "flash_attention_cached", dcfg, extra=pre)
            top1, steps_top1, launches["spec-draft-topk1"] = spec_cell(
                ca, cm, "spec-draft-topk1", cfg, engine, prompts,
                lambda: engine.generate_speculative_draft(draft, prompts, gen.replace(**SPEC_SAMPLED, top_k=1),
                                                          k=SPEC_K, seed=3), "flash_attention_cached", dcfg,
                timed=False, extra=pre)
            equal = float((top1 == greedy_draft).mean())
            emit({"phase": "speculative_topk1", "tokens_equal": equal, "steps": [steps_top1, steps_draft]})
            check(equal == 1.0 and steps_top1 == steps_draft,
                  f"spec-draft-topk1: {equal} of its tokens equal greedy spec-draft's, steps {steps_top1} "
                  f"against {steps_draft}")
        del engine
        torch.cuda.empty_cache()

    serve_prompts, serve_new = serving_workload(cfg.vocab_size)
    for name, opts, with_draft in SPEC_SERVING:
        launches[name], cb = serving_path(ca, cm, name, opts, cfg, params, serve_prompts, serve_new,
                                          (dcfg, dparams) if with_draft else None)
        st = cb.stats()
        emit({"phase": "speculative", "config": name, "model": cfg.name, "layers": cfg.num_layers, "k": SPEC_K,
              "draft": dcfg.name if with_draft else None, "requests": len(serve_prompts),
              "verify_steps": st["decode_steps"], "tokens_emitted": st["total_tokens"],
              # each request's first token comes from its prefill
              "tokens_per_verify_step": (st["total_tokens"] - st["requests"]) / st["decode_steps"],
              **{key: st[key] for key in ("tokens_per_s", "p50_ttft_s", "p99_ttft_s", "p50_tpot_s", "p99_tpot_s")}})
        del cb
    del params, draft, dparams
    torch.cuda.empty_cache()

    name = "tier-h50-p3-spec4"
    cfg, tree = tier_model("tier-h50-p3", cfg, tree)  # the depth of the plain tiered cell it is held against
    engine = InferenceEngine(cfg, tree, tiered_runtime("none", 50, (3, 3), 1))
    pre = {"prefill_ms": prefill_ms(engine, prompts)}
    wm = engine.scheduler.wm
    wm.copy_stats()
    seqs, steps, launches[name] = spec_cell(
        ca, cm, name, cfg, engine, prompts,
        lambda: engine.generate_speculative(prompts, gen, ngram=SPEC_NGRAM, k=SPEC_K), "flash_attention_cached",
        timed=False, extra=pre)
    copies = wm.copy_stats()
    plain = TIER_COPY_BYTES["tier-h50-p3"] / B  # a plain decode step streams the layers once for B tokens
    emit({"phase": "speculative_tiered", "config": name, "verify_steps": steps, "copy_bytes": copies["bytes"],
          "copy_ms": copies["copy_ms"], "streamed_bytes_per_emitted_token": copies["bytes"] / seqs.size,
          "plain_tiered_bytes_per_emitted_token": plain,
          "ratio": copies["bytes"] / seqs.size / plain})
    check(copies["bytes"] > 0, f"{name}: no weight streamed")
    del engine
    torch.cuda.empty_cache()
    return launches


def speculative_parity(ca, cm, model: str = "opt-6.7b", layers: int = 2, tree=None, only=None) -> None:
    """``model``'s width (OPT-6.7B by default) at ``layers`` layers, the verify passes on the card (bf16,
    kernels) against the CPU (fp32, plain versions) over the same tree and
    prompts (row 1 left-padded): the slab verify (B6), the paged verify (B5,
    the prompts written to shuffled pages) and the tiered verify (half
    resident, B6 over both segments), each from the same prefilled cache and
    the same two C = 5 chunks with an uneven accept between them, so the
    second pass runs at per-row bases. Logits within PARITY_TOL. ``tree``:
    the (card, CPU fp32) pair, already made (:func:`parity_tree`); ``only``:
    the passes to run, by label (all by default)."""
    from lia_tpu_torch.config import RuntimeConfig
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops import paged as pg
    from lia_tpu_torch.runtime.scheduler import StreamingScheduler

    cfg = get_config(model).replace(num_layers=layers)
    cfg32 = cfg.replace(dtype="float32")
    params, params32 = tree or parity_tree(model, layers)
    rng = np.random.default_rng(9)
    C = SPEC_K + 1
    tokens = rng.integers(2, cfg.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), bool)
    mask[1, :14] = False
    tokens[1, :14] = 1
    chunks = rng.integers(2, cfg.vocab_size, (2, 2, C)).astype(np.int32)
    accept = np.asarray([4, 1], np.int32)  # after the first pass: rows 4 and 1 tokens on
    n_real = mask.sum(1).astype(np.int32)
    bs, P = SERVE_BLOCK, 8
    table = np.zeros((2, P), np.int32)
    table[0, :5] = [9, 3, 14, 1, 7]  # shuffled pages; the prompts' 64 and 50 tokens and two chunks
    table[1, :5] = [2, 17, 8, 30, 5]

    def positions(step):
        return (n_real + (accept if step else 0))[:, None] + np.arange(C, dtype=np.int32)[None, :]

    def slab(dev, c, p, dtype):
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        cache = kvc.init_cache(c, 2, 128, dtype, device=dev)
        _, cache = T.prefill(c, p, t(tokens), t(mask), cache)
        cache = cache._replace(length=cache.length.reshape(1).repeat(2))
        out = []
        for i in range(2):
            out.append(T.verify_chunk(c, p, t(chunks[i]), t(positions(i)), cache).float().cpu())
            cache = kvc.accept_ragged(cache, t(accept))
        return torch.stack(out)

    def paged(dev, c, p, dtype):
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        kp = torch.zeros(c.num_layers, 32, c.num_kv_heads, bs, c.head_dim, dtype=dtype, device=dev)
        vp = torch.zeros_like(kp)
        seg = kvc.init_cache(c, 2, 64, dtype, device=dev)
        _, seg = T.prefill(c, p, t(tokens), t(mask), seg)
        for b in range(2):
            pad = 64 - int(n_real[b])
            pg.write_prompt_all_layers(kp, vp, seg.k[:, b, :, pad:], seg.v[:, b, :, pad:], t(table[b]), int(n_real[b]))
        lengths, out = n_real.copy(), []
        for i in range(2):
            logits, _, _ = pg.verify_step_paged(c, p, t(chunks[i]), t(positions(i)), kp, vp, t(table), t(lengths),
                                                torch.ones(2, dtype=torch.bool, device=dev))
            out.append(logits.float().cpu())
            lengths = lengths + accept
        return torch.stack(out)

    def tiered(dev, c, p, dtype):
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        sched = StreamingScheduler(c, RuntimeConfig(hbm_percentage=50), p, dev)
        _, state = sched.prefill_pass(tokens, mask, 128)
        state = sched.ragged_state(state)
        out = []
        for i in range(2):
            logits, state = sched.verify_logits(t(chunks[i]), t(positions(i)), state)
            out.append(logits.float().cpu())
            state = sched.accept_state(state, t(accept))
        return torch.stack(out)

    for label, fn, kernel in (("slab verify", slab, "flash_attention_cached"),
                              ("paged verify", paged, "paged_decode_attention"),
                              ("tiered verify", tiered, "flash_attention_cached")):
        if only is not None and label not in only:
            continue
        with torch.inference_mode():
            reset_counts(ca, cm)
            gpu = fn(torch.device("cuda"), cfg, params, torch.bfloat16)
            launched = launch_counts(ca, cm)[kernel]
            cpu = fn(torch.device("cpu"), cfg32, params32, torch.float32)
        err = (gpu - cpu).abs().max().item()
        emit({"phase": "speculative_parity", "config": label, "model": model, "layers": layers, "batch": 2,
              "prompt": 64, "chunk": C,
              "passes": 2, "accept": accept.tolist(), "kernel": kernel, "launches": launched,
              "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(), "tol": PARITY_TOL,
              "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
        check(launched == 2 * cfg.num_layers, f"speculative_parity {label}: {launched} {kernel} launches")
        check(bool(torch.isfinite(gpu).all()), f"speculative_parity {label}: non-finite logits on the card")
        check(err <= PARITY_TOL, f"speculative_parity {label}: max abs logit err {err} > {PARITY_TOL}")
    del params, params32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7c: continuous-batching serving over the tiered scheduler, and the
# per-request logits processors
# ---------------------------------------------------------------------------

SERVE_TIER_REQUESTS = 32  # the serving workload's first 32 requests
# (name, batcher options, hbm_percentage, (prefill, decode) policy, depth: None
# for full depth, else the first n layers of the tiered phase's host tree; cut
# from 32, 8 and 8 layers to make room for the automatic-placement phases,
# then from 16, 4 and 8 to 4, 2 and 4 for the ALiBi families' phases, then
# from 4 to 2 for the quantization algorithms' phase)
SERVING_TIERED = [
    ("serve-tier-h50-p3", dict(), 50, (3, 3), 2),
    ("serve-tier-h50-p3-paged", dict(paged=True), 50, (3, 3), 2),
    ("serve-tier-h50-p0-p2", dict(), 50, (0, 2), 2),
    ("serve-tier-h50-p3-spec4", dict(speculate_k=SPEC_K), 50, (3, 3), 2),
]
# serve-paged-proc: every second request a repetition penalty and a minimum,
# every fourth (from the second) a no-repeat n-gram size
PROC_PENALTY, PROC_MIN_NEW, PROC_NGRAM = 1.2, 8, 3
# (name, (prefill, decode) policy, KV, paged): the scheduler's serving passes
# at 4 layers, half resident, on the card against the CPU
SERVE_TIER_PARITY = [
    ("serve-tier-parity-p3", (3, 3), "none", False),
    ("serve-tier-parity-p3-int8kv", (3, 3), "int8", False),
    ("serve-tier-parity-p0", (0, 0), "none", False),
    ("serve-tier-parity-p0-p2", (0, 2), "none", False),
    ("serve-tier-parity-p3-paged", (3, 3), "none", True),
]


def proc_kwargs(i: int) -> dict:
    """serve-paged-proc's processors for request ``i``."""
    kw = dict(repetition_penalty=PROC_PENALTY, min_new_tokens=PROC_MIN_NEW) if i % 2 == 0 else {}
    if i % 4 == 1:
        kw["no_repeat_ngram_size"] = PROC_NGRAM
    return kw


def repeats_ngram(prompt, output, n: int) -> bool:
    """True where an emitted token completes an n-gram already present in the
    prompt and the output before it (what no_repeat_ngram_size bans)."""
    seq = list(prompt) + list(output)
    for t in range(len(prompt), len(seq)):
        if t - n + 1 < 0:
            continue
        gram = tuple(seq[t - n + 1 : t + 1])
        if any(tuple(seq[i : i + n]) == gram for i in range(t - n + 1)):
            return True
    return False


def serving_tier_expected(cfg, cb, stats: dict, admissions: int, names) -> dict:
    """Kernel launches of one serving run over the scheduler, from its code
    and the batcher's counters: every admission's streamed prefill runs B1 at
    every layer (the prefill plans attend on the card); each decode step runs
    B2 (B3 over int8 KV) at every resident layer and B7 at every streamed
    layer whose plan attends on the card (policies 0 and 3; none for 2 and
    4), or B5 at every layer over the paged pool; each speculative step is a
    verify, B6 at every layer."""
    L, steps = cfg.num_layers, int(stats["decode_steps"])
    n_res = cb.sched.wm.n_resident
    out = {name: 0 for name in names}
    out["flash_attention_prefill"] = L * admissions
    if cb.speculate_k is not None:
        out["flash_attention_cached"] = L * steps
    elif cb.paged:
        out["paged_decode_attention"] = L * steps
    else:
        out["decode_attention_fresh"] = n_res * steps
        out["decode_attention"] = 0 if cb.sched.decode_plan.hybrid else (L - n_res) * steps
    return out


def serving_tier_phase(ca, cm, cfg, tree):
    """The serving lines over the tiered phase's host tree at OPT-6.7B width,
    max_batch 16, max_len 1024: the workload's first SERVE_TIER_REQUESTS
    requests under serve-tier-h50-p3 (slab, bf16 KV), -paged, -p0-p2 (host
    KV, host attention at decode) and -spec4 (prompt lookup, k = 4) at the
    depths of SERVING_TIERED; then serve-paged-proc, resident at full depth
    over the whole 64-request workload with the per-request processors
    (proc_kwargs): no n-gram request repeats a 3-gram. Returns (the launches
    by line, serve-tier-h50-p3's batcher for the device breakdowns)."""
    prompts, new_tokens = serving_workload(cfg.vocab_size)
    launches, kept = {}, None
    for name, opts, hbm, policies, depth in SERVING_TIERED:
        n = SERVE_TIER_REQUESTS
        tcfg, ttree = (cfg, tree) if depth is None else (cfg.replace(num_layers=depth), first_layers(tree, depth))
        launches[name], cb = serving_path(ca, cm, name, opts, tcfg, ttree, prompts[:n], new_tokens[:n],
                                          runtime=tiered_runtime("none", hbm, policies, 1))
        if name == "serve-tier-h50-p3":
            kept = cb
        else:
            cb.sched.wm.close()
        del cb
    kw = [proc_kwargs(i) for i in range(len(prompts))]
    name = "serve-paged-proc"
    launches[name], cb = serving_path(ca, cm, name, dict(paged=True), cfg, tree, prompts, new_tokens, submit_kw=kw)
    ngram = [r for r in cb.done if r.no_repeat_ngram_size]
    bad = [r.req_id for r in ngram if repeats_ngram(r.prompt, r.output, PROC_NGRAM)]
    emit({"phase": "serving_proc", "config": name, "penalty_requests": sum(1 for k in kw if k.get("repetition_penalty")),
          "ngram_requests": len(ngram), "ngram_violations": bad})
    check(cb.use_processors and len(ngram) == len(prompts) // 4 and not bad,
          f"{name}: requests {bad} of {len(ngram)} repeat a {PROC_NGRAM}-gram")
    del cb
    torch.cuda.empty_cache()
    return launches, kept


def serving_tier_breakdown(cb, prompts) -> None:
    """:func:`copy_compute_split` of one wave of max_batch more requests (16
    new tokens each) through serve-tier-h50-p3's batcher, per pass (each
    admission and each decode step streams the layers once)."""
    before = len(cb.done) + cb._steps

    def run():
        for p in prompts:
            cb.submit(p, max_new_tokens=16)
        cb.run()

    copy_compute_split("serving_tiered_breakdown", "serve-tier-h50-p3", run,
                       lambda: len(cb.done) + cb._steps - before)


def serving_tier_parity(model: str = "opt-6.7b") -> None:
    """``model``'s width at 4 layers, half resident: the scheduler's serving
    passes on the card (bf16, kernels, streamed weights) against the CPU
    (fp32, plain versions, the host tier's golden attention) over the same
    tree. Three slots, the middle one empty (inactive: it computes and is
    not compared): two prompts (100 and 37 tokens) through prefill_pass and
    insert_slot_state into a ragged state, then 4 ragged steps, under each
    SERVE_TIER_PARITY slab entry; the same prompts' streamed prefill at its
    bucket committed to shuffled pages, then 4 paged steps. The active rows'
    logits within PARITY_TOL."""
    from lia_tpu_torch.config import QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import bucket_length, pack_prompts
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import paged as pg
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.runtime.scheduler import StreamingScheduler
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config(model).replace(num_layers=4)
    cfg32 = cfg.replace(dtype="float32")
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=1))
    params32 = to_device(params, "cpu", torch.float32)
    rng = np.random.default_rng(7)
    prompts = {0: rng.integers(2, cfg.vocab_size, 100).tolist(), 2: rng.integers(2, cfg.vocab_size, 37).tolist()}
    steps = rng.integers(2, cfg.vocab_size, (4, 3)).astype(np.int32)
    active = np.asarray([True, False, True])
    bs, P = SERVE_BLOCK, 16
    table = np.zeros((3, P), np.int32)
    table[0, :8] = [9, 3, 14, 1, 7, 22, 5, 11]  # shuffled pages; 100 + 4 tokens need 7
    table[2, :3] = [2, 17, 8]

    def run(dev, c, p, rt, paged):
        t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
        sched = StreamingScheduler(c, rt, p, dev)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        out = []
        if paged:
            kp = torch.zeros(c.num_layers, 32, c.num_kv_heads, bs, c.head_dim, dtype=dtype, device=dev)
            vp = torch.zeros_like(kp)
        else:
            state = sched.init_serving_state(3, 256)
        for slot, prompt in prompts.items():
            bucket = bucket_length(len(prompt))
            toks, mask = pack_prompts([prompt], 1, bucket=bucket)
            if paged:
                logits, seg_state = sched.prefill_pass(toks, mask, bucket)
                seg = ContinuousBatcher._sched_seg_to_slab(seg_state)
                pad = bucket - len(prompt)
                pg.write_prompt_all_layers(kp, vp, seg.k[:, 0, :, pad:], seg.v[:, 0, :, pad:], t(table[slot]),
                                           len(prompt))
            else:
                logits, seg_state = sched.prefill_pass(toks, mask, 256)
                sched.insert_slot_state(state, seg_state, slot)
            out.append(logits.float().cpu())
        pos = np.asarray([len(prompts[0]), 0, len(prompts[2])], np.int32)
        for st in steps:
            if paged:
                logits, _, _ = sched.decode_pass_paged(t(st), t(pos), kp, vp, t(table), t(pos), t(active))
            else:
                logits, state = sched.decode_pass_ragged(t(st), t(pos), state, t(active))
            out.append(logits.float().cpu()[active])
            pos = pos + active
        sched.wm.close()
        return out

    for label, (pf, dc), kv, paged in SERVE_TIER_PARITY:
        rt = RuntimeConfig(hbm_percentage=50, prefill_policy=pf, decode_policy=dc,
                           quant=QuantConfig(kv_cache_dtype=kv))
        with torch.inference_mode():
            gpu = run(torch.device("cuda"), cfg, params, rt, paged)
            cpu = run(torch.device("cpu"), cfg32, params32, rt, paged)
        errs = [(g - c_).abs().max().item() for g, c_ in zip(gpu, cpu)]
        err = max(errs)
        emit({"phase": "serving_tier_parity", "config": label, "model": model, "layers": 4, "hbm_percentage": 50,
              "prefill_policy": pf, "decode_policy": dc, "kv": kv, "paged": paged, "slots": 3,
              "prompts": [len(p) for p in prompts.values()], "decode_steps": len(steps), "max_abs_err": err,
              "max_abs_err_by_call": errs, "max_abs_logit": max(c_.abs().max().item() for c_ in cpu),
              "tol": PARITY_TOL,
              "argmax_agree": float(np.mean([bool((g.argmax(-1) == c_.argmax(-1)).all()) for g, c_ in zip(gpu, cpu)]))})
        check(all(bool(torch.isfinite(g).all()) for g in gpu), f"serving_tier_parity {label}: non-finite logits")
        check(err <= PARITY_TOL, f"serving_tier_parity {label}: max abs logit err {err} > {PARITY_TOL}")
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
    tiered ones; tier-h50-p0-beam at the TIER_DEPTH cut), then scoring, resident and tier-h50-p3. Returns (launches by
    configuration, the median walls of beam-nb4 and beam-nb4-int8kv, their
    prompts)."""
    from lia_tpu_torch.config import QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    bprompts = [p[:n] for p, n in zip(prompts, BEAM_PROMPT_LENS)]
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=0))
    launches, walls = {}, {}
    for name, kv, grouped, proc, timed, tiering in BEAM:
        bcfg, btree = tier_model(name, cfg, tree)
        if tiering is None:
            engine = InferenceEngine(cfg, params, RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
        else:
            engine = InferenceEngine(bcfg, btree, tiered_runtime(kv, tiering[0], tiering[1], 1))
            check((engine.scheduler.grouped_beam_ok) == grouped, f"{name}: grouped_beam_ok is not {grouped}")
        launches[name], walls[name] = beam_path(ca, cm, name, bcfg, engine, bprompts, kv, grouped, proc, timed,
                                                tiering)
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
    return launches, {name: walls[name] for name in ("beam-nb4", "beam-nb4-int8kv")}, bprompts


def beam_parity(model: str = "opt-6.7b", layers: int = 2, tree=None) -> None:
    """``model``'s width (OPT-6.7B by default) at ``layers`` layers, one tree on both sides: a grouped beam cache
    of 2 prompts × 4 beams, the prompt and 4 beam_decode_step calls on the card
    (bf16, kernels) against the CPU (fp32, plain versions), every step's
    tokens and tail shuffle (flat_src) the CPU run's, over bf16 and int8 KV;
    then score_logprobs at the prompt's valid positions. Within PARITY_TOL.
    ``tree``: the (card, CPU fp32) pair, already made (:func:`parity_tree`)."""
    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine import beam as beam_mod
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import kv_cache as kvc

    cfg = get_config(model).replace(num_layers=layers)
    cfg32 = cfg.replace(dtype="float32")
    params, params32 = tree or parity_tree(model, layers)
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
        emit({"phase": "beam_parity", "model": model, "kv": kv, "layers": layers, "groups": 2, "num_beams": nb,
              "prompt": 64,
              "decode_steps": n_steps, "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
              "score_logprobs_max_abs_err": lp_err, "tol": PARITY_TOL,
              "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
        check(bool(torch.isfinite(gpu).all()), f"beam_parity {kv}: non-finite logits on the card")
        check(err <= PARITY_TOL, f"beam_parity {kv}: max abs logit err {err} > {PARITY_TOL}")
        check(lp_err <= PARITY_TOL, f"beam_parity {kv}: score_logprobs max abs err {lp_err} > {PARITY_TOL}")
    del params, params32
    torch.cuda.empty_cache()


def beam_breakdown(ca, cfg, prompts, name: str, kv: str, wall_s: float) -> None:
    """Device time by kernel over one more run of the grouped beam cell
    ``name`` (KV type ``kv``) under the profiler (the weights made anew), and
    the idle share against the median wall time of the unprofiled runs."""
    from torch.profiler import ProfilerActivity, profile

    from lia_tpu_torch.config import GenerationConfig, QuantConfig, RuntimeConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    engine = InferenceEngine(cfg, device_dummy_params(cfg, seed=0), RuntimeConfig(quant=QuantConfig(kv_cache_dtype=kv)))
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, num_beams=BEAM_NB)
    engine.generate_beam(prompts, gen)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate_beam(prompts, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "device_breakdown", "config": name, "kv": kv, "device_busy_s": busy_s,
          "wall_s": wall_s, "idle_share": 1 - busy_s / wall_s,
          "top_kernels": [{"kernel": _short(e.key), "count": e.count, "ms": e.self_device_time_total / 1e3}
                          for e in top],
          # every launch of the port's own kernels in the run (the beam kernel's device ms among them)
          "port_kernels": [{"kernel": _short(e.key), "count": e.count, "ms": e.self_device_time_total / 1e3}
                           for e in kernels if OWN_KERNEL.search(e.key)]})
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: parity
# ---------------------------------------------------------------------------


def parity_tree(model: str, layers: int):
    """The parities' tree of ``model``'s width at ``layers`` layers: bf16
    dummy weights (seed 1) drawn on the card with projections fused, and its
    fp32 copy on the CPU."""
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config(model).replace(num_layers=layers)
    params = fuse_projections(cfg, device_dummy_params(cfg, seed=1))
    return params, to_device(params, "cpu", torch.float32)


def alibi_parity(ca, cm) -> None:
    """The ALiBi families at 4 layers, card (bf16, kernels with slopes)
    against CPU (fp32, plain versions with the reference's biases), today's
    tolerances: MPT-7B's width over one tree on every path (resident
    prefill and decode; beams and scoring over bf16 and int8 KV; serving's
    paged pool with a prompt admitted from the prefix cache, the chunk over
    the cache; the slab and paged verify at C = 5; the tiered scheduler
    under policy 3 and the host-attention tier 0/2), then BLOOM-7B1's,
    Baichuan-13B's and Baichuan2-13B's resident prefill and decode."""
    tree = parity_tree("mpt-7b", 4)
    parity("mpt-7b, none KV", "none", model="mpt-7b", layers=4, tree=tree)
    beam_parity("mpt-7b", 4, tree=tree)
    serving_parity("mpt-7b", 4, tree=tree, only=("paged + prefix cache",))
    speculative_parity(ca, cm, "mpt-7b", 4, tree=tree, only=("slab verify", "paged verify"))
    tiered_parity("mpt-7b", ALIBI_TIER_PARITY, tree=tree)
    del tree
    for model in ALIBI_PARITY:
        parity(f"{model}, none KV", "none", model=model, layers=4)
    torch.cuda.empty_cache()


def parity(label: str, kv: str, quant=None, model: str = "opt-6.7b", fuse: bool = True, gate=None,
           stacked_per_layer: int = 0, layers: int = 2, tree=None, tol=None):
    """``model``'s width (OPT-6.7B by default) at ``layers`` layers, one tree on both
    sides: the card (bf16 model, kernels) against the CPU (fp32 model, plain
    versions; quantized records move as they are), projections fused unless
    ``fuse`` is off, the routes of ``gate`` on for both runs (with the fused
    MLP on, the card runs it at every layer of the prefill's 2 x 64 rows and
    of each step; with the stacked W4A8 route on, ``stacked_per_layer`` linears
    of each layer run the stacked entry at each decode step). ``tree``: the
    (card, CPU fp32) pair of a bf16 tree already made (:func:`parity_tree`) or
    of a quantized one; ``tol``: the logits' tolerance where it is not the
    weights' activation mode's."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models import transformer as T
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import cuda_matmul as cm
    from lia_tpu_torch.ops import cuda_mlp
    from lia_tpu_torch.ops import kv_cache as kvc
    from lia_tpu_torch.ops.fuse import fuse_projections
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config(model).replace(num_layers=layers)
    cfg32 = cfg.replace(dtype="float32")
    if tree is not None:
        params, params32 = tree
    else:
        qc = None if quant is None else QuantConfig(**quant)
        params = device_dummy_params(cfg, seed=1, quant=qc)
        if fuse:
            params = fuse_projections(cfg, params)
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
    if tol is None:
        tol = PARITY_TOL_INT8_ACT if (quant or {}).get("act_quant") == "dynamic" else PARITY_TOL
    emit({"phase": "parity", "config": label, "model": model, "kv": kv, "layers": layers, "batch": 2, "prompt": 64,
          "gates": gate or {}, "fused_mlp_launches": fused, "w4a8_matmul_stacked_launches": stacked,
          "decode_steps": 4, "max_abs_err": err, "max_abs_logit": cpu.abs().max().item(),
          "tol": tol, "argmax_agree": float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())})
    check(bool(torch.isfinite(gpu).all()), f"parity {label}: non-finite logits on the card")
    check(err <= tol, f"parity {label}: max abs logit err {err} > {tol}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the families with large query-head groups and checkpoint I/O
# ---------------------------------------------------------------------------

# (label, N, N_kv, D, timed): Falcon-7B's heads (71 over one KV head) and
# ChatGLM3-6B's (32 over 2): G = 71 and 16
GROUP_HEADS = [("falcon-7b heads G=71 (N 71, N_kv 1, D 64)", 71, 1, 64, True),
               ("chatglm3-6b heads G=16 (N 32, N_kv 2, D 128)", 32, 2, 128, True)]
# the head dims 80, 96 and 256 at OPT-2.7B's, GPT-NeoX-20B's and GPT-J-6B's
# heads (timed), and each at G = 4
HEAD_DIM_HEADS = [("opt-2.7b heads D=80 (N 32, N_kv 32)", 32, 32, 80, True),
                  ("D=80 G=4 (N 32, N_kv 8)", 32, 8, 80, False),
                  ("gpt-neox-20b heads D=96 (N 64, N_kv 64)", 64, 64, 96, True),
                  ("D=96 G=4 (N 64, N_kv 16)", 64, 16, 96, False),
                  ("gpt-j-6b heads D=256 (N 16, N_kv 16)", 16, 16, 256, True),
                  ("D=256 G=4 (N 16, N_kv 4)", 16, 4, 256, False)]
# (model, layers or None for full depth, KV types, the KV types timed): the
# families run through generate(fused=True) at full width (Falcon-7B's int8-KV
# run untimed since the head-dim cells came; since the quantization
# algorithms' phase Falcon-7B and OPT-2.7B at 8 of their 32 layers, GPT-J-6B
# at 7 of 28 and GPT-NeoX-20B at 11 of 44, half the ALiBi slice's depths)
FAMILY_CELLS = [("falcon-7b", 8, ("none", "int8"), ("none",)), ("chatglm3-6b", 4, ("none",), ()),
                ("baichuan2-7b", 4, ("none",), ()), ("stablelm-2-1.6b", 4, ("none",), ()),
                ("opt-2.7b", 8, ("none", "int8"), ("none", "int8")), ("gpt-j-6b", 7, ("none", "int8"), ()),
                ("gpt-neox-20b", 11, ("none",), ()), ("stablelm-3b", 4, ("none",), ()),
                ("codegen-2b", 4, ("none",), ()), ("codegen-6b", 4, ("none",), ())]
# (model, KV): the families at 2 layers, card against CPU (parity)
FAMILY_PARITY = [("falcon-7b", "none"), ("falcon-7b", "int8"), ("chatglm3-6b", "none"), ("chatglm3-6b", "int8"),
                 ("baichuan2-7b", "none"), ("stablelm-2-1.6b", "none"),
                 ("opt-2.7b", "none"), ("opt-2.7b", "int8"), ("gpt-j-6b", "none"), ("gpt-j-6b", "int8"),
                 ("gpt-neox-20b", "none"), ("stablelm-3b", "none"), ("codegen-2b", "none"), ("codegen-6b", "none"),
                 ("llama-2-7b", "none"), ("llama-2-7b", "int8")]
# the models whose widths the serving, beam and tiered parities also run at
# (D 80 and 256): B5, B6, B7, B9 and B10 inside a model at the new head dims
HEAD_DIM_PARITY = ("opt-2.7b", "gpt-j-6b")


def head_kernel_checks(ca, quantize_kv, cases) -> None:
    """Every attention kernel on the families' paths against its plain
    version at each case's heads (GROUP_HEADS: a kv head's queries take
    several blocks, or straddle flash tiles, and G = 71's last run is ragged;
    HEAD_DIM_HEADS: head dims 80, 96 and 256 on the padded bodies): B1 over
    the prompt (B 16, S 256, left pads), B2 and B3 (past 272, 320- and
    384-slot caches), B7/B8 (the plane holding the token), B6 (a 256-row chunk
    at base 768 of 1024 slots), B5 at C = 1 and 4 (16 rows of 256-272 tokens,
    pages of 16), B9 and B10 (4 groups of 4 beams over a 256-slot prompt, tail
    16). Each case draws from its own generator (check_randn of its label);
    a timed case adds a timing variant of each kernel (kernels at the end,
    beside SDPA over K/V repeated to the N heads, the repeat not timed, and
    the bound from the bytes at the real D)."""
    import torch.nn.functional as F

    from lia_tpu_torch.ops.quant import QuantizedKV, dequantize_kv

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dpads = [0, 3, 7, 15] * 4
    n_keys = [PAST - p for p in dpads]
    past_keys = sum(n_keys)
    for label, Nq, Nkv, Dh, timed in cases:
        G = Nq // Nkv
        errs = {}
        randn = check_randn(label)

        def variant(kernel_name, fn, library, nbytes, ops, parts=1):
            if timed:
                TIME_VARIANTS.append(dict(kernel_name=kernel_name, variant=label, parts=parts, kernel=fn,
                                          library=library, bound=bound(nbytes, ops)))

        def rep(x):  # K/V repeated to the query heads (SDPA's yardstick, not timed)
            return x.repeat_interleave(G, 1)

        # B1: the prompt
        q, k, v = randn(B, PROMPT, Nq, Dh), randn(B, Nkv, PROMPT, Dh), randn(B, Nkv, PROMPT, Dh)
        mask = torch.ones(B, PROMPT, dtype=torch.bool, device="cuda")
        for b, p in enumerate(PADS):
            mask[b, :p] = False
        out = ca.flash_attention_prefill(q, k, v, mask)
        errs["flash_attention_prefill"] = ((out.float() - ca.flash_attention_prefill_plain(q, k, v, mask).float())
                                           * mask[:, :, None, None]).abs().max().item()
        causal = torch.tril(torch.ones(PROMPT, PROMPT, dtype=torch.bool, device="cuda"))
        n_valid = [PROMPT - p for p in PADS]
        variant("flash_attention_prefill", lambda q=q, k=k, v=v, m=mask: ca.flash_attention_prefill(q, k, v, m),
                lambda qt=q.transpose(1, 2), kr=rep(k), vr=rep(v), am=(causal[None] & mask[:, None, :])[:, None]:
                F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                sum(n_valid) * (Nq + 2 * Nkv) * Dh * 2 + q.numel() * 2 + mask.numel(),
                4 * Dh * Nq * sum(n * (n + 1) / 2 for n in n_valid),
                ca.flash_split_parts(B, PROMPT, Nq, Nkv, PROMPT, sms))

        # B2, B7/B8 and B3: decode over layer 1 of a 2-layer cache
        ln = torch.tensor(PAST, dtype=torch.int32, device="cuda")
        qd, kf, vf = randn(B, 1, Nq, Dh), randn(B, Nkv, 1, Dh), randn(B, Nkv, 1, Dh)
        sm = torch.zeros(B, 384, dtype=torch.bool, device="cuda")
        for b, p in enumerate(dpads):
            sm[b, p:PAST] = True
        kc, vc = randn(2, B, Nkv, 384, Dh), randn(2, B, Nkv, 384, Dh)
        args = (qd, kf, vf, kc, vc, 1, sm, ln)
        plane_parts = ca.plane_plan(B, Nq, Nkv, 384, True, sms, Dh).parts  # the plane or bf16 beam body, maybe split
        errs["decode_attention_fresh"] = (ca.decode_attention_fresh(*args).float()
                                          - ca.decode_attention_fresh_plain(*args).float()).abs().max().item()
        kp, vp = kc[1].clone(), vc[1].clone()
        kp[:, :, PAST], vp[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
        sm_inc = sm.clone()
        sm_inc[:, PAST] = True
        ln_inc = torch.tensor(PAST + 1, dtype=torch.int32, device="cuda")
        qdt, dmask = qd.transpose(1, 2), sm_inc[:, None, None, :]
        io = 2 * qd.numel() * 2 + 2 * kf.numel() * 2 + 4  # q and out, the fresh k/v, the length
        variant("decode_attention_fresh", lambda a=args: ca.decode_attention_fresh(*a),
                lambda qt=qdt, kr=rep(kp), vr=rep(vp), am=dmask: F.scaled_dot_product_attention(qt, kr, vr,
                                                                                                attn_mask=am),
                past_keys * Nkv * Dh * 2 * 2 + io + sm.numel(), 4 * Dh * Nq * (past_keys + B), plane_parts)
        out = ca.decode_attention(qd, kp, vp, sm_inc, ln_inc)
        errs["decode_attention"] = (out.float() - ca.decode_attention_plain(qd, kp, vp, sm_inc, ln_inc).float()
                                    ).abs().max().item()
        kc_inc, vc_inc = kc.clone(), vc.clone()
        kc_inc[1], vc_inc[1] = kp, vp
        errs["decode_attention_stacked"] = (ca.decode_attention_stacked(qd, kc_inc, vc_inc, 1, sm_inc, ln_inc).float()
                                            - out.float()).abs().max().item()
        plane_keys = past_keys + B
        variant("decode_attention", lambda a=(qd, kp, vp, sm_inc, ln_inc): ca.decode_attention(*a),
                lambda qt=qdt, kr=rep(kp), vr=rep(vp), am=dmask: F.scaled_dot_product_attention(qt, kr, vr,
                                                                                                attn_mask=am),
                plane_keys * Nkv * Dh * 2 * 2 + 2 * qd.numel() * 2 + 4 + sm.numel(), 4 * Dh * Nq * plane_keys,
                plane_parts)
        kq = quantize_kv(randn(2, B, Nkv, 384, Dh, dtype=torch.float32))
        vq = quantize_kv(randn(2, B, Nkv, 384, Dh, dtype=torch.float32))
        args8 = (qd, kf, vf, kq.q, kq.s, vq.q, vq.s, 1, sm, ln)
        errs["decode_attention_fresh_int8"] = (ca.decode_attention_fresh_int8(*args8).float()
                                               - ca.decode_attention_fresh_int8_plain(*args8).float()
                                               ).abs().max().item()
        kd, vd = (dequantize_kv(QuantizedKV(c.q[1], c.s[1])) for c in (kq, vq))
        kd[:, :, PAST], vd[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
        variant("decode_attention_fresh_int8", lambda a=args8: ca.decode_attention_fresh_int8(*a),
                lambda qt=qdt, kr=rep(kd), vr=rep(vd), am=dmask: F.scaled_dot_product_attention(qt, kr, vr,
                                                                                                attn_mask=am),
                past_keys * Nkv * (Dh + 4) * 2 + io + sm.numel(), 4 * Dh * Nq * (past_keys + B),
                ca.int8_decode_parts(B, Nq, Nkv, 384, sms))

        # B6: a 256-row chunk at base 768 of a 1024-slot plane
        C, base = 256, 768
        qc, kcc, vcc = randn(1, C, Nq, Dh), randn(1, Nkv, 1024, Dh), randn(1, Nkv, 1024, Dh)
        smc = torch.zeros(1, 1024, dtype=torch.bool, device="cuda")
        smc[0, : base + C] = True
        bt = torch.tensor(base, dtype=torch.int32, device="cuda")
        out = ca.flash_attention_cached(qc, kcc, vcc, bt, smc)
        errs["flash_attention_cached"] = (out.float() - ca.flash_attention_cached_plain(qc, kcc, vcc, bt, smc).float()
                                          ).abs().max().item()
        cmask = (torch.arange(1024, device="cuda")[None, :] <= base + torch.arange(C, device="cuda")[:, None])
        variant("flash_attention_cached", lambda a=(qc, kcc, vcc, bt, smc): ca.flash_attention_cached(*a),
                lambda qt=qc.transpose(1, 2), kr=rep(kcc), vr=rep(vcc), am=cmask[None, None]:
                F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                (base + C) * Nkv * Dh * 2 * 2 + 2 * qc.numel() * 2 + smc.numel(),
                4 * Dh * Nq * sum(base + t + 1 for t in range(C)), ca.flash_split_parts(1, C, Nq, Nkv, 1024, sms))

        # B5: paged decode at C = 1 and 4 with the fresh chunk merged
        lengths = [PAST - p for p in dpads]
        for Cp in (1, 4):
            pq, pk, pv, table, lens, pkf, pvf = paged_case(randn, lengths, Cp, Nkv, G, Dh)
            pargs = (pq, pk, pv, 1, table, lens, pkf, pvf)
            errs[f"paged_decode_attention C={Cp}"] = (ca.paged_decode_attention(*pargs).float()
                                                      - ca.paged_decode_attention_plain(*pargs).float()
                                                      ).abs().max().item()
            keys = sum(lengths) + B * Cp
            S = table.shape[1] * SERVE_BLOCK  # SDPA over each row's pages gathered, then the fresh chunk
            kg = torch.cat([pk[1][table.long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, Dh), pkf], 2)
            vg = torch.cat([pv[1][table.long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, Dh), pvf], 2)
            am = torch.cat([(torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, :].expand(B, Cp, S),
                            torch.tril(torch.ones(Cp, Cp, dtype=torch.bool, device="cuda")).expand(B, Cp, Cp)], 2)
            variant("paged_decode_attention", lambda a=pargs: ca.paged_decode_attention(*a),
                    lambda qt=pq.transpose(1, 2), kr=rep(kg), vr=rep(vg), am=am[:, None]:
                    F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                    keys * Nkv * Dh * 2 * 2 + 2 * pq.numel() * 2 + table.numel() * 4,
                    4 * Dh * Nq * Cp * keys, ca.paged_split_parts(B, Cp, Nq, Nkv, table.shape[1], sms))
            if timed:
                TIME_VARIANTS[-1]["variant"] = f"{label}, C={Cp}"

        # B9 and B10: 4 groups of 4 beams over a 256-slot prompt, tail 16
        Bb = BEAM_GROUPS * BEAM_NB
        bq, bkf, bvf = randn(Bb, 1, Nq, Dh), randn(Bb, Nkv, 1, Dh), randn(Bb, Nkv, 1, Dh)
        pm = torch.zeros(BEAM_GROUPS, BEAM_PROMPT, dtype=torch.bool, device="cuda")
        for g, p in enumerate(BEAM_PADS):
            pm[g, p:] = True
        lens_b = (pm, torch.tensor(BEAM_PROMPT, dtype=torch.int32, device="cuda"),
                  torch.tensor(BEAM_TLEN, dtype=torch.int32, device="cuda"), BEAM_NB)
        prompt_keys = sum(BEAM_PROMPT - p for p in BEAM_PADS)
        beam_keys = BEAM_NB * prompt_keys + Bb * BEAM_TLEN
        for int8 in (False, True):
            T_max = 128 if int8 else 32
            if int8:
                planes = [x for rows, S in ((BEAM_GROUPS, BEAM_PROMPT), (Bb, T_max)) for _ in range(2)
                          for x in quantize_kv(randn(2, rows, Nkv, S, Dh, dtype=torch.float32))]
                kernel, plain, row_bytes = ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain, Dh + 4
            else:
                planes = [randn(2, rows, Nkv, S, Dh) for rows, S in ((BEAM_GROUPS, BEAM_PROMPT), (Bb, T_max))
                          for _ in range(2)]
                kernel, plain, row_bytes = ca.decode_beam_attention, ca.decode_beam_attention_plain, 2 * Dh
            bargs = (bq, bkf, bvf, *planes, 1, *lens_b)
            errs[kernel.__name__] = (kernel(*bargs).float() - plain(*bargs).float()).abs().max().item()
            # SDPA over each beam's [group prompt | tail | fresh] (int8: dequantized to bf16)
            if int8:
                kpp, vpp, ktt, vtt = (dequantize_kv(QuantizedKV(c[1], sc[1])) for c, sc in zip(planes[0::2],
                                                                                              planes[1::2]))
            else:
                kpp, vpp, ktt, vtt = (x[1] for x in planes)
            group = torch.arange(Bb, device="cuda") // BEAM_NB
            tail_ok = (torch.arange(T_max, device="cuda") < BEAM_TLEN)[None].expand(Bb, T_max)
            am = torch.cat([pm[group], tail_ok, torch.ones(Bb, 1, dtype=torch.bool, device="cuda")], 1)
            variant(kernel.__name__, lambda kernel=kernel, a=bargs: kernel(*a),
                    lambda qt=bq.transpose(1, 2), kr=rep(torch.cat([kpp[group], ktt, bkf], 2)),
                    vr=rep(torch.cat([vpp[group], vtt, bvf], 2)), am=am[:, None, None]:
                    F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                    (prompt_keys + Bb * BEAM_TLEN) * Nkv * row_bytes * 2 + 2 * bq.numel() * 2 + 2 * bkf.numel() * 2
                    + pm.numel() + 8, 4 * Dh * Nq * (beam_keys + Bb))
        torch.cuda.synchronize()
        for kernel, err in errs.items():
            emit({"phase": "kernel_check", "kernel": kernel, "variant": label, "max_abs_err": err, "tol": KERNEL_TOL})
            check(err == err and err <= KERNEL_TOL, f"{kernel} {label}: max abs err {err} > {KERNEL_TOL}")


# (label, N, N_kv, D, timed): the ALiBi families' heads: MPT-7B's (timed with
# and without slopes), MPT-30B's at D = 112 (timed) and Baichuan-13B's 40
# (the odd-tail slopes)
ALIBI_HEADS = [("mpt-7b heads (N 32, N_kv 32, D 128)", 32, 32, 128, True),
               ("mpt-30b heads D=112 (N 64, N_kv 64)", 64, 64, 112, True),
               ("baichuan-13b heads (N 40, N_kv 40, D 128)", 40, 40, 128, False)]


def alibi_kernel_checks(ca, quantize_kv, cases) -> None:
    """Every attention kernel with ALiBi slopes against its plain version
    (the reference's [B, N, S] bias: each slot's rank, the beam tail's
    real_len + t, the paged keys' logical index) at each case's heads, on
    left-padded rows (row 0 starts at slot 0, the others later): B1 over the
    prompt (B 16, S 256), B6 over a 256-row chunk at base 768 of 1024 slots
    (two rows, one padded by 100), B2 and B7/B8 (past 272 in a 384-slot
    plane) on the host's route and forced to 1 and 3 parts, B3 with its
    split forced to 1 and 3, B5 at C = 1 and 5 (16 rows of 256-272 tokens,
    pages of 16), B9 and B10 (4 groups of 4 beams over a 256-slot prompt,
    tail 16 of a 32-slot bf16 / 128-slot int8 tail). An output agrees where
    |kernel - plain| <= KERNEL_TOL * max(1, |plain|): the bias puts most of a
    head's weight on its last keys, so outputs reach the V rows' own
    magnitude (several units), where one bf16 rounding step exceeds
    KERNEL_TOL. A timed case adds a timing variant of each kernel with slopes
    (and, at MPT-7B's heads, the same call without them), beside SDPA with
    the bias as an additive float mask over K/V repeated to the N heads (the
    mask and the repeat not timed), and the bound from the bytes at the real
    D plus the slopes."""
    import torch.nn.functional as F

    from lia_tpu_torch.ops.attention import alibi_slopes
    from lia_tpu_torch.ops.quant import QuantizedKV, dequantize_kv

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dpads = [0, 3, 7, 15] * 4
    n_keys = [PAST - p for p in dpads]
    past_keys = sum(n_keys)
    for label, Nq, Nkv, Dh, timed in cases:
        G = Nq // Nkv
        sl = alibi_slopes(Nq, "cuda")
        errs = {}
        randn = check_randn(f"alibi {label}")
        both = timed and Nq == 32

        def rel_err(name, out, ref, valid=None):
            d = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)
            if valid is not None:
                d = d * valid
            a = (out.float() - ref.float()).abs()
            errs[name] = (d.max().item(), (a if valid is None else a * valid).max().item())

        def variant(kernel_name, fn, unbiased, library, nbytes, ops, parts=1):
            """fn: the kernel with slopes; unbiased: the same call without them."""
            if timed:
                TIME_VARIANTS.append(dict(kernel_name=kernel_name, variant=f"{label}, ALiBi", parts=parts, kernel=fn,
                                          library=library, bound=bound(nbytes + Nq * 4, ops)))
            if both:
                TIME_VARIANTS.append(dict(kernel_name=kernel_name, variant=f"{label}, no slopes", parts=parts,
                                          kernel=unbiased, library=None,
                                          bound=bound(nbytes, ops - 2 * ops / (4 * Dh + 2))))

        def rep(x):  # K/V repeated to the query heads (SDPA's yardstick, not timed)
            return x.repeat_interleave(G, 1)

        def bias_mask(allow, key_pos):
            """SDPA's additive float mask [B, N, Sq, Sk]: the bias at the
            allowed keys (allow [B, Sq, Sk]), -inf elsewhere (bf16)."""
            b = (sl[None, :, None, None] * key_pos.float()[:, None, None, :]).expand(-1, -1, allow.shape[1], -1)
            return b.masked_fill(~allow[:, None], float("-inf")).to(torch.bfloat16)

        # B1: the prompt
        q, k, v = randn(B, PROMPT, Nq, Dh), randn(B, Nkv, PROMPT, Dh), randn(B, Nkv, PROMPT, Dh)
        mask = torch.ones(B, PROMPT, dtype=torch.bool, device="cuda")
        for b, p in enumerate(PADS):
            mask[b, :p] = False
        rel_err("flash_attention_prefill", ca.flash_attention_prefill(q, k, v, mask, slopes=sl),
                ca.flash_attention_prefill_plain(q, k, v, mask, slopes=sl), mask[:, :, None, None])
        causal = torch.tril(torch.ones(PROMPT, PROMPT, dtype=torch.bool, device="cuda"))
        rank = (mask.cumsum(1) - 1).clamp(min=0)
        n_valid = [PROMPT - p for p in PADS]
        variant("flash_attention_prefill", lambda a=(q, k, v, mask), sl=sl: ca.flash_attention_prefill(*a, slopes=sl),
                lambda a=(q, k, v, mask): ca.flash_attention_prefill(*a),
                lambda qt=q.transpose(1, 2), kr=rep(k), vr=rep(v), am=bias_mask(causal[None] & mask[:, None, :], rank):
                F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                sum(n_valid) * (Nq + 2 * Nkv) * Dh * 2 + q.numel() * 2 + mask.numel(),
                (4 * Dh + 2) * Nq * sum(n * (n + 1) / 2 for n in n_valid),
                ca.flash_split_parts(B, PROMPT, Nq, Nkv, PROMPT, sms))

        # B6: a 256-row chunk at base 768 of a 1024-slot plane, row 1 padded by 100
        C, base = 256, 768
        qc, kcc, vcc = randn(2, C, Nq, Dh), randn(2, Nkv, 1024, Dh), randn(2, Nkv, 1024, Dh)
        smc = torch.zeros(2, 1024, dtype=torch.bool, device="cuda")
        smc[0, : base + C], smc[1, 100: base + C] = True, True
        bt = torch.tensor(base, dtype=torch.int32, device="cuda")
        rel_err("flash_attention_cached", ca.flash_attention_cached(qc, kcc, vcc, bt, smc, slopes=sl),
                ca.flash_attention_cached_plain(qc, kcc, vcc, bt, smc, slopes=sl))
        kpos = torch.arange(1024, device="cuda")
        callow = (kpos[None, :] <= base + torch.arange(C, device="cuda")[:, None])[None] & smc[:, None, :]
        variant("flash_attention_cached",
                lambda a=(qc, kcc, vcc, bt, smc), sl=sl: ca.flash_attention_cached(*a, slopes=sl),
                lambda a=(qc, kcc, vcc, bt, smc): ca.flash_attention_cached(*a),
                lambda qt=qc.transpose(1, 2), kr=rep(kcc), vr=rep(vcc),
                am=bias_mask(callow, (smc.cumsum(1) - 1).clamp(min=0)):
                F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                (2 * (base + C) - 100) * Nkv * Dh * 2 * 2 + 2 * qc.numel() * 2 + smc.numel(),
                (4 * Dh + 2) * Nq * sum(base + t + 1 - p for t in range(C) for p in (0, 100)),
                ca.flash_split_parts(2, C, Nq, Nkv, 1024, sms))

        # B2, B7/B8 and B3: decode over layer 1 of a 2-layer 384-slot cache
        ln = torch.tensor(PAST, dtype=torch.int32, device="cuda")
        qd, kf, vf = randn(B, 1, Nq, Dh), randn(B, Nkv, 1, Dh), randn(B, Nkv, 1, Dh)
        sm = torch.zeros(B, 384, dtype=torch.bool, device="cuda")
        for b, p in enumerate(dpads):
            sm[b, p:PAST] = True
        kc, vc = randn(2, B, Nkv, 384, Dh), randn(2, B, Nkv, 384, Dh)
        args = (qd, kf, vf, kc, vc, 1, sm, ln)
        kp, vp = kc[1].clone(), vc[1].clone()
        kp[:, :, PAST], vp[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
        sm_inc = sm.clone()
        sm_inc[:, PAST] = True
        ln_inc = torch.tensor(PAST + 1, dtype=torch.int32, device="cuda")
        kc_inc, vc_inc = kc.clone(), vc.clone()
        kc_inc[1], vc_inc[1] = kp, vp
        ref2 = ca.decode_attention_fresh_plain(*args, slopes=sl)
        ref7 = ca.decode_attention_plain(qd, kp, vp, sm_inc, ln_inc, slopes=sl)
        for parts in (None, 1, 3):
            tag = "" if parts is None else f" parts={parts}"
            rel_err(f"decode_attention_fresh{tag}", plane_forced(ca, lambda: ca.decode_attention_fresh(
                *args, slopes=sl), parts)(), ref2)
            rel_err(f"decode_attention{tag}", plane_forced(ca, lambda: ca.decode_attention(
                qd, kp, vp, sm_inc, ln_inc, slopes=sl), parts)(), ref7)
        rel_err("decode_attention_stacked", ca.decode_attention_stacked(qd, kc_inc, vc_inc, 1, sm_inc, ln_inc,
                                                                        slopes=sl), ref7)
        plane_parts = ca.plane_plan(B, Nq, Nkv, 384, True, sms, Dh).parts
        qdt = qd.transpose(1, 2)
        dam = bias_mask(sm_inc[:, None, :], (sm_inc.cumsum(1) - 1).clamp(min=0))
        io = 2 * qd.numel() * 2 + 2 * kf.numel() * 2 + 4
        variant("decode_attention_fresh", lambda a=args, sl=sl: ca.decode_attention_fresh(*a, slopes=sl),
                lambda a=args: ca.decode_attention_fresh(*a),
                lambda qt=qdt, kr=rep(kp), vr=rep(vp), am=dam: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                past_keys * Nkv * Dh * 2 * 2 + io + sm.numel(), (4 * Dh + 2) * Nq * (past_keys + B), plane_parts)
        plane_keys = past_keys + B
        variant("decode_attention", lambda a=(qd, kp, vp, sm_inc, ln_inc), sl=sl: ca.decode_attention(*a, slopes=sl),
                lambda a=(qd, kp, vp, sm_inc, ln_inc): ca.decode_attention(*a),
                lambda qt=qdt, kr=rep(kp), vr=rep(vp), am=dam: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                plane_keys * Nkv * Dh * 2 * 2 + 2 * qd.numel() * 2 + 4 + sm.numel(), (4 * Dh + 2) * Nq * plane_keys,
                plane_parts)
        kq = quantize_kv(randn(2, B, Nkv, 384, Dh, dtype=torch.float32))
        vq = quantize_kv(randn(2, B, Nkv, 384, Dh, dtype=torch.float32))
        args8 = (qd, kf, vf, kq.q, kq.s, vq.q, vq.s, 1, sm, ln)
        ref3 = ca.decode_attention_fresh_int8_plain(*args8, slopes=sl)
        for parts in (None, 1, 3):
            tag = "" if parts is None else f" parts={parts}"
            rel_err(f"decode_attention_fresh_int8{tag}", split_forced(ca, parts, lambda: ca.decode_attention_fresh_int8(
                *args8, slopes=sl), "int8_split_parts")(), ref3)
        kd, vd = (dequantize_kv(QuantizedKV(c.q[1], c.s[1])) for c in (kq, vq))
        kd[:, :, PAST], vd[:, :, PAST] = kf[:, :, 0], vf[:, :, 0]
        variant("decode_attention_fresh_int8", lambda a=args8, sl=sl: ca.decode_attention_fresh_int8(*a, slopes=sl),
                lambda a=args8: ca.decode_attention_fresh_int8(*a),
                lambda qt=qdt, kr=rep(kd), vr=rep(vd), am=dam: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                past_keys * Nkv * (Dh + 4) * 2 + io + sm.numel(), (4 * Dh + 2) * Nq * (past_keys + B),
                ca.int8_decode_parts(B, Nq, Nkv, 384, sms))

        # B5: paged decode at C = 1 and 5 with the fresh chunk merged
        for Cp in (1, 5):
            pq, pk, pv, table, lens, pkf, pvf = paged_case(randn, n_keys, Cp, Nkv, G, Dh)
            pargs = (pq, pk, pv, 1, table, lens, pkf, pvf)
            rel_err(f"paged_decode_attention C={Cp}", ca.paged_decode_attention(*pargs, slopes=sl),
                    ca.paged_decode_attention_plain(*pargs, slopes=sl))
            if Cp == 1:
                keys = past_keys + B
                S = table.shape[1] * SERVE_BLOCK  # SDPA over each row's pages gathered, then the fresh token
                kg = torch.cat([pk[1][table.long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, Dh), pkf], 2)
                vg = torch.cat([pv[1][table.long()].permute(0, 2, 1, 3, 4).reshape(B, Nkv, S, Dh), pvf], 2)
                allow = torch.cat([torch.arange(S, device="cuda")[None, :] < lens[:, None],
                                   torch.ones(B, 1, dtype=torch.bool, device="cuda")], 1)
                lpos = torch.cat([torch.arange(S, device="cuda")[None, :].expand(B, S), lens[:, None]], 1)
                variant("paged_decode_attention", lambda a=pargs, sl=sl: ca.paged_decode_attention(*a, slopes=sl),
                        lambda a=pargs: ca.paged_decode_attention(*a),
                        lambda qt=pq.transpose(1, 2), kr=rep(kg), vr=rep(vg), am=bias_mask(allow[:, None, :], lpos):
                        F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                        keys * Nkv * Dh * 2 * 2 + 2 * pq.numel() * 2 + table.numel() * 4,
                        (4 * Dh + 2) * Nq * keys, ca.paged_split_parts(B, 1, Nq, Nkv, table.shape[1], sms))

        # B9 and B10: 4 groups of 4 beams over a 256-slot prompt, tail 16
        Bb = BEAM_GROUPS * BEAM_NB
        bq, bkf, bvf = randn(Bb, 1, Nq, Dh), randn(Bb, Nkv, 1, Dh), randn(Bb, Nkv, 1, Dh)
        pm = torch.zeros(BEAM_GROUPS, BEAM_PROMPT, dtype=torch.bool, device="cuda")
        for g, p in enumerate(BEAM_PADS):
            pm[g, p:] = True
        lens_b = (pm, torch.tensor(BEAM_PROMPT, dtype=torch.int32, device="cuda"),
                  torch.tensor(BEAM_TLEN, dtype=torch.int32, device="cuda"), BEAM_NB)
        prompt_keys = sum(BEAM_PROMPT - p for p in BEAM_PADS)
        beam_keys = BEAM_NB * prompt_keys + Bb * BEAM_TLEN
        group = torch.arange(Bb, device="cuda") // BEAM_NB
        for int8 in (False, True):
            T_max = 128 if int8 else 32
            if int8:
                planes = [x for rows, S in ((BEAM_GROUPS, BEAM_PROMPT), (Bb, T_max)) for _ in range(2)
                          for x in quantize_kv(randn(2, rows, Nkv, S, Dh, dtype=torch.float32))]
                kernel, plain, row_bytes = ca.decode_beam_attention_int8, ca.decode_beam_attention_int8_plain, Dh + 4
                kpp, vpp, ktt, vtt = (dequantize_kv(QuantizedKV(c[1], s_[1])) for c, s_ in zip(planes[0::2],
                                                                                             planes[1::2]))
            else:
                planes = [randn(2, rows, Nkv, S, Dh) for rows, S in ((BEAM_GROUPS, BEAM_PROMPT), (Bb, T_max))
                          for _ in range(2)]
                kernel, plain, row_bytes = ca.decode_beam_attention, ca.decode_beam_attention_plain, 2 * Dh
                kpp, vpp, ktt, vtt = (x[1] for x in planes)
            bargs = (bq, bkf, bvf, *planes, 1, *lens_b)
            rel_err(kernel.__name__, kernel(*bargs, slopes=sl), plain(*bargs, slopes=sl))
            tail_ok = (torch.arange(T_max, device="cuda") < BEAM_TLEN)[None].expand(Bb, T_max)
            ballow = torch.cat([pm[group], tail_ok, torch.ones(Bb, 1, dtype=torch.bool, device="cuda")], 1)
            bpos = ca._beam_positions(ballow[:, :-1], BEAM_PROMPT, T_max)
            variant(kernel.__name__, lambda kernel=kernel, a=bargs, sl=sl: kernel(*a, slopes=sl),
                    lambda kernel=kernel, a=bargs: kernel(*a),
                    lambda qt=bq.transpose(1, 2), kr=rep(torch.cat([kpp[group], ktt, bkf], 2)),
                    vr=rep(torch.cat([vpp[group], vtt, bvf], 2)), am=bias_mask(ballow[:, None, :], bpos):
                    F.scaled_dot_product_attention(qt, kr, vr, attn_mask=am),
                    (prompt_keys + Bb * BEAM_TLEN) * Nkv * row_bytes * 2 + 2 * bq.numel() * 2 + 2 * bkf.numel() * 2
                    + pm.numel() + 8, (4 * Dh + 2) * Nq * (beam_keys + Bb))
        torch.cuda.synchronize()
        for kernel, (rel, err) in errs.items():
            emit({"phase": "kernel_check", "kernel": kernel, "variant": f"{label}, ALiBi", "max_abs_err": err,
                  "max_err_over_max_1_abs_plain": rel, "tol": KERNEL_TOL})
            check(rel == rel and rel <= KERNEL_TOL,
                  f"{kernel} {label} ALiBi: err {rel} > {KERNEL_TOL} x max(1, |plain|)")


def families_phase(ca, cm) -> dict:
    """FAMILY_CELLS through generate(fused=True) over 16 prompts x 256 tokens,
    32 new tokens, bf16 weights drawn on the card: Falcon-7B at full width and
    depth (H 4544, 71 heads over one KV head, D 64, F 18176, vocab 65024, 32
    layers) with bf16 and int8 KV; ChatGLM3-6B (G = 16), Baichuan2-7B and
    StableLM-2-1.6B at full width and 4 layers with bf16 KV; the head dims
    80, 96 and 256 at full width: OPT-2.7B (D 80, 32 layers) with bf16 and
    int8 KV, GPT-J-6B (D 256, 28 layers) with both, GPT-NeoX-20B (D 96, H
    6144, 44 layers, ~40 GB) with bf16 KV, and StableLM-3B (D 80), CodeGen-2B
    (D 80) and CodeGen-6B (D 256) at 4 layers. Exact launches (L flash
    prefills, L * 31 decode-attention launches, no fused MLP: its gate is
    off), no plain version on the card, prefill ms and decode tokens/s
    (Falcon-7B's bf16-KV run and OPT-2.7B's the median of 3), with the card's
    name and power limit."""
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    smi = nvidia_smi()
    out = {}
    for name, layers, kvs, timed in FAMILY_CELLS:
        cfg = get_config(name)
        cfg = cfg if layers is None else cfg.replace(num_layers=layers)
        held = [device_dummy_params(cfg, seed=0)]  # the last run's engine takes the only reference
        emit({"phase": "family_weights", "model": name, "layers": cfg.num_layers, "gb": tree_bytes(held[0]) / 1e9,
              "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim], "card": smi})
        prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (16, PROMPT)).tolist()
        for i, kv in enumerate(kvs):
            label = f"{name}{'' if layers is None else f' {layers} layers'}, {'bf16' if kv == 'none' else kv} KV"
            make = held.pop if i == len(kvs) - 1 else (lambda: held[0])
            out.update(main_path(ca, cm, label, cfg, make, prompts, kv, {}, timed=kv in timed))
        torch.cuda.empty_cache()
    return {name: counts for name, (counts, _) in out.items()}


# the ALiBi families' parity models at 4 layers, card against CPU (MPT-7B's
# on every path besides)
ALIBI_PARITY = ("bloom-7b1", "baichuan-13b", "baichuan2-13b")
ALIBI_TIER_PARITY = TIER_PARITY[0:1] + TIER_PARITY[2:3]  # policy 3 and the host-attention tier 0/2
MPT30_INT8_LAYERS = 8  # MPT-30B over int8 KV at a cut depth (the bf16 run is the full model)


def alibi_phase(ca, cm, models=("mpt-7b",)) -> dict:
    """The slice's main path, the ALiBi families at full width through
    generate(fused=True) over 16 prompts x 256 tokens, 32 new tokens, bf16
    weights drawn on the card. ``mpt-7b``: full depth (H 4096, 32 heads of
    D 128, F 16384, vocab 50368, 32 layers) with bf16 KV, timed, the
    fused-MLP gate off and on in turns (B14 with exact gelu at every decode
    step's layers: 992 launches), and with int8 KV. ``mpt-30b``: full depth
    (H 7168, 64 heads of D 112, F 28672, 48 layers, ~59.9 GB of weights)
    with bf16 KV, then over int8 KV at MPT30_INT8_LAYERS layers; it runs
    first in the script, before the kernel checks' inputs (held for the
    timing phase) take the card's memory: fusing its projections holds
    ~75 GB for a moment. Exact launches (L flash prefills, L * 31 decode
    launches), no plain version on the card. Returns each run's launches."""
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    smi = nvidia_smi()
    out = {}
    steps = NEW_TOKENS - 1
    for name in models:
        cfg = get_config(name)
        kvs = ("none", "int8") if name == "mpt-7b" else ("none",)
        held = [device_dummy_params(cfg, seed=0)]  # the last run's engine takes the only reference
        emit({"phase": "family_weights", "model": name, "layers": cfg.num_layers, "gb": tree_bytes(held[0]) / 1e9,
              "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim], "alibi": cfg.alibi, "card": smi})
        prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (16, PROMPT)).tolist()
        for i, kv in enumerate(kvs):
            make = held.pop if i == len(kvs) - 1 else (lambda: held[0])
            timed = name == "mpt-7b" and kv == "none"
            ab = ("fused_mlp", {"fused_mlp": cfg.num_layers * steps}) if timed else None
            out.update(main_path(ca, cm, f"{name}, {'bf16' if kv == 'none' else kv} KV", cfg, make, prompts, kv, {},
                                 timed=timed, ab=ab))
        torch.cuda.empty_cache()
        if name == "mpt-30b":
            cut = cfg.replace(num_layers=MPT30_INT8_LAYERS)
            out.update(main_path(ca, cm, f"mpt-30b {MPT30_INT8_LAYERS} layers, int8 KV", cut,
                                 lambda: device_dummy_params(cut, seed=0), prompts, "int8", {}, timed=False))
            torch.cuda.empty_cache()
    return {name: counts for name, (counts, _) in out.items()}


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def falcon_hf_state_dict(cfg, tree) -> dict:
    """A Falcon tree in the Hugging Face key layout, as CPU tensors: the fused
    query_key_value [(N + 2) D, H] = [q heads | k | v], [out, in] linears,
    tied embeddings (the inverse of the port's converter)."""
    sd = {"transformer.word_embeddings.weight": tree["embed_tokens"],
          "transformer.ln_f.weight": tree["final_norm"]["scale"], "transformer.ln_f.bias": tree["final_norm"]["bias"]}
    lay = tree["layers"]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        sd[p + "input_layernorm.weight"] = lay["ln1"]["scale"][i]
        sd[p + "input_layernorm.bias"] = lay["ln1"]["bias"][i]
        sd[p + "self_attention.query_key_value.weight"] = torch.cat(
            [lay["attn"][w][i].T for w in ("wq", "wk", "wv")], dim=0)
        sd[p + "self_attention.dense.weight"] = lay["attn"]["wo"][i].T
        sd[p + "mlp.dense_h_to_4h.weight"] = lay["mlp"]["w1"][i].T
        sd[p + "mlp.dense_4h_to_h.weight"] = lay["mlp"]["w2"][i].T
    return {k: v.contiguous().cpu() for k, v in sd.items()}


def codegen_hf_state_dict(cfg, tree) -> dict:
    """A CodeGen tree in the Hugging Face key layout, as CPU tensors: the fused
    qkv_proj [3H, H] in mp_num = 4 blocks, each [q | v | k] chunks of H / 4
    rows; [out, in] linears; the biased MLP and lm_head (the inverse of the
    port's converter)."""
    H, mp = cfg.hidden_size, 4
    sd = {"transformer.wte.weight": tree["embed_tokens"], "transformer.ln_f.weight": tree["final_norm"]["scale"],
          "transformer.ln_f.bias": tree["final_norm"]["bias"], "lm_head.weight": tree["lm_head"].T,
          "lm_head.bias": tree["lm_head_bias"]}
    lay = tree["layers"]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        sd[p + "ln_1.weight"], sd[p + "ln_1.bias"] = lay["ln1"]["scale"][i], lay["ln1"]["bias"][i]
        q, k, v = (lay["attn"][w][i].T.reshape(mp, H // mp, H) for w in ("wq", "wk", "wv"))
        sd[p + "attn.qkv_proj.weight"] = torch.stack([q, v, k], dim=1).reshape(3 * H, H)
        sd[p + "attn.out_proj.weight"] = lay["attn"]["wo"][i].T
        sd[p + "mlp.fc_in.weight"], sd[p + "mlp.fc_in.bias"] = lay["mlp"]["w1"][i].T, lay["mlp"]["b1"][i]
        sd[p + "mlp.fc_out.weight"], sd[p + "mlp.fc_out.bias"] = lay["mlp"]["w2"][i].T, lay["mlp"]["b2"][i]
    return {k: v.contiguous().cpu() for k, v in sd.items()}


def gptbigcode_hf_state_dict(cfg, tree) -> dict:
    """A GPTBigCode tree in the Hugging Face key layout, as CPU tensors: the
    fused c_attn [H + 2D, H] = [q heads | k | v] with its bias, [out, in]
    linears, learned positions, tied embeddings (the inverse of the port's
    converter)."""
    sd = {"transformer.wte.weight": tree["embed_tokens"], "transformer.wpe.weight": tree["embed_positions"],
          "transformer.ln_f.weight": tree["final_norm"]["scale"], "transformer.ln_f.bias": tree["final_norm"]["bias"]}
    lay = tree["layers"]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        for ln in ("ln1", "ln2"):
            sd[f"{p}ln_{ln[-1]}.weight"], sd[f"{p}ln_{ln[-1]}.bias"] = lay[ln]["scale"][i], lay[ln]["bias"][i]
        a = lay["attn"]
        sd[p + "attn.c_attn.weight"] = torch.cat([a[w][i].T for w in ("wq", "wk", "wv")], dim=0)
        sd[p + "attn.c_attn.bias"] = torch.cat([a[b][i] for b in ("bq", "bk", "bv")])
        sd[p + "attn.c_proj.weight"], sd[p + "attn.c_proj.bias"] = a["wo"][i].T, a["bo"][i]
        m = lay["mlp"]
        sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = m["w1"][i].T, m["b1"][i]
        sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = m["w2"][i].T, m["b2"][i]
    return {k: v.contiguous().cpu() for k, v in sd.items()}


def hf_round_trip(d, case: str, cfg, tree, sd, tokens) -> None:
    """``sd`` (``tree`` in the Hugging Face layout) written to directory ``d``
    as two safetensors shards (layer 1 and the final norm in the second), read
    back by load_hf_checkpoint: equal to params_from_hf_state_dict on the same
    dict and to ``tree``, and giving ``tree``'s tokens (``tokens(cfg, tree)``).
    Emits the save's and load's seconds and GB/s."""
    import os

    from lia_tpu_torch.utils import safetensors as st
    from lia_tpu_torch.utils.checkpoint import load_hf_checkpoint, params_from_hf_state_dict, to_device

    ref = tokens(cfg, tree)
    keys = sorted(sd)
    shards = [[k for k in keys if ".h.1." not in k and "ln_f" not in k], [k for k in keys if ".h.1." in k
                                                                            or "ln_f" in k]]
    t0 = time.perf_counter()
    for i, part in enumerate(shards):
        st.save_file({k: sd[k] for k in part}, os.path.join(d, f"model-0000{i + 1}-of-00002.safetensors"),
                     metadata={"format": "pt"})
    t_save = time.perf_counter() - t0
    gb = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e9
    t0 = time.perf_counter()
    loaded = load_hf_checkpoint(cfg, d)
    t_load = time.perf_counter() - t0
    check(_trees_equal(loaded, params_from_hf_state_dict(cfg, sd)),
          f"{cfg.name}: load_hf_checkpoint differs from params_from_hf_state_dict")
    check(_trees_equal(loaded, tree), f"{cfg.name}: the HF round trip changed a weight")
    got = tokens(cfg, to_device(loaded, "cuda"))
    check(torch.equal(torch.as_tensor(got), torch.as_tensor(ref)), f"{cfg.name}: loaded checkpoint's tokens differ")
    emit({"phase": "checkpoint", "case": case, "gb": gb, "shards": len(shards), "save_s": t_save, "load_s": t_load,
          "load_gb_per_s": gb / t_load, "tokens_equal": True})
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))


def checkpoint_phase() -> None:
    """Checkpoint I/O on the card's machine, with the port's own safetensors
    reader and writer (that machine has neither the safetensors package nor
    transformers): ChatGLM3-6B's tree at full width and 4 layers through
    save_params and load_params, the same leaves and the same tokens; then
    Falcon-7B, CodeGen-2B (its mp_num = 4 qkv_proj) and StarCoderBase-1B
    (GPTBigCode: multi-query c_attn, learned positions) at 2 layers written in
    the Hugging Face layout as two shards and read by load_hf_checkpoint
    (:func:`hf_round_trip`), equal to params_from_hf_state_dict on the same
    dict and giving the tokens of the tree it was written from. Seconds and
    GB/s of each save and load (the files in a directory under the checkout's
    git-ignored tmp/, written and read warm in the page cache)."""
    import os
    import tempfile

    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.engine.engine import InferenceEngine
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, load_params, save_params, to_device

    gen = GenerationConfig(max_new_tokens=16)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tmp")
    os.makedirs(root, exist_ok=True)

    def tokens(cfg, tree, prompts):
        return InferenceEngine(cfg, tree).generate(prompts, gen, fused=True).sequences

    with tempfile.TemporaryDirectory(dir=root) as d:
        cfg = get_config("chatglm3-6b").replace(num_layers=4)
        tree = device_dummy_params(cfg, seed=1)
        prompts = np.random.default_rng(1).integers(2, cfg.vocab_size, (4, 128)).tolist()
        ref = tokens(cfg, tree, prompts)
        path = os.path.join(d, "chatglm3.safetensors")
        t0 = time.perf_counter()
        save_params(tree, path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = to_device(load_params(path), "cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        gb = os.path.getsize(path) / 1e9
        check(_trees_equal(back, tree), "chatglm3-6b: load_params differs from the saved tree")
        got = tokens(cfg, back, prompts)
        check(torch.equal(torch.as_tensor(got), torch.as_tensor(ref)), "chatglm3-6b: loaded tree's tokens differ")
        emit({"phase": "checkpoint", "case": "chatglm3-6b 4 layers save_params / load_params", "gb": gb,
              "save_s": t_save, "load_s": t_load, "load_gb_per_s": gb / t_load, "tokens_equal": True})
        del tree, back
        os.remove(path)
        torch.cuda.empty_cache()

        for name, to_hf, seed in (("falcon-7b", falcon_hf_state_dict, 2), ("codegen-2b", codegen_hf_state_dict, 3),
                                  ("starcoderbase-1b", gptbigcode_hf_state_dict, 4)):
            cfg = get_config(name).replace(num_layers=2)
            tree = device_dummy_params(cfg, seed=seed)
            prompts = np.random.default_rng(seed).integers(2, cfg.vocab_size, (4, 128)).tolist()
            hf_round_trip(d, f"{name} 2 layers HF shards / load_hf_checkpoint", cfg, tree, to_hf(cfg, tree),
                          lambda c, p, prompts=prompts: tokens(c, p, prompts))
            del tree
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# automatic placement: calibration, the cost model against the measured
# cells, hypertune beside the cost model's pick, and the run CLI
# ---------------------------------------------------------------------------

ANCHOR_CTX = PROMPT + NEW_TOKENS // 2  # the cost model's decode context: 256 + 16
# hypertune (the reference's probe: b4, 64 tokens in, 8 new) over OPT-6.7B's
# width at 4 layers, half resident
AUTO_MODEL, AUTO_LAYERS, AUTO_HBM = "opt-6.7b", 4, 50
AUTO_PREFILL, AUTO_DECODE = (0, 3), (0, 1, 2, 3)
AUTO_BATCH, AUTO_IN, AUTO_NEW = 4, 64, 8
CLI_MODEL = "llama-2-7b"  # F 11008: the fused-MLP route's F % 512 fails, the unfused route at full depth
CALIBRATED = ("h2d_bw", "h2d_latency_s", "host_flops", "tpu_flops")


def host_info() -> None:
    """The machine's host: MemTotal, CPU count, torch's thread count (the host
    tier's), and the card's memory free to this fresh process."""
    import os

    with open("/proc/meminfo") as f:
        mem_kb = next(int(line.split()[1]) for line in f if line.startswith("MemTotal:"))
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "host", "mem_total_gb": mem_kb * 1024 / 1e9, "cpu_count": os.cpu_count(),
          "torch_threads": torch.get_num_threads(), "card_free_gb": free / 1e9, "card_total_gb": total / 1e9,
          "card_free_fraction": free / total})


def host_copy_gb_s(nbytes: int = 1 << 30, reps: int = 3) -> float:
    """Host DRAM bytes moved a second (read and write) by a copy of ``nbytes``."""
    src = torch.ones(nbytes // 4, dtype=torch.float32)
    dst = torch.empty_like(src)
    dst.copy_(src)
    t0 = time.perf_counter()
    for _ in range(reps):
        dst.copy_(src)
    return 2 * nbytes * reps / (time.perf_counter() - t0) / 1e9


def calibrate_phase():
    """Microbench.calibrate() on the card from the detected card's profile: the
    pinned copy's α and β with a matmul in flight, the host's fp32 and the
    card's bf16 matmul rates; β beside the h2d phase's pinned rate of the same
    run; every calibrated field must move off its default. Returns the
    calibrated profile."""
    import dataclasses

    from lia_tpu_torch.runtime.cost_model import Microbench
    from lia_tpu_torch.utils import device_caps

    caps = device_caps.detect()
    check(caps is not None, f"calibrate: {torch.cuda.get_device_name(0)} is not in the capability registry")
    base = device_caps.system_profile_defaults()
    t0 = time.perf_counter()
    prof = Microbench.calibrate(base)
    seconds = time.perf_counter() - t0
    emit({"phase": "calibrate", "seconds": seconds, "caps": dataclasses.asdict(caps),
          "alpha_s": prof.h2d_latency_s, "beta_gb_s": prof.h2d_bw / 1e9,
          "h2d_pinned_gb_s": H2D.get("h2d_pinned_gb_s"), "host_flops": prof.host_flops, "card_flops": prof.tpu_flops,
          "card_flops_fraction_of_spec": prof.tpu_flops / caps.bf16_flops, "host_threads": torch.get_num_threads(),
          "host_copy_gb_s": host_copy_gb_s(), "defaults": {f: getattr(base, f) for f in CALIBRATED}})
    moved = [f for f in CALIBRATED if getattr(prof, f) != getattr(base, f)]
    check(moved == list(CALIBRATED), f"calibrate: only {moved} moved off their defaults")
    return prof


def cell_quant(label: str, kv: str):
    """The QuantConfig of a main-path cell, from its label."""
    from lia_tpu_torch.config import QuantConfig

    if label in CANDIDATES:
        return QuantConfig(**CANDIDATES[label][0])
    return QuantConfig(**WEIGHT_ONLY.get(label, {}), kv_cache_dtype=kv)


def tiered_prediction(cm, n_res: int, policy: int, B: int, ctx: int) -> float:
    """A tiered decode step composed from the cost model's terms: resident
    layers x tpu_layer_time, streamed layers x the decode plan's layer time,
    plus the head and the step's own launches."""
    L = cm.cfg.num_layers
    streamed = {0: lambda: cm.policy0_decode_layer_time(B, ctx),
                1: lambda: cm.host_layer_time(B, 1, ctx),
                2: lambda: cm.hybrid_decode_layer_time(B, ctx, False),
                3: lambda: cm.tpu_layer_time(B, 1, ctx, False),
                4: lambda: cm.hybrid_decode_layer_time(B, ctx, False)}[policy]()
    head = cm.predict_decode_step(B, ctx) - L * cm.tpu_layer_time(B, 1, ctx, True)
    return n_res * cm.tpu_layer_time(B, 1, ctx, True) + (L - n_res) * streamed + head


def cost_model_phase(profile) -> None:
    """The calibrated cost model's decode step (and the H100 defaults') beside
    the measured one for every cell this run timed: the resident main-path
    cells (no gate on; predict_decode_step) and the tiered cells at their
    depth (tiered_prediction). No generate call."""
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.runtime.cost_model import CostModel, SystemProfile

    smi = nvidia_smi()
    rows = []
    for name, m in MEASURED.items():
        if m["gate"] or m["runtime"] or name.startswith("gptq"):
            continue
        qc = cell_quant(name, m["kv"])
        meas = m["batch"] / m["decode_tokens_per_s"]
        pred = CostModel(m["cfg"], profile, qc).predict_decode_step(m["batch"], ANCHOR_CTX)
        pred0 = CostModel(m["cfg"], SystemProfile(), qc).predict_decode_step(m["batch"], ANCHOR_CTX)
        rows.append({"cell": name, "layers": m["cfg"].num_layers, "measured_ms": meas * 1e3,
                     "predicted_ms": pred * 1e3, "ratio": meas / pred, "defaults_ms": pred0 * 1e3,
                     "defaults_ratio": meas / pred0})
    for name, m in TIERED_MEASURED.items():
        qc = QuantConfig(kv_cache_dtype=m["kv"]) if "int8dyn" not in name else cell_quant("int8dyn+int8kv", "int8")
        meas = m["batch"] / m["decode_tokens_per_s"]
        pred = tiered_prediction(CostModel(m["cfg"], profile, qc), m["n_res"], m["policies"][1], m["batch"],
                                 ANCHOR_CTX)
        rows.append({"cell": name, "layers": m["cfg"].num_layers, "resident": m["n_res"],
                     "decode_policy": m["policies"][1], "measured_ms": meas * 1e3, "predicted_ms": pred * 1e3,
                     "ratio": meas / pred})
    for r in rows:
        emit({"phase": "cost_model", **r, "card": smi})
    check(rows and all(np.isfinite(r["ratio"]) and r["ratio"] > 0 for r in rows), "cost_model: no finite ratio")


def auto_placement_phase(ca, cm, profile) -> dict:
    """Hypertune at OPT-6.7B's width, 4 layers (weights in pageable host
    memory), hbm 50, prefill (0, 3) x decode (0, 1, 2, 3), b4, 64 in, 8 new:
    every candidate must run, with no plain version on the card; beside it
    CostModel.choose on the same config with the calibrated profile's
    hbm_bytes set to hold two of the four layers (its pick's percentage must
    be 50), the measured ranking and how much the pick lost to the best."""
    import dataclasses

    from lia_tpu_torch.config import GenerationConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import cuda_mlp
    from lia_tpu_torch.runtime.cost_model import CostModel
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_host
    from lia_tpu_torch.utils.hypertune import Hypertune

    cfg = get_config(AUTO_MODEL).replace(num_layers=AUTO_LAYERS)
    tree = to_host(device_dummy_params(cfg, seed=0), "cuda")
    torch.cuda.empty_cache()
    ht = Hypertune(cfg, tree, gen=GenerationConfig(max_new_tokens=AUTO_NEW), batch=AUTO_BATCH,
                   input_tokens=AUTO_IN, prefill_policies=AUTO_PREFILL, decode_policies=AUTO_DECODE,
                   hbm_percentages=(AUTO_HBM,), num_minibatches=(1,))
    t0 = time.perf_counter()
    with plain_calls(ca, cm, cuda_mlp) as plain:
        results = ht.run(verbose=False)
    seconds = time.perf_counter() - t0
    check(not ht.failures, f"auto_placement: candidates failed: {ht.failures}")
    check(len(results) == len(AUTO_PREFILL) * len(AUTO_DECODE), f"auto_placement: {len(results)} results")
    check(not plain, f"auto_placement: plain versions ran on the card: {plain}")

    probe = CostModel(cfg, profile)
    max_len = AUTO_IN + AUTO_NEW
    embed = cfg.vocab_size * cfg.embed_dim * 2 * (1 if cfg.tie_embeddings else 2)
    slack = 2 * AUTO_BATCH * max_len * cfg.hidden_size * 2
    per_layer = probe.weight_bytes_per_layer() + probe.kv_bytes_per_layer(AUTO_BATCH, max_len)
    model = CostModel(cfg, dataclasses.replace(profile, hbm_bytes=embed + slack + 2.5 * per_layer))
    pick = model.choose(AUTO_BATCH, AUTO_IN, AUTO_NEW)
    check(pick[2] == AUTO_HBM, f"auto_placement: the cost model's pick {pick} is not at hbm {AUTO_HBM}")
    ranking = [{"prefill_policy": r.runtime.prefill_policy, "decode_policy": r.runtime.decode_policy,
                "tokens_per_s": r.tokens_per_s, "total_s": r.total_s} for r in results]
    got = [r for r in results if (r.runtime.prefill_policy, r.runtime.decode_policy) == pick[:2]]
    check(len(got) == 1, f"auto_placement: the pick {pick} is not among the candidates")
    rank = results.index(got[0])
    emit({"phase": "auto_placement", "model": cfg.name, "layers": cfg.num_layers, "hbm_percentage": AUTO_HBM,
          "batch": AUTO_BATCH, "input_tokens": AUTO_IN, "new_tokens": AUTO_NEW, "seconds": seconds,
          "ranking": ranking, "pick": pick, "pick_rank": rank, "best": ranking[0],
          "best_over_pick": results[0].tokens_per_s / got[0].tokens_per_s,
          "model_report": model.report(AUTO_BATCH, AUTO_IN, AUTO_NEW), "card": nvidia_smi()})
    del tree
    return {"pick": pick, "rank": rank}


def cli_call(ca, cm, label: str, argv, expected: dict) -> dict:
    """``lia_tpu_torch.run.main(argv)`` in this process, its standard output
    captured: the counters zeroed just before and read just after must equal
    ``expected``, no plain version may run on the card, and the last line must
    be the JSON summary with the reference's keys. Returns the parsed line and
    the auto placement line."""
    import io

    from lia_tpu_torch import run
    from lia_tpu_torch.ops import cuda_mlp

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ca, cm)
    t0 = time.perf_counter()
    with plain_calls(ca, cm, cuda_mlp) as plain, contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    seconds = time.perf_counter() - t0
    launches = launch_counts(ca, cm)
    lines = buf.getvalue().splitlines()
    check(rc == 0, f"cli {label}: exit code {rc}")
    check(launches == expected, f"cli {label}: launches {launches} != expected {expected}")
    check(not plain, f"cli {label}: plain versions ran on the card: {plain}")
    summary = json.loads(lines[-1])
    keys = {"model", "total_latency_s", "first_token_latency_s", "avg_2nd_token_latency_s", "p50_2nd_token_latency_s",
            "p90_2nd_token_latency_s", "p99_2nd_token_latency_s", "decode_tokens_per_s", "total_tokens_per_s"}
    check(set(summary) == keys, f"cli {label}: JSON keys {sorted(summary)}")
    auto = [line for line in lines if "auto placement:" in line]
    emit({"phase": "cli", "config": label, "argv": argv, "seconds": seconds, "launches": launches,
          "plain_calls_on_card": 0, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "auto_placement": auto[0] if auto else None, "timing_lines": [ln for ln in lines if ln.startswith("[")],
          "summary": summary})
    torch.cuda.empty_cache()
    return {"summary": summary, "auto": auto}


def cli_phase(ca, cm) -> dict:
    """The run CLI in process at Llama-2-7B full width and depth, dummy
    weights drawn on the card, b16, 256 + 32: auto on all three knobs with
    --calibrate (the pick must be (3, 3, 100); 32 flash prefills and 992
    decode-attention launches a generate, warm-up and timed), then with int8
    KV (B3), one generate."""
    from lia_tpu_torch.models.registry import get_config

    cfg = get_config(CLI_MODEL)
    L, steps = cfg.num_layers, NEW_TOKENS - 1
    base = ["--benchmark", "-m", CLI_MODEL, "--dummy-weights", "--batch-size", "16", "--input-tokens", str(PROMPT),
            "--max-new-tokens", str(NEW_TOKENS), "--prefill-policy", "auto", "--decoding-policy", "auto",
            "--hbm-percentage", "auto"]
    zero = {name: 0 for name in launch_counts(ca, cm)}
    out = {}
    for label, extra, kernel, runs in ((f"{CLI_MODEL} auto --calibrate", ["--calibrate", "--num-warmup", "1",
                                                                           "--num-iter", "1"],
                                        "decode_attention_fresh", 2),
                                       (f"{CLI_MODEL} auto int8 KV", ["--kv-cache-dtype", "int8", "--num-warmup", "0",
                                                                      "--num-iter", "1"],
                                        "decode_attention_fresh_int8", 1)):
        want = {**zero, "flash_attention_prefill": L * runs, kernel: L * steps * runs}
        auto = cli_call(ca, cm, label, base + extra, want)["auto"]
        check(auto and auto[0].endswith("prefill=3 decode=3 hbm%=100"), f"cli {label}: auto placement {auto}, "
                                                                         "not (3, 3, 100)")
        out[label] = want
    return out


# ---------------------------------------------------------------------------
# the quantization algorithms (SmoothQuant, static INT8, GPTQ), the accuracy
# runner and the public fused-op API
# ---------------------------------------------------------------------------

QUANT_ALPHA = 0.5  # the static-INT8 flow's SmoothQuant alpha (the reference's default)
GPTQ_LAYERS = 4  # GPTQ at OPT-6.7B's width over the tree's first layers
GPTQ_ACTORDER_LAYERS = 1
ACT_PARITY_TOL = 5e-2  # activation maxima, card (bf16 forward) against CPU (fp32): of the tap's largest
ARITH_TOL = 1e-5  # the flows' own arithmetic on equal inputs, card against CPU (fp32): of the largest
GPTQ_CODE_AGREEMENT = 0.999  # codes equal on equal inputs, card against CPU (0.99995-0.99996 read on the H100)


@contextlib.contextmanager
def timed_solves(record: list):
    """Every GPTQ solve (``gptq_quantize_matrix``) timed on the card's clock
    for the duration, its seconds appended to ``record``: the rest of a
    layer's time is its Hessians and propagation."""
    from lia_tpu_torch.ops import gptq

    solve = gptq.gptq_quantize_matrix

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(*a, **kw)
        torch.cuda.synchronize()
        record.append(time.perf_counter() - t0)
        return out

    gptq.gptq_quantize_matrix = timed
    try:
        yield record
    finally:
        gptq.gptq_quantize_matrix = solve


def quantize_timed(ca, cm, label: str, fn):
    """Run one quantization flow on the card: its seconds (synchronised),
    peak device memory over it, and no plain version on the card."""
    from lia_tpu_torch.ops import cuda_mlp

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with plain_calls(ca, cm, cuda_mlp) as plain:
        out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(not plain, f"{label}: plain versions ran on the card while quantizing: {plain}")
    return out, dict(quantize_s=secs, quantize_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     quantize_extra_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)


def on_card(tree) -> bool:
    from lia_tpu_torch.runtime.weight_manager import tree_tensors

    return all(t.is_cuda for t in tree_tensors(tree))


def quant_algos_phase(ca, cm, cfg, prompts) -> dict:
    """The quantization algorithms at OPT-6.7B's full width, from one bf16
    tree drawn on the card (seed 0), over the default calibration prompts
    (4 x 64 tokens), each flow quantizing on the card (no tensor of the tree
    leaves it) and then generating b16, 256 + 32 greedy tokens through
    main_path (exact launches, no plain version; prefill ms and decode
    tokens/s, median of 3):

    - w8a8-static+int8kv: static_int8_quantize at alpha 0.5 over all 32
      layers (int8 x int8 torch._int_mm with static activation scales), int8
      KV (B1, B3);
    - smoothquant-auto-int8: autotune_alpha over the default alphas (each
      alpha's KL printed), then the fold at the chosen alpha and int8
      per-channel weight-only records, bf16 KV (B1, B2, B14 for the four
      linears and the head);
    - gptq-int4-g128: gptq_quantize_params at 4 bits, g 128 over the first 4
      layers, seconds a layer for the Hessians and the solves (B13), the same
      tree retagged onto W4A8 (B11), act-order over one layer (B13).

    Then ``accuracy`` (lia_tpu_torch.run_accuracy.main, --self-test, 32
    records at b16, OPT-6.7B static-int8 at full depth on the card: n and a
    finite ppl; accuracy is printed, not gated: bf16 greedy flips on
    flat-margin random weights) and the ``modules`` checks; returns the
    launches of each generating line."""
    from lia_tpu_torch.api import _default_calib
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.ops import smoothquant as sq
    from lia_tpu_torch.ops.gptq import gptq_quantize_params
    from lia_tpu_torch.ops.quant import retag_dynamic_act
    from lia_tpu_torch.utils.checkpoint import device_dummy_params

    calib = _default_calib(cfg)
    L = cfg.num_layers
    tree = device_dummy_params(cfg, seed=0)
    launches = {}

    def cell(label, qcfg, qtree, kv, per_forward, info):
        check(on_card(qtree), f"{label}: the quantized tree left the card")
        out = main_path(ca, cm, label, qcfg, lambda: qtree, prompts, kv, per_forward, timed=True)
        launches.update({name: counts for name, (counts, _) in out.items()})
        emit({"phase": "quant_algos", "config": label, "model": cfg.name, "layers": qcfg.num_layers,
              "calibration": [len(calib), len(calib[0])], **info})

    # every flow quantizes from the bf16 tree first; the tree is freed before
    # the cells generate, so their engines run beside no more than their own trees
    cells = []
    q, info = quantize_timed(ca, cm, "w8a8-static+int8kv",
                             lambda: sq.static_int8_quantize(cfg, tree, calib, alpha=QUANT_ALPHA)[0])
    fmts = {rec.fmt for grp in q["layers"].values() for rec in grp.values() if hasattr(rec, "fmt")}
    check(fmts == {"static_int8"}, f"w8a8-static: formats {fmts}")
    cells.append(("w8a8-static+int8kv", cfg, q, "int8", {}, {**info, "alpha": QUANT_ALPHA}))

    qc = QuantConfig(weight_dtype="int8", group_size=-1)

    def smooth():
        best, report = sq.autotune_alpha(cfg, tree, calib, qc)
        qtree, _ = sq.smoothquant_quantize(cfg, tree, calib, qc, alpha=best)
        return qtree, best, report

    (q, best, report), info = quantize_timed(ca, cm, "smoothquant-auto-int8", smooth)
    check(best in sq.DEFAULT_ALPHAS and all(np.isfinite(v) for v in report.values()),
          f"smoothquant autotune: {best} {report}")
    cells.append(("smoothquant-auto-int8", cfg, q, "none", {"woq_matmul": 4 * L + 1},
                  {**info, "alpha": best, "kl_by_alpha": report}))

    cfg4 = cfg.replace(num_layers=GPTQ_LAYERS)
    with timed_solves([]) as solves:
        g4, info = quantize_timed(ca, cm, "gptq-int4-g128", lambda: gptq_quantize_params(
            cfg4, first_layers(tree, GPTQ_LAYERS), calib, bits=4, group_size=128))
    check(len(solves) == 4 * GPTQ_LAYERS, f"gptq: {len(solves)} solves for {GPTQ_LAYERS} layers")
    solve_s = sum(solves)
    info.update(solve_s_per_layer=solve_s / GPTQ_LAYERS,
                hessian_and_propagation_s_per_layer=(info["quantize_s"] - solve_s) / GPTQ_LAYERS,
                solve_s_by_hessian=solves[:4], rows_per_layer=3 * cfg.hidden_size + cfg.ffn_size,
                full_depth_estimate_s=info["quantize_s"] / GPTQ_LAYERS * L)
    check(g4["layers"]["attn"]["wq"].fmt == "woq_int4z" and g4["layers"]["attn"]["wq"].z is not None,
          "gptq: not woq_int4z")
    cells.append(("gptq-int4-g128", cfg4, g4, "none", {"woq4z_matmul": 4 * GPTQ_LAYERS}, info))
    cells.append(("gptq-int4-g128 retagged w4a8", cfg4, retag_dynamic_act(g4), "none",
                  {"w4a8_matmul": 4 * GPTQ_LAYERS}, {"retagged": "woq_int4z_dyn"}))
    cfg1 = cfg.replace(num_layers=GPTQ_ACTORDER_LAYERS)
    g1, info = quantize_timed(ca, cm, "gptq-int4-g128-actorder", lambda: gptq_quantize_params(
        cfg1, first_layers(tree, GPTQ_ACTORDER_LAYERS), calib, bits=4, group_size=128, actorder=True))
    cells.append(("gptq-int4-g128-actorder", cfg1, g1, "none", {"woq4z_matmul": 4 * GPTQ_ACTORDER_LAYERS},
                  {**info, "actorder": True}))
    del tree, q, g4, g1
    torch.cuda.empty_cache()
    while cells:
        cell(*cells.pop(0))
        torch.cuda.empty_cache()
    phase_time("quantization flows")

    accuracy_line(ca, cm, cfg)
    modules_checks(ca)
    return launches


ACCURACY_ARGS = ["-m", "opt-6.7b", "--dummy-weights", "--self-test", "--limit", "32", "--batch-size", "16",
                 "--weight-dtype", "static-int8"]


def accuracy_line(ca, cm, cfg) -> None:
    """run_accuracy.main in process on the card: the static-INT8 flow at full
    depth, 32 self-test records at b16. Exact B1 launches: the flow's two
    calibration passes (fold, then the static scales) and, for each of the
    two batches, the self-test's prefill, the scoring pass and the greedy
    check's prefill, each at every layer; no decode step (one new token)."""
    import io

    from lia_tpu_torch import run_accuracy
    from lia_tpu_torch.ops import cuda_mlp

    reset_counts(ca, cm)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with plain_calls(ca, cm, cuda_mlp) as plain, contextlib.redirect_stdout(buf):
        rc = run_accuracy.main(ACCURACY_ARGS)
    secs = time.perf_counter() - t0
    counts = launch_counts(ca, cm)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    L, batches = cfg.num_layers, 32 // 16
    want = {name: 0 for name in counts}
    want["flash_attention_prefill"] = 2 * L + 3 * batches * L
    emit({"phase": "accuracy", "argv": ACCURACY_ARGS, "seconds": secs, "launches": counts,
          "plain_calls_on_card": len(plain), **report})
    check(rc == 0 and report["n"] == 32 and np.isfinite(report["ppl"]), f"accuracy: {report}")
    check(not plain, f"accuracy: plain versions ran on the card: {plain}")
    check(counts == want, f"accuracy: launches {counts} != expected {want}")
    torch.cuda.empty_cache()


def modules_checks(ca) -> None:
    """The public fused-op API at OPT-6.7B's heads (B 16, N 32, D 128):
    indirect_access_kv_cache_attention over a bf16 cache (B2) and an int8
    cache (B3), each against its kernel's plain version on the same inputs
    and writing the fresh token into its slot; paged_attention (B5) over a
    shuffled pool; varlen_attention (plain code, as in the reference) against
    attention run one sequence at a time. One launch of each kernel a call."""
    import torch.nn.functional as F

    from lia_tpu_torch import modules as M
    from lia_tpu_torch.ops.quant import quantize_kv

    randn = check_randn("modules_checks")
    pads = [0, 3, 7, 15] * 4
    mask = torch.zeros(B, 320, dtype=torch.bool, device="cuda")
    for b, p in enumerate(pads):
        mask[b, p:PAST] = True
    length = torch.tensor(PAST, dtype=torch.int32, device="cuda")
    q, kn, vn = randn(B, 1, N, D), randn(B, 1, N, D), randn(B, 1, N, D)
    kf, vf = kn.transpose(1, 2).contiguous(), vn.transpose(1, 2).contiguous()
    for kind, kernel in (("bf16", "decode_attention_fresh"), ("int8", "decode_attention_fresh_int8")):
        k, v = randn(2, B, N, 320, D), randn(2, B, N, 320, D)
        if kind == "int8":
            kq, vq = quantize_kv(k.float()), quantize_kv(v.float())
            cache = M.KVCache(kq, vq, length, mask)
            ref = ca.decode_attention_fresh_int8_plain(q, kf, vf, kq.q.clone(), kq.s.clone(), vq.q.clone(),
                                                       vq.s.clone(), 1, mask, length)
        else:
            cache = M.KVCache(k, v, length, mask)
            ref = ca.decode_attention_fresh_plain(q, kf, vf, k.clone(), v.clone(), 1, mask, length)
        before = ca.launch_counts()[kernel]
        out, cache = M.indirect_access_kv_cache_attention(q, kn, vn, cache, layer_idx=1)
        torch.cuda.synchronize()
        n = ca.launch_counts()[kernel] - before
        err = (out.float() - ref.float()).abs().max().item()
        written = cache.k.q[1, :, :, PAST] if kind == "int8" else cache.k[1, :, :, PAST]
        want = quantize_kv(kf[:, :, 0].float()).q if kind == "int8" else kf[:, :, 0]
        emit({"phase": "modules", "check": f"indirect_access_kv_cache_attention, {kind} cache", "kernel": kernel,
              "launches": n, "max_abs_err": err, "tol": KERNEL_TOL})
        check(n == 1 and err <= KERNEL_TOL and bool(torch.isfinite(out).all()),
              f"indirect_access_kv_cache_attention {kind}: {n} launches, err {err}")
        check(bool((written == want).all()), f"indirect_access_kv_cache_attention {kind}: fresh token not written")

    bs, P = 16, 24
    nb = B * P + 1
    pool = M.PagedKVCache(randn(nb, N, bs, D), randn(nb, N, bs, D))
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(0))[: B * P] + 1
    table = perm.reshape(B, P).to(torch.int32).cuda()
    lens = torch.tensor([1 + (37 * b) % (P * bs) for b in range(B)], dtype=torch.int32, device="cuda")
    before = ca.launch_counts()["paged_decode_attention"]
    out = M.paged_attention(q, pool, table, lens)
    torch.cuda.synchronize()
    n = ca.launch_counts()["paged_decode_attention"] - before
    ref = ca.paged_decode_attention_plain(q, pool.k[None], pool.v[None], 0, table, lens)
    err = (out.float() - ref.float()).abs().max().item()
    emit({"phase": "modules", "check": "paged_attention", "kernel": "paged_decode_attention", "launches": n,
          "max_abs_err": err, "tol": KERNEL_TOL})
    check(n >= 1 and err <= KERNEL_TOL and bool(torch.isfinite(out).all()), f"paged_attention: {n} launches, err {err}")

    lens = [256, 100, 37, 500]
    T = sum(lens) + 11  # padded
    qv, kv, vv = (randn(T, N, D, dtype=torch.float32) for _ in range(3))
    out = M.varlen_attention(qv, kv, vv, torch.tensor(lens, device="cuda"))
    err, off = 0.0, 0
    for n_ in lens:
        s = slice(off, off + n_)
        ref = F.scaled_dot_product_attention(qv[s].transpose(0, 1), kv[s].transpose(0, 1), vv[s].transpose(0, 1),
                                             is_causal=True).transpose(0, 1)
        err = max(err, (out[s] - ref).abs().max().item())
        off += n_
    emit({"phase": "modules", "check": "varlen_attention (fp32)", "max_abs_err": err, "tol": 1e-4,
          "padding_zero": bool((out[off:] == 0).all())})
    check(err <= 1e-4 and bool((out[off:] == 0).all()), f"varlen_attention: err {err}")


def quant_parity() -> None:
    """OPT-6.7B's width at 2 layers, one bf16 tree (seed 1, drawn on the
    card) and its fp32 copy on the CPU, the default calibration prompts:

    - the flows' arithmetic on equal inputs (the card's fp32 tree equal to
      the CPU's bit for bit), fp32 (fp64 for the solver) on the card against
      the CPU: the load-time quantizers (int8, int4 g 128, NF4 g 64, static)
      of layer 0-1's wq bit for bit, the SmoothQuant fold at alpha 0.5 and
      the static records from
      the CPU's activation maxima (folded weights and static scales within
      ARITH_TOL of their largest, codes agreeing on at least
      GPTQ_CODE_AGREEMENT), and the GPTQ solve (4 bits, g 128) of layer 0's
      q/k/v against the CPU's Hessian: codes agreeing on at least
      GPTQ_CODE_AGREEMENT, each column's first differing code one step
      apart, and the scales and zeros of every group up to that code's
      within ARITH_TOL and equal (a column's later groups start from
      weights that the differing code's error moved, so they may differ);
    - the calibration on the card (bf16 model; its forward passes run the
      flash prefill kernel, which takes bf16 only) against the CPU (fp32):
      the activation maxima within ACT_PARITY_TOL of each tap's largest (a
      whole GPTQ flow on the CPU at this width, with fc2's 16384-row solve,
      would take minutes, so its solver is held on layer 0's q/k/v above);
    - the card's three trees run prefill + 4 decode steps on the card (bf16)
      and, moved to the CPU, there (fp32): logits within PARITY_TOL
      (PARITY_TOL_INT8_ACT for W8A8's int8 activations), as parity()."""
    from lia_tpu_torch.api import _default_calib
    from lia_tpu_torch.config import QuantConfig
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops import smoothquant as sq
    from lia_tpu_torch.ops.gptq import _gram, gptq_quantize_matrix, gptq_quantize_params
    from lia_tpu_torch.ops.quant import quantize_params_static, quantize_weight, quantize_weight_static
    from lia_tpu_torch.runtime.weight_manager import tree_tensors
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, to_device

    cfg = get_config("opt-6.7b").replace(num_layers=2)
    cfg32 = cfg.replace(dtype="float32")
    calib = _default_calib(cfg)
    tree = device_dummy_params(cfg, seed=1)
    cpu = to_device(tree, "cpu", torch.float32)
    card32 = to_device(tree, "cuda", torch.float32)
    t0 = time.perf_counter()

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    # the flows' arithmetic on equal inputs
    leaves = zip(tree_tensors(card32), tree_tensors(cpu))
    check(all(torch.equal(a.cpu(), b) for a, b in leaves), "quant parity: the card's fp32 tree is not the CPU's")
    act_cpu = sq.collect_act_scales(cfg32, cpu, calib)
    fold_cpu = sq.apply_smoothquant(cfg32, cpu, act_cpu, alpha=QUANT_ALPHA)
    fold_card = sq.apply_smoothquant(cfg32, card32, {k: v.cuda() for k, v in act_cpu.items()}, alpha=QUANT_ALPHA)
    fold_errs = {f"{g}.{k}": rel(fold_card["layers"][g][k], fold_cpu["layers"][g][k])
                 for g, k in (("ln1", "scale"), ("ln2", "scale"), ("attn", "wq"), ("attn", "wv"), ("mlp", "w1"))}
    fold_err = max(fold_errs.values())
    st_cpu = quantize_params_static(cfg32, fold_cpu, act_cpu)
    st_card = quantize_params_static(cfg32, fold_card, {k: v.cuda() for k, v in act_cpu.items()})
    agree, z_err = [], 0.0
    for g, ws in st_cpu["layers"].items():
        for k, rec in ws.items():
            if hasattr(rec, "fmt"):
                agree.append((st_card["layers"][g][k].q.cpu() == rec.q).float().mean().item())
                z_err = max(z_err, rel(st_card["layers"][g][k].z, rec.z), rel(st_card["layers"][g][k].s, rec.s))
    # the load-time quantizers on the card against the CPU, bit for bit
    w_card, w_cpu = card32["layers"]["attn"]["wq"], cpu["layers"]["attn"]["wq"]
    quantizers_equal = {}
    for label, kw in (("int8", dict(weight_dtype="int8", group_size=-1)),
                      ("int4-g128", dict(weight_dtype="int4", group_size=128)),
                      ("nf4-g64", dict(weight_dtype="nf4", group_size=64))):
        a, b = quantize_weight(w_card, QuantConfig(**kw)), quantize_weight(w_cpu, QuantConfig(**kw))
        quantizers_equal[label] = torch.equal(a.q.cpu(), b.q) and torch.equal(a.s.cpu(), b.s)
    amax = act_cpu["qkv"].amax(dim=-1)
    a, b = quantize_weight_static(w_card, amax.cuda()), quantize_weight_static(w_cpu, amax)
    quantizers_equal["static"] = all(torch.equal(x.cpu(), y) for x, y in zip((a.q, a.s, a.z), (b.q, b.s, b.z)))
    from lia_tpu_torch.ops.smoothquant import Calibration, tapped_layer
    from lia_tpu_torch.models import transformer as T

    cal = Calibration(cfg32, cpu, calib, cfg.pad_token_id)
    with torch.inference_mode():
        a1 = tapped_layer(cfg32, T.layer_params(cpu["layers"], 0), cal.embed(cfg32, cpu), cal)[1][0]
    H = _gram(a1, cal.valid.float()).double()
    lp0 = T.layer_params(cpu["layers"], 0)["attn"]
    w_qkv = torch.cat([lp0[n] for n in ("wq", "wk", "wv")], dim=1)
    sol_cpu = gptq_quantize_matrix(w_qkv, H, bits=4, group_size=128)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sol_card = gptq_quantize_matrix(w_qkv.cuda(), H.cuda(), bits=4, group_size=128)
    torch.cuda.synchronize()
    solve_card_s = time.perf_counter() - t1
    (c_card, s_card, z_card), (c_cpu, s_cpu, z_cpu) = [t.cpu() for t in sol_card], sol_cpu
    diff = c_card != c_cpu  # [K, N]
    gptq_agree = 1.0 - diff.double().mean().item()
    K, ng = diff.shape[0], s_cpu.shape[0]
    cols = diff.any(dim=0).nonzero().flatten()
    first = torch.full((diff.shape[1],), K)  # each column's first differing row (K: none)
    first[cols] = diff[:, cols].int().argmax(dim=0)
    steps = (c_card[first[cols], cols] - c_cpu[first[cols], cols]).abs()
    before = torch.arange(ng)[:, None] <= (first // (K // ng))[None, :]  # groups whose scale precedes it
    gptq_s_err = ((s_card - s_cpu).abs() / s_cpu.abs().max())[before].max().item()
    gptq_z_equal = bool((z_card == z_cpu)[before].all())
    emit({"phase": "quant_parity", "check": "arithmetic on equal inputs", "fold_max_rel_err": fold_err,
          "fold_rel_err_by_leaf": fold_errs, "quantizers_bit_equal": quantizers_equal,
          "static_codes_agreement_min": min(agree),
          "static_scales_max_rel_err": z_err, "gptq_qkv_rows": K, "gptq_qkv_cols": int(w_qkv.shape[1]),
          "gptq_codes_agreement": gptq_agree, "gptq_columns_differing": int(cols.numel()),
          "gptq_first_difference_steps": sorted(set(steps.tolist())),
          "gptq_scales_before_first_difference_max_rel_err": gptq_s_err,
          "gptq_scales_max_rel_err": rel(s_card, s_cpu), "gptq_zeros_before_first_difference_equal": gptq_z_equal,
          "gptq_qkv_solve_card_s": solve_card_s, "tol": ARITH_TOL, "min_agreement": GPTQ_CODE_AGREEMENT})
    check(fold_err <= ARITH_TOL and z_err <= ARITH_TOL and min(agree) >= GPTQ_CODE_AGREEMENT,
          f"quant parity: fold {fold_err}, static scales {z_err}, static codes {min(agree)}")
    check(all(quantizers_equal.values()), f"quant parity: quantizers card against CPU {quantizers_equal}")
    check(gptq_agree >= GPTQ_CODE_AGREEMENT and bool((steps == 1).all()) and gptq_s_err <= ARITH_TOL
          and gptq_z_equal, f"quant parity: gptq codes {gptq_agree}, first differences {steps.unique().tolist()}, "
          f"scales before them {gptq_s_err}, zeros before them equal {gptq_z_equal}")
    del fold_cpu, fold_card, st_cpu, st_card, card32, sol_card, sol_cpu

    # each flow whole: the card (bf16) against the CPU (fp32)
    act_card = sq.collect_act_scales(cfg, tree, calib)
    act_err = {k: (act_card[k].float().cpu() - act_cpu[k]).abs().max().item() / act_cpu[k].abs().max().item()
               for k in act_cpu}
    qc = QuantConfig(weight_dtype="int8", group_size=-1)
    trees = {"w8a8-static": (sq.static_int8_quantize(cfg, tree, calib, alpha=QUANT_ALPHA)[0], PARITY_TOL_INT8_ACT),
             "smoothquant-0.5-int8": (sq.smoothquant_quantize(cfg, tree, calib, qc, alpha=QUANT_ALPHA)[0],
                                      PARITY_TOL),
             "gptq-int4-g128": (gptq_quantize_params(cfg, tree, calib, bits=4, group_size=128), PARITY_TOL)}
    emit({"phase": "quant_parity", "check": "flows, card bf16 against CPU fp32", "act_max_rel_err": act_err,
          "act_tol": ACT_PARITY_TOL, "seconds": time.perf_counter() - t0})
    check(max(act_err.values()) <= ACT_PARITY_TOL, f"quant parity: activation maxima {act_err}")
    for label, (qtree, tol) in trees.items():
        parity(f"quant {label}", "none", tree=(qtree, to_device(qtree, "cpu", torch.float32)), tol=tol)
    del trees, tree, cpu
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
    host_info()

    t0 = time.perf_counter()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": sorted(paths)})
    flash_build_report(_build, paths)
    qmatmul_build_report(_build, paths)
    paged_mlp_build_report(_build, paths)
    int8_build_report(_build, paths)
    beam_build_report(_build, paths)
    decode_build_report(_build, paths)
    large = alibi_phase(ca, cm, ("mpt-30b",))  # before the kernel checks' inputs take the card's memory
    phase_time("mpt-30b")

    rows = kernel_checks(ca, quantize_kv)
    mm_rows = matmul_kernel_checks(cm, quantize_act)
    matmul_edge_checks(cm, quantize_act)
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
    # the llama layout's GPTQ tree at Llama-2-7B's width, 2 layers: q/k/v, o,
    # gate, up and down as woq_int4z, fused (wqkv, wo, wg1, w2) and unfused
    lcfg2 = get_config(CLI_MODEL).replace(num_layers=2)
    lgptq = gptq_llama_params(lcfg2, seed=0)
    lprompts = llama_prompts(lcfg2)
    for label, n, runtime in (("gptq llama woq_int4z", 4, None),
                              ("gptq llama woq_int4z, unfused", 7, {"fuse_projections": False})):
        runs.update(main_path(ca, cm, label, lcfg2, lambda: lgptq, lprompts, "none",
                              {"woq4z_matmul": n * lcfg2.num_layers}, timed=False, runtime=runtime))
    del lgptq
    launches = {name: counts for name, (counts, _) in runs.items()}
    walls = {name: wall for name, (_, wall) in runs.items()}
    launches.update(llama_phase(ca, cm))
    launches.update(families_phase(ca, cm))
    launches.update(alibi_phase(ca, cm))
    launches.update(large)
    checkpoint_phase()
    phase_time("families and checkpoints")

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
    for model, kv in FAMILY_PARITY:  # the large groups' kernels inside the model
        parity(f"{model}, {kv} KV", kv, model=model)
    phase_time("main path and parity")
    alibi_parity(ca, cm)  # every kernel with slopes inside the models, 4 layers
    phase_time("alibi parity")

    launches.update(quant_algos_phase(ca, cm, cfg, prompts))
    quant_parity()
    phase_time("quantization algorithms")

    tier_launches, tree = tiered_phase(ca, cm, cfg, prompts)
    launches.update(tier_launches)
    tiered_parity()
    for model in HEAD_DIM_PARITY:
        tiered_parity(model, TIER_PARITY_HEAD_DIMS)
    phase_time("tiered")

    launches.update(serving_phase(ca, cm, cfg.replace(num_layers=SERVING_LAYERS)))
    serving_parity()
    for model in HEAD_DIM_PARITY:
        serving_parity(model)
    phase_time("serving")

    beam_launches, beam_walls, beam_prompts = beam_phase(ca, cm, cfg, prompts, tree)
    launches.update(beam_launches)
    beam_parity()
    for model in HEAD_DIM_PARITY:
        beam_parity(model)
    phase_time("beam and score")

    launches.update(speculative_phase(ca, cm, cfg.replace(num_layers=SPEC_LAYERS), first_layers(tree, SPEC_LAYERS)))
    speculative_parity(ca, cm)
    phase_time("speculative")

    serve_tier_launches, serve_tier = serving_tier_phase(ca, cm, cfg, tree)
    launches.update(serve_tier_launches)
    serving_tier_parity()
    phase_time("serving over the scheduler")

    profile = calibrate_phase()
    cost_model_phase(profile)
    auto_placement_phase(ca, cm, profile)
    launches.update(cli_phase(ca, cm))
    phase_time("automatic placement and the CLI")

    # every profiler session comes after the timed runs
    serving_tier_breakdown(serve_tier, serving_workload(cfg.vocab_size)[0][:SERVE_MAX_BATCH])
    serve_tier.sched.wm.close()
    del serve_tier
    for label, make, kv, _ in timed:
        device_breakdown(label, cfg, make, prompts, kv, walls[label])
    llama = get_config("llama-3-8b")
    device_breakdown(LLAMA_CELL, llama, lambda: device_dummy_params(llama, seed=0), llama_prompts(llama), "none",
                     LLAMA_WALL[LLAMA_CELL])
    from lia_tpu_torch.engine.engine import InferenceEngine

    for name, kv, hbm, policies, nm, inflight, _ in TIERED:
        if name in ("tier-h50-p3", "tier-h50-p0-p2-mb4"):
            tcfg, ttree = tier_model(name, cfg, tree)
            engine = InferenceEngine(tcfg, ttree, tiered_runtime(kv, hbm, policies, nm, inflight))
            tiered_breakdown(name, engine, prompts)
            del engine
    del tree
    for name, kv in (("beam-nb4", "none"), ("beam-nb4-int8kv", "int8")):
        beam_breakdown(ca, cfg, beam_prompts, name, kv, beam_walls[name])
    phase_time("device breakdowns")
    kernel_times(ca, rows)
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
