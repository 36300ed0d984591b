"""Unified configuration for the PyTorch/CUDA port of LIA-TPU.

A copy of ``lia_tpu/config.py`` with the same fields and defaults, so that a
configuration converts one-to-one between the two packages (the port must not
import ``lia_tpu``: that pulls in jax). Fields the port does not act on yet
(tiering policies, meshes) are kept for parity; the engine raises when one is
set away from its default. As in the reference, the weight fields of
:class:`QuantConfig` are read where a tree is quantized or drawn
(``quantize_params``, ``init_dummy_params``); the engine runs whatever tree it
is given.

The reference (ece-fast-lab/ISCA-2025-LIA) spreads configuration over three tiers:
argparse CLI flags (examples/cpu/inference/python/llm/run.py:196-215), kwargs smuggled
through HF ``generate(**kwargs)`` (intel_extension_for_pytorch/transformers/generation/
greedy_search.py:130-137) and ``model.config`` attributes. Here everything collapses into
three explicit dataclasses:

- :class:`ModelConfig` — architecture description (OPT + Llama families).
- :class:`RuntimeConfig` — placement/streaming knobs (the LIA policy vector analog:
  ``prefill_policy``/``decoding_policy``/``gpu_percentage``/``num_minibatch``/
  ``pin_weight``/``enable_cxl`` from the reference CLI become ``prefill_policy``/
  ``decode_policy``/``hbm_percentage``/``num_minibatch``/``stream_weights``).
- :class:`GenerationConfig` — decode loop parameters.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _TORCH_DTYPES[name]


class Activation(str, enum.Enum):
    RELU = "relu"
    GELU = "gelu"  # exact (erf) — HF "gelu" (gpt-neox, falcon nn.GELU)
    GELU_NEW = "gelu_new"  # tanh approximation — HF "gelu_new" (gpt-j)
    SILU = "silu"  # used as SwiGLU gate in llama-style MLPs


class Norm(str, enum.Enum):
    LAYERNORM = "layernorm"
    RMSNORM = "rmsnorm"


class Placement(str, enum.Enum):
    """Where an operator group executes.

    TPU-native mapping of the reference's per-operator placement (GPU vs AMX-CPU,
    intel_extension_for_pytorch/transformers/models/reference/modules/decoder.py:172-335):
    - ``TPU``      — compute on the TPU chip, weights already in HBM (policy-3 analog).
    - ``TPU_STREAMED`` — compute on TPU with weights streamed host→HBM per layer
      (policy-0/2 streamed analog; lia/modeling_opt.py:270-318).
    - ``HOST``     — compute on the TPU-VM host via XLA:CPU (policy-1 AMX analog).
    """

    TPU = "tpu"
    TPU_STREAMED = "tpu_streamed"
    HOST = "host"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config covering the OPT and Llama families.

    OPT quirks mirrored from the reference's patched modeling
    (lia/modeling_opt.py:357-378): learned positional embeddings with an offset of 2,
    positions derived from the attention mask (left-padding aware); opt-350m's
    ``word_embed_proj_dim`` in/out projections; pre- vs post-layernorm placement.
    """

    name: str = "opt-125m"
    family: str = "opt"  # HF checkpoint layout family: opt | llama (also mistral/
    # qwen2) | gptj | gpt_neox | falcon — drives the state-dict mapping
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12  # < num_heads => GQA (llama-3)
    head_dim: int = 64
    max_position_embeddings: int = 2048
    activation: Activation = Activation.RELU
    norm: Norm = Norm.LAYERNORM
    pre_norm: bool = True  # OPT do_layer_norm_before / llama always True
    final_norm: bool = True
    rope: bool = False
    rope_theta: float = 10000.0
    learned_pos: bool = True
    pos_offset: int = 2  # OPT's offset-2 learned-position quirk
    tie_embeddings: bool = True
    word_embed_proj_dim: Optional[int] = None  # opt-350m: 512 != hidden 1024
    attn_bias: bool = True
    o_bias: Optional[bool] = None  # out-proj bias; None → follow attn_bias (qwen2: qkv
    # carry bias but o_proj does not)
    mlp_bias: bool = True
    lm_head_bias: bool = False  # gpt-j ships a bias on lm_head
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    pad_token_id: int = 1  # OPT's pad; Llama checkpoints ship 0/eos — set per model
    # --- family-widening knobs (gpt-j / gpt-neox / falcon / mistral / qwen2) ---
    parallel_residual: bool = False  # out = x + attn(ln(x)) + mlp(ln'(x)) — single
    # residual stream (HF GPTJBlock / GPTNeoXLayer use_parallel_residual / Falcon)
    parallel_shared_norm: bool = False  # gpt-j: MLP input reuses ln1's output;
    # False (neox/falcon new-arch=False): MLP input is ln2(x)
    rotary_dim: Optional[int] = None  # partial RoPE: rotate only the first
    # rotary_dim dims of each head (gpt-j 64/256·D, neox rotary_pct)
    rope_interleaved: bool = False  # gpt-j/neox "rotate_every_two" pairing
    # (even/odd lanes) instead of llama's half-split pairing
    sliding_window: Optional[int] = None  # mistral: attend only the last W positions
    alibi: bool = False  # bloom/mpt/baichuan-13b: additive key-positional attention
    # bias (slopes per head) instead of positional embeddings
    embed_layernorm: bool = False  # bloom: LayerNorm right after the token embed
    norm_head: bool = False  # baichuan2 NormHead: lm_head rows are L2-normalized.
    # Inference-only models can bake the normalization into the weights at load
    # time (checkpoint mapping), so this flag only drives the state-dict mapping.
    # --- mixture-of-experts (mixtral) ---
    num_experts: int = 0  # 0 = dense MLP; >0 = block-sparse MoE (Mixtral)
    num_experts_per_tok: int = 2  # top-k routing
    # --- encoder-decoder (t5 / flan-t5; reference optimize.py:310-326 patches
    # T5Attention/T5DenseActDense/T5DenseGatedActDense) ---
    encoder_decoder: bool = False  # T5: models/t5.py + engine/seq2seq.py
    rel_buckets: int = 32  # relative-position bias buckets (T5Attention)
    rel_max_distance: int = 128
    gated_mlp: bool = False  # flan-t5: h = act(wi_0 x) * (wi_1 x)
    attn_scale: Optional[float] = None  # None → 1/sqrt(head_dim); T5 uses 1.0
    # --- multimodal vision tower (git / llava; models/vision.py) ---
    vision_hidden: int = 0  # 0 = no vision tower
    vision_layers: int = 0
    vision_heads: int = 0
    vision_ffn: int = 0
    vision_patch: int = 16
    vision_image_size: int = 224
    vision_norm_eps: float = 1e-5
    image_token_id: int = 32000  # llava <image> placeholder token
    vision_feature_layer: int = -2  # llava: hidden_states index fed to the projector

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def num_params(self) -> int:
        """Approximate parameter count (for memory budgeting / rooflines)."""
        h, f, l, v = self.hidden_size, self.ffn_size, self.num_layers, self.vocab_size
        kvd = self.num_kv_heads * self.head_dim
        qd = self.num_heads * self.head_dim
        attn = h * qd + 2 * h * kvd + qd * h
        mlp = 2 * h * f if self.activation != Activation.SILU else 3 * h * f
        if self.num_experts:
            mlp = mlp * self.num_experts + h * self.num_experts  # experts + router
        embed = v * self.embed_dim + (
            0 if self.rope else (self.max_position_embeddings + self.pos_offset) * h
        )
        return l * (attn + mlp) + embed + (0 if self.tie_embeddings else v * self.embed_dim)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class QuantConfig:
    """Weight-only quantization config (reference: run.py:109-166 WOQ knobs)."""

    weight_dtype: str = "none"  # none | int8 | int4 | nf4 | static-int8 (W8A8)
    group_size: int = -1  # -1 = per-channel
    sym: bool = True
    kv_cache_dtype: str = "none"  # none | int8
    # "dynamic" (int8 only, per-channel scales): quantize activations per token
    # at matmul time and run int8×int8 MXU dots — the reference WOQ
    # ``lowp_mode=INT8`` analog (quantize-A path, WoqTppKrnl.cpp).
    act_quant: str = "none"  # none | dynamic
    # Quantize the (untied) lm_head with the same format — the vocab projection
    # is the largest single per-step HBM read after the decoder stack (Llama-3's
    # 128k vocab: 1.05 GB bf16). Reference WOQ converts lm_head like any Linear.
    quant_lm_head: bool = True

    @property
    def enabled(self) -> bool:
        return self.weight_dtype != "none"


@dataclass(frozen=True)
class RuntimeConfig:
    """Placement + streaming knobs — the LIA policy surface, TPU-native.

    Reference semantics (lia/modeling_opt.py:1167-1176, README.md:75-87):
    policy 0 = all ops on accelerator w/ streamed weights + host KV; 1 = all host;
    2 = linears on accelerator, attention on host; 3 = accelerator-resident;
    ``gpu_percentage`` = fraction of layers promoted to residency. Here:
    ``hbm_percentage`` layers are HBM-resident (policy-3 analog), the rest follow
    ``prefill_policy``/``decode_policy``.
    """

    prefill_policy: int = 3
    decode_policy: int = 3
    hbm_percentage: int = 100
    num_minibatch: int = 1
    stream_weights: bool = False  # force host-resident weights + per-layer streaming
    overlap: bool = True  # --no-overlap kill-switch analog (serialize transfers)
    # Max streamed layers whose dispatch may run ahead of execution. Each
    # enqueued layer pins its output buffers (q/k/v/attn_out at full batch)
    # from dispatch until execution, so an unthrottled loop over 30+ streamed
    # layers OOMs HBM whenever transfers are slower than dispatch. 2 ==
    # double-buffering: layer i executes while i+1's transfer streams.
    max_inflight_layers: int = 2
    fuse_projections: bool = True  # concat q/k/v + gate/up weights (ops/fuse.py)
    use_pallas: bool = True  # use Pallas kernels (False => pure-XLA fallback)
    tp_pallas: bool = True  # shard_map the Pallas kernels under a TP mesh
    # (False => jnp paths under TP, the pre-r5 conservative behavior)
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, model) mesh axes
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    quant: QuantConfig = QuantConfig()

    def replace(self, **kw) -> "RuntimeConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    num_beams: int = 1
    length_penalty: float = 0.0  # beam final selection: score / len**lp.
    # 0.0 (default) = raw cumulative scores; 1.0 = HF BeamSearchScorer's
    # default length normalization (matters only when EOS finishes beams at
    # different lengths).
    repetition_penalty: float = 1.0  # HF RepetitionPenaltyLogitsProcessor
    min_new_tokens: int = 0  # suppress EOS until this many tokens are out
    no_repeat_ngram_size: int = 0  # HF NoRepeatNGramLogitsProcessor (0 = off)
    eos_token_id: Optional[int] = None  # None => never stop early
    pad_token_id: int = 1  # OPT's pad token
    token_latency: bool = True  # per-token wall-clock list (greedy_search.py:424)

    def replace(self, **kw) -> "GenerationConfig":
        return dataclasses.replace(self, **kw)
