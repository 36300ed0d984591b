"""Model registry: named architecture configs across the reference's model families.

A copy of ``lia_tpu/models/registry.py`` (the table is data); the tests hold
every entry equal to the JAX package's.

Mirrors the reference's per-model load classes
(examples/cpu/inference/python/llm/utils/model_class/{opt,llama,gptj,gptneox,
falcon,mistral,qwen}.py) and its OPT size ladder (README.md:11-15: OPT 125M…175B).
Sizes follow the published HF configs; OPT-175B matches the FlexGen-style
dummy-weight generator (examples/cpu/inference/python/llm/utils/opt-weight-gen.py:8-40).

Family quirks are expressed as config knobs, not subclasses: parallel residual
(gpt-j/neox/falcon), shared vs separate MLP norm, partial/interleaved rotary,
sliding-window attention (mistral), per-projection bias layout (qwen2).
"""

from __future__ import annotations

from lia_tpu_torch.config import Activation, ModelConfig, Norm


def _opt(name, h, ffn, l, heads, vocab=50272, max_pos=2048, **kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="opt",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.RELU,
        norm=Norm.LAYERNORM,
        learned_pos=True,
        rope=False,
        tie_embeddings=True,
        **kw,
    )


def _llama(name, h, ffn, l, heads, kv_heads, vocab, max_pos=8192, theta=500000.0, **kw) -> ModelConfig:
    # kw may override the family defaults (qwen2: attn_bias=True, o_bias=False)
    kw.setdefault("attn_bias", False)
    kw.setdefault("mlp_bias", False)
    kw.setdefault("norm_eps", 1e-5)
    kw.setdefault("pad_token_id", 0)  # llama tokenizers have no pad; 0 (<unk>) is convention
    return ModelConfig(
        name=name,
        family="llama",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.SILU,
        learned_pos=False,
        rope=True,
        rope_theta=theta,
        tie_embeddings=False,
        **{"norm": Norm.RMSNORM, **kw},  # stablelm overrides with LAYERNORM
    )


def _codegen(name, h, ffn, l, heads, vocab, rotary_dim, max_pos=2048, **kw) -> ModelConfig:
    """CodeGen (HF modeling_codegen): GPT-J architecture (parallel residual,
    shared ln_1, interleaved partial rotary) with the mp_num=4 fused qkv_proj
    checkpoint layout and biased MLP/lm_head."""
    return ModelConfig(
        name=name,
        family="codegen",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.GELU_NEW,
        norm=Norm.LAYERNORM,
        learned_pos=False,
        rope=True,
        rope_theta=10000.0,
        rotary_dim=rotary_dim,
        rope_interleaved=True,
        parallel_residual=True,
        parallel_shared_norm=True,
        tie_embeddings=False,
        lm_head_bias=True,
        attn_bias=False,
        mlp_bias=True,
        pad_token_id=50256,
        **kw,
    )


def _stablelm(name, h, ffn, l, heads, kv_heads, vocab, max_pos=4096,
              theta=10000.0, rotary_pct=0.25, **kw) -> ModelConfig:
    """StableLM (HF modeling_stablelm): llama key layout with LayerNorm
    (weight+bias) instead of RMSNorm, partial rotary, SwiGLU, untied head."""
    return _llama(
        name, h, ffn, l, heads, kv_heads, vocab, max_pos=max_pos, theta=theta,
        norm=Norm.LAYERNORM, rotary_dim=int((h // heads) * rotary_pct), **kw,
    )


def _baichuan(name, h, ffn, l, heads, vocab, alibi=False, max_pos=4096, **kw) -> ModelConfig:
    """Baichuan(-2) (baichuan-inc remote-code modeling, reference model class:
    utils/model_class/baichuan.py): llama architecture with a packed ``W_pack``
    qkv projection. The 7B variants use RoPE; the 13B variants replace it with
    key-positional ALiBi (reference ``_gen_baichuan_alibi_mask``,
    intel_extension_for_pytorch/transformers/models/reference/modules/
    attentions.py:2743-2754 — slopes × key position, upper-tri causal mask).
    Baichuan2 additionally L2-normalizes lm_head rows (NormHead; baked into the
    weights at load time — config.norm_head)."""
    return _llama(
        name, h, ffn, l, heads, heads, vocab,
        max_pos=max_pos, theta=10000.0, **kw,
    ).replace(family="baichuan", rope=not alibi, alibi=alibi)


def _chatglm(name, h, ffn, l, heads, kv_groups, vocab, max_pos=32768,
             rope_ratio=1.0, **kw) -> ModelConfig:
    """ChatGLM2/3 (THUDM remote-code modeling_chatglm; reference patch points:
    optimize.py:520-538 ChatGLMModel/GLMTransformer/GLM2_get_masks +
    _GLM2Attention_forward, attentions.py:976-1080): packed ``query_key_value``
    projection split [q | k·groups | v·groups] with qkv bias only
    (add_qkv_bias), multi-query attention (``multi_query_group_num`` KV
    groups), rotary over the FIRST HALF of each head dim with interleaved
    (x[2i], x[2i+1]) pairing, RMSNorm, SwiGLU with a packed gate|up
    ``dense_h_to_4h``, untied ``output_layer`` head."""
    d = h // heads
    return _llama(
        name, h, ffn, l, heads, kv_groups, vocab,
        max_pos=max_pos, theta=10000.0 * rope_ratio,
        attn_bias=True, o_bias=False, **kw,
    ).replace(family="chatglm", rotary_dim=d // 2, rope_interleaved=True)


def _t5(name, h, ffn, l, heads, d_kv, vocab=32128, gated=False, tied=True, **kw) -> ModelConfig:
    """T5 / Flan-T5 (HF modeling_t5; reference patches T5Attention/
    T5DenseActDense/T5DenseGatedActDense — optimize.py:310-326): encoder-decoder
    with relative-position-bucket bias, UNSCALED attention (attn_scale=1.0),
    d_kv decoupled from hidden/heads, RMS-style T5LayerNorm. Original T5 ties
    the head (hidden scaled by d_model**-0.5 first); T5-1.1/Flan untie it and
    gate the MLP (gelu_new gate × up)."""
    return ModelConfig(
        name=name,
        family="t5",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=d_kv,
        max_position_embeddings=512,
        activation=Activation.GELU_NEW if gated else Activation.RELU,
        norm=Norm.RMSNORM,
        norm_eps=1e-6,
        learned_pos=False,
        rope=False,
        tie_embeddings=tied,
        attn_bias=False,
        mlp_bias=False,
        pad_token_id=0,
        encoder_decoder=True,
        gated_mlp=gated,
        attn_scale=1.0,
        **kw,
    )


def _git(name, h, ffn, l, heads, vh, vl, vheads, vffn, patch=16, img=224,
         vocab=30522, **kw) -> ModelConfig:
    """GIT (HF modeling_git; reference model class utils/model_class/git.py):
    CLIP-ViT image encoder + linear/LN projection + BERT-style post-norm text
    decoder over [image tokens | text] with a prefix-LM mask. BOS=101, EOS=102
    (BERT vocab)."""
    return ModelConfig(
        name=name,
        family="git",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=h // heads,
        max_position_embeddings=1024,
        activation=Activation.GELU,
        norm=Norm.LAYERNORM,
        norm_eps=1e-12,
        pre_norm=False,
        learned_pos=True,
        pos_offset=0,
        rope=False,
        tie_embeddings=False,
        attn_bias=True,
        mlp_bias=True,
        pad_token_id=0,
        vision_hidden=vh,
        vision_layers=vl,
        vision_heads=vheads,
        vision_ffn=vffn,
        vision_patch=patch,
        vision_image_size=img,
        **kw,
    )


def _llava(name, h, ffn, l, heads, kv_heads, vocab, vh, vl, vheads, vffn,
           patch=14, img=336, image_token=32000, **kw) -> ModelConfig:
    """LLaVA (HF modeling_llava; the reference's optional llava branch —
    optimize.py:188,673 prepare_inputs_labels_for_multimodal_llavallama +
    run_quantization.py:249-271): a CLIP-L vision tower whose layer-(-2) patch
    features (CLS dropped) pass through a 2-layer GELU projector and replace
    the ``<image>`` placeholder embeddings of a llama language model."""
    return _llama(
        name, h, ffn, l, heads, kv_heads, vocab, max_pos=4096, theta=10000.0, **kw
    ).replace(
        family="llava",
        vision_hidden=vh, vision_layers=vl, vision_heads=vheads, vision_ffn=vffn,
        vision_patch=patch, vision_image_size=img, image_token_id=image_token,
        vision_feature_layer=-2,
    )


def _gptj(name, h, ffn, l, heads, vocab, rotary_dim, max_pos=2048, **kw) -> ModelConfig:
    """GPT-J: parallel residual, single shared ln_1, interleaved partial rotary,
    no attention biases, biased MLP and lm_head (HF modeling_gptj)."""
    return ModelConfig(
        name=name,
        family="gptj",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.GELU_NEW,
        norm=Norm.LAYERNORM,
        learned_pos=False,
        rope=True,
        rope_theta=10000.0,
        rotary_dim=rotary_dim,
        rope_interleaved=True,
        parallel_residual=True,
        parallel_shared_norm=True,
        tie_embeddings=False,
        attn_bias=False,
        mlp_bias=True,
        lm_head_bias=True,
        pad_token_id=50256,  # eos; gpt-j has no pad token
        **kw,
    )


def _gpt_neox(name, h, ffn, l, heads, vocab, rotary_pct=0.25, max_pos=2048, **kw) -> ModelConfig:
    """GPT-NeoX / Pythia: parallel residual with separate post-attention LN,
    fused-QKV checkpoints (de-interleaved on load), partial non-interleaved
    rotary (rotary_pct), exact GELU (HF modeling_gpt_neox)."""
    d = h // heads
    return ModelConfig(
        name=name,
        family="gpt_neox",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=d,
        max_position_embeddings=max_pos,
        activation=Activation.GELU,
        norm=Norm.LAYERNORM,
        learned_pos=False,
        rope=True,
        rope_theta=10000.0,
        rotary_dim=int(d * rotary_pct),
        parallel_residual=True,
        parallel_shared_norm=False,
        tie_embeddings=False,
        attn_bias=True,
        mlp_bias=True,
        pad_token_id=0,
        **kw,
    )


def _falcon(name, h, ffn, l, heads, vocab, max_pos=2048, **kw) -> ModelConfig:
    """Falcon-7B-style: multi-query attention (1 KV head), parallel residual
    sharing input_layernorm, no biases, tied embeddings (HF modeling_falcon,
    new_decoder_architecture=False)."""
    return ModelConfig(
        name=name,
        family="falcon",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=1,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.GELU,
        norm=Norm.LAYERNORM,
        learned_pos=False,
        rope=True,
        rope_theta=10000.0,
        parallel_residual=True,
        parallel_shared_norm=True,
        tie_embeddings=True,
        attn_bias=False,
        mlp_bias=False,
        pad_token_id=11,  # falcon tokenizer convention
        **kw,
    )


def _bloom(name, h, ffn, l, heads, vocab=250880, max_pos=2048, **kw) -> ModelConfig:
    """Bloom (HF modeling_bloom): ALiBi attention bias instead of positional
    embeddings, LayerNorm after the token embed, gelu-tanh MLP, per-head fused
    QKV, tied embeddings (reference model class: utils/model_class/bloom.py)."""
    return ModelConfig(
        name=name,
        family="bloom",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.GELU_NEW,  # BloomGelu == tanh-approx gelu
        norm=Norm.LAYERNORM,
        learned_pos=False,
        rope=False,
        alibi=True,
        embed_layernorm=True,
        tie_embeddings=True,
        attn_bias=True,
        mlp_bias=True,
        pad_token_id=3,
        **kw,
    )


def _mpt(name, h, ffn, l, heads, vocab=50368, max_pos=2048, **kw) -> ModelConfig:
    """MPT (HF modeling_mpt, no_bias): ALiBi, fused Wqkv, exact-gelu MLP, tied
    embeddings. Registry entries use power-of-two head counts, where MPT's
    alibi-slope selection equals the standard form alibi_slopes implements
    (the two differ only in the odd-tail ordering for non-pow2 heads)."""
    return ModelConfig(
        name=name,
        family="mpt",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.GELU,
        norm=Norm.LAYERNORM,
        learned_pos=False,
        rope=False,
        alibi=True,
        tie_embeddings=True,
        attn_bias=False,
        mlp_bias=False,
        pad_token_id=0,
        **kw,
    )


def _gptbigcode(name, h, ffn, l, heads, vocab=49152, max_pos=8192, **kw) -> ModelConfig:
    """GPTBigCode / StarCoder (HF modeling_gpt_bigcode): multi-query attention,
    learned absolute positions without OPT's offset, gelu-tanh, tied embeds."""
    return ModelConfig(
        name=name,
        family="gptbigcode",
        vocab_size=vocab,
        hidden_size=h,
        ffn_size=ffn,
        num_layers=l,
        num_heads=heads,
        num_kv_heads=1,
        head_dim=h // heads,
        max_position_embeddings=max_pos,
        activation=Activation.GELU_NEW,
        norm=Norm.LAYERNORM,
        learned_pos=True,
        pos_offset=0,
        rope=False,
        tie_embeddings=True,
        attn_bias=True,
        mlp_bias=True,
        pad_token_id=0,
        **kw,
    )


REGISTRY = {
    # --- OPT family (facebook/opt-*) ---
    "opt-125m": _opt("opt-125m", 768, 3072, 12, 12),
    "opt-350m": _opt(
        "opt-350m", 1024, 4096, 24, 16, word_embed_proj_dim=512, pre_norm=False, final_norm=False
    ),
    "opt-1.3b": _opt("opt-1.3b", 2048, 8192, 24, 32),
    "opt-2.7b": _opt("opt-2.7b", 2560, 10240, 32, 32),
    "opt-6.7b": _opt("opt-6.7b", 4096, 16384, 32, 32),
    "opt-13b": _opt("opt-13b", 5120, 20480, 40, 40),
    "opt-30b": _opt("opt-30b", 7168, 28672, 48, 56),
    "opt-66b": _opt("opt-66b", 9216, 36864, 64, 72),
    "opt-175b": _opt("opt-175b", 12288, 49152, 96, 96),
    # --- Llama family ---
    "llama-2-7b": _llama("llama-2-7b", 4096, 11008, 32, 32, 32, 32000, max_pos=4096, theta=10000.0),
    "llama-2-13b": _llama("llama-2-13b", 5120, 13824, 40, 40, 40, 32000, max_pos=4096, theta=10000.0),
    "llama-3-8b": _llama("llama-3-8b", 4096, 14336, 32, 32, 8, 128256),
    "llama-3-70b": _llama("llama-3-70b", 8192, 28672, 80, 64, 8, 128256),
    # --- Mistral (llama layout + sliding-window attention) ---
    # mixtral: llama-layout attention + block-sparse MoE MLP (8 experts, top-2);
    # reference support: csrc/cpu/aten/MoE.cpp fused ops + optimize.py:572-574
    # + examples model_class/mixtral.py
    "mixtral-8x7b": _llama(
        "mixtral-8x7b", 4096, 14336, 32, 32, 8, 32000,
        max_pos=32768, theta=1e6, num_experts=8, num_experts_per_tok=2,
    ),
    "mistral-7b": _llama(
        "mistral-7b", 4096, 14336, 32, 32, 8, 32000,
        max_pos=32768, theta=10000.0, sliding_window=4096,
    ),
    # --- Qwen2 (llama layout; qkv biases but no o_proj bias) ---
    "qwen2-7b": _llama(
        "qwen2-7b", 3584, 18944, 28, 28, 4, 152064,
        max_pos=32768, theta=1000000.0, attn_bias=True, o_bias=False,
        norm_eps=1e-6, pad_token_id=151643,
    ),
    # --- GPT-J / GPT-NeoX / Falcon (parallel-residual families) ---
    "gpt-j-6b": _gptj("gpt-j-6b", 4096, 16384, 28, 16, 50400, rotary_dim=64),
    "gpt-neox-20b": _gpt_neox("gpt-neox-20b", 6144, 24576, 44, 64, 50432),
    "pythia-6.9b": _gpt_neox("pythia-6.9b", 4096, 16384, 32, 32, 50432),
    "falcon-7b": _falcon("falcon-7b", 4544, 18176, 32, 71, 65024),
    # --- Bloom (ALiBi family; reference model_class/bloom.py) ---
    "bloom-560m": _bloom("bloom-560m", 1024, 4096, 24, 16),
    "bloom-1b7": _bloom("bloom-1b7", 2048, 8192, 24, 16),
    "bloom-7b1": _bloom("bloom-7b1", 4096, 16384, 30, 32),
    # --- CodeGen (reference model_class/codegen.py) ---
    "codegen-2b": _codegen("codegen-2b", 2560, 10240, 32, 32, 51200, rotary_dim=64),
    "codegen-6b": _codegen("codegen-6b", 4096, 16384, 33, 16, 51200, rotary_dim=64),
    # --- StableLM (reference model_class/stablelm.py) ---
    "stablelm-2-1.6b": _stablelm(
        # stablelm-2 checkpoints ship use_qkv_bias=true (o_proj stays bias-free)
        "stablelm-2-1.6b", 2048, 5632, 24, 32, 32, 100352,
        attn_bias=True, o_bias=False,
    ),
    "stablelm-3b": _stablelm("stablelm-3b", 2560, 6912, 32, 32, 32, 50304),
    # --- Baichuan(-2) (reference model_class/baichuan.py) ---
    "baichuan-7b": _baichuan("baichuan-7b", 4096, 11008, 32, 32, 64000),
    "baichuan-13b": _baichuan("baichuan-13b", 5120, 13696, 40, 40, 64000, alibi=True),
    "baichuan2-7b": _baichuan("baichuan2-7b", 4096, 11008, 32, 32, 125696, norm_head=True),
    "baichuan2-13b": _baichuan(
        "baichuan2-13b", 5120, 13696, 40, 40, 125696, alibi=True, norm_head=True
    ),
    # --- ChatGLM2/3 (reference model_class/chatglm.py) ---
    "chatglm2-6b": _chatglm("chatglm2-6b", 4096, 13696, 28, 32, 2, 65024),
    "chatglm3-6b": _chatglm("chatglm3-6b", 4096, 13696, 28, 32, 2, 65024),
    # --- MPT (second ALiBi family; reference model_class/mpt.py) ---
    "mpt-7b": _mpt("mpt-7b", 4096, 16384, 32, 32),
    "mpt-30b": _mpt("mpt-30b", 7168, 28672, 48, 64, max_pos=8192),
    # --- GIT (reference model_class/git.py) ---
    "git-base": _git("git-base", 768, 3072, 6, 12, 768, 12, 12, 3072),
    "git-large": _git("git-large", 1024, 4096, 6, 16, 1024, 24, 16, 4096, patch=14),
    # --- LLaVA (reference model_class/llava.py, optional branch) ---
    "llava-1.5-7b": _llava("llava-1.5-7b", 4096, 11008, 32, 32, 32, 32064,
                           1024, 24, 16, 4096),
    # --- T5 / Flan-T5 (reference model_class/t5.py) ---
    "t5-base": _t5("t5-base", 768, 3072, 12, 12, 64),
    "t5-3b": _t5("t5-3b", 1024, 16384, 24, 32, 128),
    "flan-t5-xl": _t5("flan-t5-xl", 2048, 5120, 24, 32, 64, gated=True, tied=False),
    # --- GPTBigCode / StarCoder (reference model_class/gptbigcode.py) ---
    "starcoder-15b": _gptbigcode("starcoder-15b", 6144, 24576, 40, 48),
    "starcoderbase-1b": _gptbigcode("starcoderbase-1b", 2048, 8192, 24, 16),
    # --- tiny configs for tests (analog of tests/cpu/hf_configs/) ---
    "opt-tiny": _opt("opt-tiny", 64, 256, 2, 4, vocab=503, max_pos=128),
    "llama-tiny": _llama("llama-tiny", 64, 128, 2, 4, 2, 503, max_pos=128, theta=10000.0),
    "mistral-tiny": _llama(
        "mistral-tiny", 64, 128, 2, 4, 2, 503,
        max_pos=128, theta=10000.0, sliding_window=24,
    ),
    "qwen2-tiny": _llama(
        "qwen2-tiny", 64, 128, 2, 4, 2, 503,
        max_pos=128, theta=10000.0, attn_bias=True, o_bias=False,
    ),
    "mixtral-tiny": _llama(
        "mixtral-tiny", 64, 128, 2, 4, 2, 503,
        max_pos=128, theta=10000.0, num_experts=4, num_experts_per_tok=2,
    ),
    "gptj-tiny": _gptj("gptj-tiny", 64, 256, 2, 4, 503, rotary_dim=8, max_pos=128),
    "neox-tiny": _gpt_neox("neox-tiny", 64, 256, 2, 4, 503, rotary_pct=0.5, max_pos=128),
    "falcon-tiny": _falcon("falcon-tiny", 64, 256, 2, 4, 503, max_pos=128),
    "bloom-tiny": _bloom("bloom-tiny", 64, 256, 2, 4, vocab=503, max_pos=128),
    "mpt-tiny": _mpt("mpt-tiny", 64, 256, 2, 4, vocab=503, max_pos=128),
    "gptbigcode-tiny": _gptbigcode("gptbigcode-tiny", 64, 256, 2, 4, vocab=503, max_pos=128),
    "stablelm-tiny": _stablelm(
        "stablelm-tiny", 64, 128, 2, 4, 2, 503, max_pos=128, rotary_pct=0.5
    ),
    "codegen-tiny": _codegen("codegen-tiny", 64, 256, 2, 4, 503, rotary_dim=8, max_pos=128),
    "baichuan-tiny": _baichuan("baichuan-tiny", 64, 128, 2, 4, 503, max_pos=128),
    "chatglm-tiny": _chatglm("chatglm-tiny", 64, 128, 2, 4, 2, 503, max_pos=128),
    "t5-tiny": _t5("t5-tiny", 64, 128, 2, 4, 16, vocab=503),
    "git-tiny": _git("git-tiny", 64, 128, 2, 4, 32, 2, 2, 64, patch=8, img=16, vocab=503),
    "llava-tiny": _llava("llava-tiny", 64, 128, 2, 4, 2, 503, 32, 2, 2, 64,
                         patch=8, img=16, image_token=500),
    "flan-t5-tiny": _t5("flan-t5-tiny", 64, 128, 2, 4, 16, vocab=503, gated=True, tied=False),
    "baichuan2-tiny": _baichuan(
        "baichuan2-tiny", 64, 128, 2, 4, 503, alibi=True, max_pos=128, norm_head=True
    ),
}


def get_config(name: str) -> ModelConfig:
    key = name.lower()
    for org in ("facebook/", "meta-llama/", "eleutherai/", "tiiuae/", "mistralai/",
                "qwen/", "bigscience/", "baichuan-inc/", "thudm/", "google/"):
        key = key.replace(org, "")
    key = key.replace("_", "-")
    # common HF suffixes/aliases: mistral-7b-v0.1 → mistral-7b, qwen2-7b-instruct → qwen2-7b
    for suffix in ("-v0.1", "-v0.2", "-instruct", "-hf"):
        if key.endswith(suffix):
            key = key[: -len(suffix)]
    if key not in REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[key]
