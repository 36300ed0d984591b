"""Checkpoint I/O of the port (lia_tpu_torch.utils.safetensors and the file
functions of lia_tpu_torch.utils.checkpoint) against the ``safetensors``
package and the JAX package, on the CPU. Nothing is downloaded: Hugging Face
models are built in-process from config objects.

- the port's reader equals the package's in every dtype it takes, and the
  package reads the port's writer; ``__metadata__`` is skipped on read;
- a file written by lia_tpu's ``save_params`` loads in the port equal to
  ``params_from_jax``, and the port's file loads in lia_tpu, bit for bit, for
  a tree with a record of every ``QUANT_FORMATS`` entry, bf16 leaves and a
  ``QuantizedKV``;
- ``load_hf_checkpoint`` on OPT, llama and Falcon (multi-query, parallel
  attention) models saved in several shards equals lia_tpu's, fp32 and bf16,
  and raises on a directory without shards;
- the server's ``--checkpoint`` serves a saved model's tokens.
"""

import os

import pytest

pytest.importorskip("jax")
st_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp
import numpy as np
import torch

from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.ops import quant as jquant
from lia_tpu.utils import checkpoint as jckpt

from lia_tpu_torch.config import GenerationConfig
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.ops.quant import QUANT_FORMATS, QuantizedKV, QuantizedWeight
from lia_tpu_torch.utils import checkpoint as ckpt
from lia_tpu_torch.utils import safetensors as st

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.uint8, torch.int32, torch.int64, torch.bool]


def _tensor(dtype, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen).to(dtype)
    if dtype is torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000) + 1, shape, generator=gen, dtype=torch.int64
                         ).to(dtype)


def _tensors(dtype):
    """A matrix, a vector of odd length, a scalar and an empty tensor."""
    return {"m": _tensor(dtype, (5, 7), 1), "v": _tensor(dtype, (3,), 2), "s": _tensor(dtype, (), 3),
            "e": _tensor(dtype, (0, 4), 4)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_matches_safetensors_package(tmp_path, dtype):
    ts = _tensors(dtype)
    ts["other"] = torch.arange(3, dtype=torch.float32)  # a second dtype, laid out before or after
    path = str(tmp_path / "x.safetensors")
    st_torch.save_file(ts, path, metadata={"format": "pt"})
    ref, got = st_torch.load_file(path), st.load_file(path)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writer_read_by_safetensors_package(tmp_path, dtype):
    ts = _tensors(dtype)
    ts["t"] = _tensor(dtype, (6, 4), 5).t()  # not contiguous
    path = str(tmp_path / "x.safetensors")
    st.save_file(ts, path, metadata={"format": "pt"})
    ref = st_torch.load_file(path)
    for k, v in ts.items():
        assert ref[k].dtype == v.dtype and torch.equal(ref[k], v), k
    from safetensors import safe_open

    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_mapped_tensors_leave_the_file_alone(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st.save_file({"a": torch.ones(4)}, path)
    a = st.load_file(path)["a"]
    a.add_(1)  # copy-on-write: the file keeps its bytes
    assert torch.equal(st.load_file(path)["a"], torch.ones(4))


def _jax_tree(rng):
    """lia_tpu's kind of tree: fp32 and bf16 leaves, a record of every
    QUANT_FORMATS entry (codes, scales, zero-points or the static activation
    scale) and an int8 KV plane."""
    layers = {}
    for i, fmt in enumerate(QUANT_FORMATS):
        packed = "int4" in fmt or "nf4" in fmt
        q = (rng.integers(0, 256, (2, 8, 16)).astype(np.uint8) if packed
             else rng.integers(-128, 128, (2, 16, 16)).astype(np.int8))
        s = rng.standard_normal((2, 2, 16)).astype(np.float32)
        z = None
        if "int4z" in fmt:
            z = rng.integers(1, 16, (2, 2, 16)).astype(np.float32)
        elif fmt == "static_int8":
            z = np.abs(rng.standard_normal(2)).astype(np.float32)
        layers[f"w{i}"] = jquant.QuantizedWeight(q, s, fmt, z)
    return {
        "embed_tokens": jnp.asarray(rng.standard_normal((11, 16)), jnp.bfloat16),
        "final_norm": {"scale": rng.standard_normal(16).astype(np.float32)},
        "layers": {"mlp": layers, "ln1": {"scale": jnp.asarray(rng.standard_normal((2, 16)), jnp.bfloat16)}},
        "kv": jquant.QuantizedKV(rng.integers(-128, 128, (2, 3, 5, 16)).astype(np.int8),
                                 rng.standard_normal((2, 3, 5)).astype(np.float32)),
    }


def _to_port(tree):
    """params_from_jax, with the QuantizedKV record carried too."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, jquant.QuantizedKV):
        return QuantizedKV(ckpt.params_from_jax(tree.q), ckpt.params_from_jax(tree.s))
    return ckpt.params_from_jax(tree)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (QuantizedWeight, QuantizedKV)):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedWeight):
            assert a.fmt == b.fmt and (a.z is None) == (b.z is None), path
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                _assert_same(x, y, path)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def test_lia_tpu_file_loads_in_the_port(tmp_path):
    tree = _jax_tree(np.random.default_rng(0))
    path = str(tmp_path / "params.safetensors")
    jckpt.save_params(tree, path)
    _assert_same(ckpt.load_params(path), _to_port(tree))


def test_port_file_loads_in_lia_tpu(tmp_path):
    tree = _jax_tree(np.random.default_rng(1))
    path = str(tmp_path / "sub" / "params.safetensors")
    ckpt.save_params(_to_port(tree), path)
    back = jckpt.load_params(path)
    _assert_same(_to_port(back), _to_port(tree))
    assert back["embed_tokens"].dtype.name == "bfloat16"  # stored as BF16, not widened


def test_port_records_round_trip(tmp_path):
    """The port's own quantized trees, every format, through save and load."""
    tree = _to_port(_jax_tree(np.random.default_rng(2)))
    path = str(tmp_path / "p.safetensors")
    ckpt.save_params(tree, path)
    _assert_same(ckpt.load_params(path), tree)


def _hf_model(name):
    cfg = get_config(name).replace(dtype="float32")
    H, F, L, N = cfg.hidden_size, cfg.ffn_size, cfg.num_layers, cfg.num_heads
    if name == "opt-tiny":
        hf_cfg = transformers.OPTConfig(vocab_size=cfg.vocab_size, hidden_size=H, ffn_dim=F, num_hidden_layers=L,
                                        num_attention_heads=N, max_position_embeddings=cfg.max_position_embeddings,
                                        word_embed_proj_dim=H)
        cls = transformers.OPTForCausalLM
    elif name == "llama-tiny":
        hf_cfg = transformers.LlamaConfig(vocab_size=cfg.vocab_size, hidden_size=H, intermediate_size=F,
                                          num_hidden_layers=L, num_attention_heads=N,
                                          num_key_value_heads=cfg.num_kv_heads, tie_word_embeddings=False)
        cls = transformers.LlamaForCausalLM
    else:
        hf_cfg = transformers.FalconConfig(vocab_size=cfg.vocab_size, hidden_size=H, ffn_hidden_size=F,
                                           num_hidden_layers=L, num_attention_heads=N, multi_query=True,
                                           parallel_attn=True, new_decoder_architecture=False, bias=False,
                                           alibi=False, tie_word_embeddings=True)
        cls = transformers.FalconForCausalLM
    torch.manual_seed(0)
    hf = cls(hf_cfg).eval()
    with torch.no_grad():  # HF zeroes biases and unit-fills norms: seed them
        for n, p in hf.named_parameters():
            if n.endswith("bias") or "norm" in n:
                p.normal_(0.5, 0.1)
    return cfg, hf


@pytest.mark.parametrize("name", ["opt-tiny", "llama-tiny", "falcon-tiny"])
def test_load_hf_checkpoint_matches_lia_tpu(tmp_path, name):
    """A model saved by transformers in several shards loads equal to
    lia_tpu's load_hf_checkpoint, fp32 and bf16."""
    cfg, hf = _hf_model(name)
    hf.save_pretrained(tmp_path, max_shard_size="100KB", safe_serialization=True)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".safetensors")]) >= 2
    for dtype in ("float32", "bfloat16"):
        got = ckpt.load_hf_checkpoint(cfg.replace(dtype=dtype), str(tmp_path))
        ref = jckpt.load_hf_checkpoint(j_get_config(name).replace(dtype=dtype), str(tmp_path))
        _assert_same(got, _to_port(ref))


def test_load_hf_checkpoint_raises_without_shards(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        ckpt.load_hf_checkpoint(get_config("opt-tiny"), str(tmp_path))


def test_server_serves_a_checkpoint(tmp_path):
    """``--checkpoint DIR`` (HF shards) serves the loaded tree's tokens."""
    from lia_tpu_torch.serve import build_frontend, parse_args

    cfg, hf = _hf_model("llama-tiny")
    hf.save_pretrained(tmp_path, safe_serialization=True)
    params = ckpt.load_hf_checkpoint(cfg, str(tmp_path))
    prompt = [5, 9, 23, 41, 7]
    ref = InferenceEngine(cfg, params, device="cpu").generate([prompt], GenerationConfig(max_new_tokens=5))
    frontend = build_frontend(parse_args(["-m", "llama-tiny", "--device", "cpu", "--dtype", "float32",
                                          "--checkpoint", str(tmp_path), "--max-new-tokens", "5", "--max-len", "64"]))
    cb = frontend.batcher
    rid = cb.submit(prompt)
    out = {r.req_id: r.output for r in cb.run()}[rid]
    assert [int(t) for t in out] == ref.sequences[0].tolist()
