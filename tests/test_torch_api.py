"""The port's front door against the JAX package on the CPU: ``load_engine``,
the ``run`` CLI and hypertune.

``load_engine(dtype="float32", dummy=True, device="cpu")`` gives
``lia_tpu.load_engine``'s greedy tokens exactly for an OPT and a llama-layout
model, resident, under a tiered runtime (hbm 50, policies (0, 2)) and under
``auto_placement`` (both packages' profile patched to one that holds half the
layers); GPTQ, SmoothQuant (alpha 0.5, int8) and static-int8 give
``lia_tpu.load_engine``'s tokens, and SmoothQuant without a weight-only
format raises its ValueError; what the port lacks raises naming its
ROADMAP.md item; the CLI prints the reference's JSON keys, and its three
quantization flows run; hypertune's candidates are the reference's, and a
failed candidate is recorded with its message.
"""

import dataclasses
import json

import pytest

pytest.importorskip("jax")

import numpy as np

import lia_tpu
from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.config import QuantConfig as JQuant
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.runtime import cost_model as jcm
from lia_tpu.utils import hypertune as jht
from lia_tpu.utils.metrics import LatencyStats as JLatency

from lia_tpu_torch import run
from lia_tpu_torch.api import load_engine
from lia_tpu_torch.config import GenerationConfig, QuantConfig
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.runtime import cost_model as tcm
from lia_tpu_torch.utils import device_caps
from lia_tpu_torch.utils.hypertune import Hypertune

PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 4, 90], [100, 200, 300, 17]]
NEW = 6
AUTO = dict(batch=3, in_len=8, out_len=NEW)


@pytest.fixture
def half_resident(monkeypatch):
    """Both packages' system_profile_defaults patched to one profile whose
    memory holds one of a tiny model's two layers (a relayed link)."""
    def profile(name):
        base = dict(dataclasses.asdict(tcm.SystemProfile()), h2d_bw=1e9, h2d_latency_s=0.01, host_flops=2e12)
        cm = tcm.CostModel(get_config(name).replace(dtype="float32"), tcm.SystemProfile(**base))
        cfg, B, S = cm.cfg, AUTO["batch"], AUTO["in_len"] + AUTO["out_len"]
        embed = cfg.vocab_size * cfg.embed_dim * 2 * (1 if cfg.tie_embeddings else 2)
        base["hbm_bytes"] = (embed + 2 * B * S * cfg.hidden_size * 2
                             + 1.5 * (cm.weight_bytes_per_layer() + cm.kv_bytes_per_layer(B, S)))
        return base

    import lia_tpu.utils.device_caps as jcaps

    def patch(name):
        fields = profile(name)
        monkeypatch.setattr(jcaps, "system_profile_defaults", lambda: jcm.SystemProfile(**fields))
        monkeypatch.setattr(device_caps, "system_profile_defaults", lambda: tcm.SystemProfile(**fields))

    return patch


@pytest.mark.parametrize("placement", ["resident", "tiered", "auto"])
@pytest.mark.parametrize("model", ["opt-tiny", "llama-tiny"])
def test_load_engine_tokens_equal_lia_tpu(model, placement, half_resident):
    kw = {"resident": {}, "tiered": dict(hbm_percentage=50, prefill_policy=0, decode_policy=2),
          "auto": dict(auto_placement=True, **AUTO)}[placement]
    if placement == "auto":
        half_resident(model)
    j = lia_tpu.load_engine(model, dtype="float32", dummy=True, **kw)
    t = load_engine(model, dtype="float32", dummy=True, device="cpu", **kw)
    for f in ("prefill_policy", "decode_policy", "hbm_percentage", "stream_weights"):
        assert getattr(t.runtime, f) == getattr(j.runtime, f), f
    if placement == "auto":
        assert t.runtime.hbm_percentage == 50 and t.scheduler.wm.n_resident == 1
    assert (t.scheduler is None) == (placement == "resident")
    ref = j.generate(PROMPTS, JGen(max_new_tokens=NEW)).sequences
    out = t.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_load_engine_quantized_dummy_equals_lia_tpu():
    """A weight-only int8 dummy tree drawn in quantized form, as the reference's."""
    j = lia_tpu.load_engine("opt-tiny", dtype="float32", dummy=True, weight_dtype="int8")
    t = load_engine("opt-tiny", dtype="float32", dummy=True, weight_dtype="int8", device="cpu")
    assert t.params["layers"]["attn"]["wqkv"].fmt == "woq_int8"
    ref = j.generate(PROMPTS, JGen(max_new_tokens=NEW)).sequences
    np.testing.assert_array_equal(t.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences,
                                  np.asarray(ref))


@pytest.mark.parametrize("kw,item", [(dict(model="t5-tiny"), "A12"), (dict(model="llava-tiny"), "A12")])
def test_unported_load_engine_options_raise(kw, item):
    kw = {"model": "opt-tiny", **kw}
    with pytest.raises(NotImplementedError, match=item):
        load_engine(kw.pop("model"), dummy=True, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(gptq=True), dict(smoothquant=0.5, weight_dtype="int8"),
                                dict(weight_dtype="static-int8")])
def test_load_engine_quantization_flows_equal_lia_tpu(kw):
    """The three algorithms over the dummy fp tree and the default
    calibration prompts give lia_tpu.load_engine's fp32 tokens."""
    j = lia_tpu.load_engine("opt-tiny", dtype="float32", dummy=True, **kw)
    t = load_engine("opt-tiny", dtype="float32", dummy=True, device="cpu", **kw)
    fmt = {"gptq": "woq_int4z", "smoothquant": "woq_int8", "weight_dtype": "static_int8"}[next(iter(kw))]
    assert t.params["layers"]["attn"]["wqkv"].fmt == fmt
    ref = j.generate(PROMPTS, JGen(max_new_tokens=NEW)).sequences
    np.testing.assert_array_equal(t.generate(PROMPTS, GenerationConfig(max_new_tokens=NEW)).sequences,
                                  np.asarray(ref))


def test_smoothquant_needs_a_weight_only_format():
    with pytest.raises(ValueError, match="WOQ weight_dtype"):
        lia_tpu.load_engine("opt-tiny", dummy=True, smoothquant=0.5)
    with pytest.raises(ValueError, match="WOQ weight_dtype"):
        load_engine("opt-tiny", dummy=True, device="cpu", smoothquant=0.5)


def test_load_engine_needs_a_source_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="dummy=True"):
        load_engine("opt-tiny", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_engine("opt-tiny", dummy=True)


CLI = ["--benchmark", "-m", "opt-tiny", "--dummy-weights", "--device", "cpu", "--batch-size", "2",
       "--input-tokens", "8", "--max-new-tokens", "4", "--num-iter", "1", "--num-warmup", "1"]


def test_cli_prints_the_reference_json(capsys, tmp_path):
    assert run.main(CLI + ["--prefill-policy", "auto", "--decoding-policy", "auto", "--hbm-percentage", "auto",
                           "--output-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "[lia-tpu] auto placement: prefill=3 decode=3 hbm%=100" in lines
    assert sum(line.startswith("[warmup 0]") for line in lines) == 1
    assert sum(line.startswith("[iter 1]") for line in lines) == 1
    summary = json.loads(lines[-2])  # the summary file's line is the last
    keys = set(JLatency([0.1, 0.01, 0.01]).summary(2)) | {"model"}
    assert set(summary) == keys and summary["model"] == "opt-tiny"
    assert json.load(open(tmp_path / "summary.json")) == summary


@pytest.mark.parametrize("argv,item", [(["--tp", "2"], "A13"), (["-m", "t5-tiny"], "A12"),
                                       (["--no-pallas"], "use_pallas=False")])
def test_cli_unported_flags_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        run.main(CLI + argv)


@pytest.mark.parametrize("argv,line", [
    (["--gptq"], "[lia-tpu] gptq quantized (bits=4, group=128, actorder=False, act_quant=none)"),
    (["--smoothquant", "auto", "--weight-dtype", "int8", "--alpha-min", "0.4", "--alpha-max", "0.6"],
     "[lia-tpu] smoothquant folded with alpha="),
    (["--weight-dtype", "static-int8"], "[lia-tpu] static-int8 (W8A8) calibrated; smoothquant alpha=0.5"),
])
def test_cli_quantization_flows_run(argv, line, capsys):
    """The CLI's three flows print the reference's line and its JSON keys."""
    assert run.main(CLI + argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(x.startswith(line) for x in lines), lines
    if "auto" in argv:
        alpha = float(next(x for x in lines if x.startswith(line))[len(line):])
        assert alpha in (0.4, 0.5, 0.6)
    assert set(json.loads(lines[-1])) == set(JLatency([0.1, 0.01, 0.01]).summary(2)) | {"model"}


def test_hypertune_candidates_equal_lia_tpu():
    spaces = [dict(), dict(prefill_policies=(0, 3), decode_policies=(0, 1, 2, 3), hbm_percentages=(50,),
                           num_minibatches=(1,))]
    for sp in spaces:
        j = jht.Hypertune(j_get_config("opt-tiny"), None, quant=JQuant(weight_dtype="int8"), **sp).candidates()
        t = Hypertune(get_config("opt-tiny"), None, quant=QuantConfig(weight_dtype="int8"), **sp).candidates()
        assert [dataclasses.asdict(c) for c in t] == [dataclasses.asdict(c) for c in j]


def test_hypertune_records_a_failed_candidate():
    """A candidate that cannot run (policy 7) is skipped and kept in failures
    with its message; the others run and come back best first."""
    cfg = get_config("opt-tiny").replace(dtype="float32")
    from lia_tpu_torch.utils.checkpoint import init_dummy_params

    ht = Hypertune(cfg, init_dummy_params(cfg), gen=GenerationConfig(max_new_tokens=3), batch=2, input_tokens=6,
                   prefill_policies=(3,), decode_policies=(3, 7), hbm_percentages=(50,), num_minibatches=(1,),
                   device="cpu")
    results = ht.run(verbose=False)
    assert [(r.runtime.decode_policy, r.runtime.hbm_percentage) for r in results] == [(3, 50)]
    assert results[0].tokens_per_s > 0
    assert len(ht.failures) == 1
    rt, msg = ht.failures[0]
    assert rt.decode_policy == 7 and "unknown policy 7" in msg
