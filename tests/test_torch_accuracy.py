"""The port's lm-eval adapter and accuracy runner against the JAX package's
on the CPU, in fp32, on the same numpy weights.

The adapter (:class:`lia_tpu_torch.utils.lm_eval_adapter.LiaTPULM`) over a
word tokenizer, as ``tests/test_tools.py`` drives lia_tpu's: the
log-likelihoods of (context, continuation) pairs (empty context conditioned
on the eot token) equal the port's own ``score`` and lia_tpu's adapter
within 1e-5, the greedy flags equal, ``generate_until`` gives the same cut
text, rolling log-likelihoods agree within 1e-5; ``make_lm_eval_model``
raises ImportError without ``lm_eval``. ``python -m
lia_tpu_torch.run_accuracy`` with ``--self-test`` and ``--dataset`` prints
lia_tpu's runner's JSON (counts and accuracy equal, log-likelihoods within
1e-5), also over a static-INT8 tree; ``--lm-eval`` fails as the reference's
does; T5 raises naming ROADMAP A12.
"""

import json
import os

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from lia_tpu.config import RuntimeConfig as JRuntime
from lia_tpu.engine.engine import InferenceEngine as JEngine
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils.checkpoint import init_dummy_params as j_init
from lia_tpu.utils.lm_eval_adapter import LiaTPULM as JLiaTPULM

from lia_tpu_torch import run_accuracy
from lia_tpu_torch.engine.engine import InferenceEngine
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.utils.checkpoint import params_from_jax
from lia_tpu_torch.utils.lm_eval_adapter import LiaTPULM, make_lm_eval_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the many small CPU ops here run faster without a
    pool contending with XLA's threads in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubTokenizer:
    """Whitespace word → id tokenizer (ids from a stable hash)."""

    eos_token_id = 2

    def encode(self, s, add_special_tokens=False):
        return [3 + sum(map(ord, w)) * 7 % 400 for w in s.split()]

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


@pytest.fixture(scope="module")
def engines():
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=7)
    return (JEngine(jcfg, jp, JRuntime()),
            InferenceEngine(get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp), device="cpu"))


PAIRS = [("the quick brown fox", "jumps over"), ("", "hello world"), ("a b c d e ", "f"),
         ("one two three four five six", "seven")]


def test_adapter_loglikelihood_equals_score_and_lia_tpu(engines):
    jeng, eng = engines
    lm = LiaTPULM(eng, StubTokenizer(), batch_size=3, max_length=64)
    ref = JLiaTPULM(jeng, StubTokenizer(), batch_size=3, max_length=64).loglikelihood_pairs(PAIRS)
    out = lm.loglikelihood_pairs(PAIRS)
    assert len(out) == len(PAIRS)
    for (ll, greedy), (rll, rgreedy) in zip(out, ref):
        assert isinstance(greedy, bool) and greedy == rgreedy
        assert np.isfinite(ll) and ll <= 0.0 and abs(ll - rll) <= 1e-5 * max(1.0, abs(rll))
    c, t = lm._encode_pair(*PAIRS[0])
    assert (c, t) == JLiaTPULM(jeng, StubTokenizer())._encode_pair(*PAIRS[0])
    np.testing.assert_allclose(out[0][0], float(eng.score([c], [t])[0][0]), rtol=1e-6)


def test_adapter_generate_until_equals_lia_tpu(engines):
    jeng, eng = engines
    reqs = [("some prompt text", {"until": ["t1"], "max_gen_toks": 5}),
            ("another one", {"until": [" "], "max_gen_toks": 3}), ("", {})]
    kw = dict(batch_size=2, max_length=64, max_gen_toks=4)
    out = LiaTPULM(eng, StubTokenizer(), **kw).generate_until_pairs(reqs)
    assert out == JLiaTPULM(jeng, StubTokenizer(), **kw).generate_until_pairs(reqs)
    assert " " not in out[1] and len(out) == 3


def test_adapter_rolling_equals_lia_tpu(engines):
    jeng, eng = engines
    texts = ["one two three four five six seven eight nine ten eleven twelve thirteen", "short"]
    out = LiaTPULM(eng, StubTokenizer(), max_length=6).loglikelihood_rolling_texts(texts)
    ref = JLiaTPULM(jeng, StubTokenizer(), max_length=6).loglikelihood_rolling_texts(texts)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert all(np.isfinite(v) and v < 0 for v in out)


def test_make_lm_eval_model_needs_lm_eval(engines):
    try:
        import lm_eval  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="lm_eval"):
            make_lm_eval_model(engines[1], StubTokenizer())
    else:
        assert hasattr(make_lm_eval_model(engines[1], StubTokenizer()), "loglikelihood")


BASE = ["-m", "opt-tiny", "--dummy-weights", "--dtype", "float32"]


@pytest.fixture
def j_main(monkeypatch):
    """lia_tpu's runner (the repo's ``run_accuracy.py``), imported with its
    native-build switch held at its current value (off unless set), so no
    other test in the process sees it change."""
    monkeypatch.setenv("LIA_NATIVE_AUTOBUILD", os.environ.get("LIA_NATIVE_AUTOBUILD", "0"))
    import run_accuracy as j_run_accuracy

    return j_run_accuracy.main


def _report(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same_report(got, ref):
    assert set(got) == set(ref) == {"n", "accuracy", "loglikelihood", "ppl"}
    assert got["n"] == ref["n"] and got["accuracy"] == ref["accuracy"]
    assert abs(got["loglikelihood"] - ref["loglikelihood"]) <= 1e-5 * abs(ref["loglikelihood"])
    assert abs(got["ppl"] - ref["ppl"]) <= 1e-5 * ref["ppl"]


@pytest.mark.parametrize("extra", [[], ["--weight-dtype", "static-int8"]])
def test_run_accuracy_self_test_equals_lia_tpu(extra, capsys, j_main):
    argv = BASE + ["--self-test", "--limit", "8", "--batch-size", "4"] + extra
    ref = _report(j_main, argv, capsys)
    got = _report(run_accuracy.main, argv + ["--device", "cpu"], capsys)
    _same_report(got, ref)
    assert got["n"] == 8 and got["accuracy"] == 1.0  # the model's own greedy tokens


def test_run_accuracy_dataset_equals_lia_tpu(tmp_path, capsys, j_main):
    ds = tmp_path / "data.jsonl"
    rng = np.random.default_rng(0)
    with open(ds, "w") as f:
        for i in range(5):
            f.write(json.dumps({"context": [int(x) for x in rng.integers(3, 400, size=6 + i)],
                                "continuation": [int(x) for x in rng.integers(3, 400, size=1 + i % 2)]}) + "\n")
            f.write("\n")
    argv = BASE + ["--dataset", str(ds), "--limit", "4", "--batch-size", "3"]
    got = _report(run_accuracy.main, argv + ["--device", "cpu"], capsys)
    _same_report(got, _report(j_main, argv, capsys))
    assert got["n"] == 4


def test_run_accuracy_refusals(capsys):
    with pytest.raises(SystemExit):
        run_accuracy.main(BASE + ["--device", "cpu", "--lm-eval"])
    assert "--lm-eval requires --tokenizer" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_accuracy.main(BASE + ["--device", "cpu", "--lm-eval", "--tokenizer", "nowhere"])
    assert "lm_eval is not installed" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_accuracy.main(BASE + ["--device", "cpu"])
    assert "provide --dataset or --self-test" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="A12"):
        run_accuracy.main(["-m", "t5-tiny", "--dummy-weights", "--device", "cpu", "--self-test"])
