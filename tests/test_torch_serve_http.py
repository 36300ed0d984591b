"""The port's HTTP front end (lia_tpu_torch.serve) on the CPU: handler threads
submit, the engine thread steps, and each request's output over HTTP equals
lia_tpu's batcher's for the same prompt (as tests/test_serve_http.py holds the
root serve.py)."""

import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import pytest

pytest.importorskip("jax")

from lia_tpu.config import GenerationConfig as JGen
from lia_tpu.engine.serving import ContinuousBatcher as JBatcher
from lia_tpu.models.registry import get_config as j_get_config
from lia_tpu.utils.checkpoint import init_dummy_params as j_init

from lia_tpu_torch.config import GenerationConfig
from lia_tpu_torch.engine.serving import ContinuousBatcher
from lia_tpu_torch.models.registry import get_config
from lia_tpu_torch.serve import ServingFrontend, build_frontend, make_handler, parse_args
from lia_tpu_torch.utils.checkpoint import params_from_jax


@pytest.fixture(scope="module")
def server():
    jcfg = j_get_config("opt-tiny").replace(dtype="float32")
    jp = j_init(jcfg, seed=21, scale=0.12)
    batcher = ContinuousBatcher(get_config("opt-tiny").replace(dtype="float32"), params_from_jax(jp), max_batch=2,
                                max_len=128, gen=GenerationConfig(max_new_tokens=6), paged=True, block_size=8,
                                device="cpu")
    frontend = ServingFrontend(batcher)
    frontend.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(frontend))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield jcfg, jp, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    frontend.stop()


def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(obj), {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_http_generate_matches_lia_tpu(server):
    jcfg, jp, port = server
    prompts = [[5, 9, 23, 41], [100, 7, 3], [8, 8, 8, 12]]
    direct = JBatcher(jcfg, jp, max_batch=2, max_len=128, gen=JGen(max_new_tokens=6))
    ids = [direct.submit(p) for p in prompts]
    by_id = {r.req_id: [int(x) for x in r.output] for r in direct.run()}
    results = {}

    def call(i, p):
        results[i] = _post(port, "/generate", {"prompt_ids": p})

    threads = [threading.Thread(target=call, args=(i, p)) for i, p in enumerate(prompts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert sorted(results) == [0, 1, 2]
    for i, (status, out) in results.items():
        assert status == 200
        assert out["output_ids"] == by_id[ids[i]], f"prompt {i} over HTTP"
        assert out["ttft_s"] > 0 and out["latency_s"] > 0
    status, out = _post(port, "/generate", {"prompt_ids": [5, 9, 23, 41], "max_new_tokens": 3})
    assert status == 200 and out["output_ids"] == by_id[ids[0]][:3]


def test_http_stats_health_and_errors(server):
    _, _, port = server
    status, health = _get(port, "/health")
    assert status == 200 and health == {"status": "ok"}
    status, stats = _get(port, "/stats")
    assert status == 200 and stats["requests"] >= 1.0 and "prefix_hits" in stats
    assert stats["queued"] == 0.0 and "running" in stats
    status, err = _post(port, "/generate", {"prompt": "no tokenizer configured"})
    assert status == 400 and "tokenizer" in err["error"]
    status, err = _post(port, "/generate", {"prompt_ids": [1, 2], "repetition_penalty": 1.3})
    assert status == 400 and "enable_processors" in err["error"]  # this batcher has no processors
    assert _get(port, "/nowhere")[0] == 404


def test_build_frontend_on_the_cpu_and_checkpoint_raises():
    """The CLI's builder: random weights from the registry on the requested
    device; a checkpoint that is not there raises (checkpoints that are load:
    tests/test_torch_checkpoint.py)."""
    args = parse_args(["-m", "opt-tiny", "--dtype", "float32", "--device", "cpu", "--paged", "--max-batch", "2",
                       "--max-len", "64", "--max-new-tokens", "3"])
    fe = build_frontend(args)
    assert fe.batcher.paged and fe.batcher.B == 2 and fe.batcher.device.type == "cpu"
    fe.batcher.submit([5, 6, 7])
    assert len(fe.batcher.run()[0].output) == 3
    with pytest.raises(FileNotFoundError):
        build_frontend(parse_args(["-m", "opt-tiny", "--device", "cpu", "--checkpoint", "no-such-checkpoint"]))
