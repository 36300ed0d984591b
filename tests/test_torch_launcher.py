"""The port's multi-instance launcher (``lia_tpu_torch.utils.launcher``, the
``ipexrun --ninstances`` analog) against ``lia_tpu.utils.launcher``, as
``tests/test_launcher.py`` holds lia_tpu's: the device slices (the same
partition, over ``CUDA_VISIBLE_DEVICES``), the command templates, replica
supervision with each child's environment, the round-robin proxy, and
``main`` over two child processes.
"""

import json
import sys
import threading
import urllib.request

import pytest

pytest.importorskip("jax")

from lia_tpu.utils import launcher as jlauncher

from lia_tpu_torch.utils.launcher import ReplicaSet, build_commands, device_slices, main, make_proxy


@pytest.mark.parametrize("n,d", [(2, 8), (3, 8), (4, 2), (2, 0), (1, 1), (3, 7)])
def test_device_slices_equal_lia_tpu(n, d):
    assert device_slices(n, d) == jlauncher.device_slices(n, d)


def test_device_slices_partition():
    assert device_slices(2, 8) == ["0,1,2,3", "4,5,6,7"]
    assert device_slices(3, 8) == ["0,1", "2,3", "4,5"]  # the remainder unused
    assert device_slices(4, 2) == ["0", "1", "0", "1"]  # round-robin: replicas share a card
    assert device_slices(2, 0) == ["", ""]


def test_build_commands_templating_and_default_port():
    for template in (["x", "--port", "{port}", "--id", "{instance}"], ["x"]):
        assert build_commands(template, 2, 9000) == jlauncher.build_commands(template, 2, 9000)
    assert build_commands(["x", "--port", "{port}", "--id", "{instance}"], 2, 9000) == [
        ["x", "--port", "9000", "--id", "0"], ["x", "--port", "9001", "--id", "1"]]
    assert build_commands(["x"], 2, 9000) == [["x", "--port", "9000"], ["x", "--port", "9001"]]


_ENV_SCRIPT = ("import json,os,sys; json.dump({'i': os.environ.get('LIA_INSTANCE'),"
               " 'dev': os.environ.get('CUDA_VISIBLE_DEVICES')}, open(sys.argv[1], 'w'))")


def test_replicaset_runs_and_sets_env(tmp_path):
    cmds = [[sys.executable, "-c", _ENV_SCRIPT, str(tmp_path / f"env{i}.json")] for i in range(2)]
    rs = ReplicaSet(cmds, ["0,1", "2,3"])
    rs.start()
    assert rs.wait(timeout=30) == [0, 0]
    for i, dev in enumerate(["0,1", "2,3"]):
        assert json.load(open(tmp_path / f"env{i}.json")) == {"i": str(i), "dev": dev}


def test_main_runs_the_replicas_and_returns_their_worst_code(tmp_path):
    """``main`` fills ``{instance}`` and appends ``--port``; with two cards
    each child sees its own; the exit code is the largest child's."""
    script = _ENV_SCRIPT + "; sys.exit(int(os.environ['LIA_INSTANCE']) * 3)"
    rc = main(["-n", "2", "--devices", "2", "--port", "9100", "--", sys.executable, "-c", script,
               str(tmp_path / "env{instance}.json")])
    assert rc == 3
    for i in range(2):
        assert json.load(open(tmp_path / f"env{i}.json")) == {"i": str(i), "dev": str(i)}


def test_proxy_round_robins_two_backends():
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def backend(tag):
        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("X-Tag", tag)
                self.end_headers()
                self.wfile.write(json.dumps({"tag": tag, "auth": self.headers.get("Authorization")}).encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                self.send_response(200)
                self.end_headers()
                self.wfile.write(json.dumps({"tag": tag, "echo": body.decode()}).encode())

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    b1, b2 = backend("a"), backend("b")
    proxy = make_proxy(0, [b1.server_port, b2.server_port])
    threading.Thread(target=proxy.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{proxy.server_port}"
    try:
        req = lambda: urllib.request.Request(f"{url}/x", headers={"Authorization": "t0k"})
        got = [json.load(urllib.request.urlopen(req(), timeout=10)) for _ in range(4)]
        tags = [g["tag"] for g in got]
        assert sorted(tags[:2]) == ["a", "b"] and tags[:2] == tags[2:]
        assert all(g["auth"] == "t0k" for g in got)  # end-to-end headers pass through
        resp = urllib.request.urlopen(urllib.request.Request(f"{url}/generate", data=b'{"p": 1}'), timeout=10)
        assert json.load(resp)["echo"] == '{"p": 1}' and resp.headers["X-LIA-Replica"] is not None
        reps = json.load(urllib.request.urlopen(f"{url}/replicas", timeout=10))
        assert reps["ports"] == [b1.server_port, b2.server_port]
    finally:
        for s in (proxy, b1, b2):
            s.shutdown()
            s.server_close()
