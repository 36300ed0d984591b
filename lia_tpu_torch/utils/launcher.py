"""Multi-instance serving launcher, the ``ipexrun --ninstances`` analog
(port of ``lia_tpu/utils/launcher.py``).

The reference's only data parallelism is N independent serving instances. On
GPUs the resource sliced is the CARDS: each replica gets a disjoint slice of
the host's devices through ``CUDA_VISIBLE_DEVICES``. Ports step from
``--port``. One command brings up N replicas, and a stdlib round-robin proxy
(optional) gives them one endpoint::

    python -m lia_tpu_torch.utils.launcher -n 4 --proxy-port 8000 -- \
        python -m lia_tpu_torch.serve -m opt-1.3b --port {port}

``{port}`` / ``{instance}`` placeholders are substituted per replica;
without ``{port}``, ``--port <base+i>`` is appended. SIGINT/SIGTERM fan out
to the children; the launcher exits when every child has exited, with the
largest exit code.
"""

from __future__ import annotations

import argparse
import itertools
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional


def device_slices(n_instances: int, n_devices: int) -> List[str]:
    """Disjoint CUDA_VISIBLE_DEVICES strings, one per instance. With fewer
    devices than instances the devices round-robin (replicas share a card);
    with more, each instance gets an equal contiguous block (remainder
    devices go unused: equal replicas beat ragged ones for serving)."""
    if n_devices <= 0:
        return [""] * n_instances
    if n_devices < n_instances:
        return [str(i % n_devices) for i in range(n_instances)]
    per = n_devices // n_instances
    return [
        ",".join(str(d) for d in range(i * per, (i + 1) * per))
        for i in range(n_instances)
    ]


def build_commands(template: List[str], n: int, base_port: int) -> List[List[str]]:
    cmds = []
    for i in range(n):
        port = base_port + i
        sub = [a.format(port=port, instance=i) if ("{port}" in a or "{instance}" in a) else a
               for a in template]
        if not any("{port}" in a for a in template):
            sub = sub + ["--port", str(port)]
        cmds.append(sub)
    return cmds


class ReplicaSet:
    """Spawn + supervise N replica processes."""

    def __init__(self, cmds: List[List[str]], slices: List[str], env=None):
        self.cmds = cmds
        self.slices = slices
        self.env = env or os.environ
        self.procs: List[subprocess.Popen] = []

    def start(self) -> None:
        for i, (cmd, sl) in enumerate(zip(self.cmds, self.slices)):
            env = dict(self.env)
            env["LIA_INSTANCE"] = str(i)
            if sl:
                env["CUDA_VISIBLE_DEVICES"] = sl
            self.procs.append(subprocess.Popen(cmd, env=env))

    def terminate(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        end = None if timeout is None else time.time() + timeout
        codes = []
        for p in self.procs:
            left = None if end is None else max(0.0, end - time.time())
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes


def make_proxy(proxy_port: int, backend_ports: List[int], host: str = "127.0.0.1"):
    """Round-robin reverse proxy (stdlib): each request forwards to the next
    replica. GET /replicas reports the backend list. Returns the HTTPServer
    (caller runs serve_forever, typically on a thread)."""
    import http.client
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    rr = itertools.cycle(backend_ports)
    lock = threading.Lock()

    # hop-by-hop headers are connection-scoped and must not be forwarded
    # (RFC 9110 §7.6.1); everything else (auth, accept, content-type, custom)
    # passes through both ways
    _HOP = {"connection", "keep-alive", "proxy-authenticate",
            "proxy-authorization", "te", "trailer", "transfer-encoding",
            "upgrade", "host", "content-length"}

    class Handler(BaseHTTPRequestHandler):
        def _forward(self, body: Optional[bytes]) -> None:
            with lock:
                port = next(rr)
            try:
                conn = http.client.HTTPConnection(host, port, timeout=600)
                fwd = {k: v for k, v in self.headers.items()
                       if k.lower() not in _HOP}
                conn.request(self.command, self.path, body=body, headers=fwd)
                resp = conn.getresponse()
                data = resp.read()
                self.send_response(resp.status)
                for k, v in resp.getheaders():
                    if k.lower() not in _HOP:
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-LIA-Replica", str(port))
                self.end_headers()
                self.wfile.write(data)
            except OSError as e:
                self.send_response(502)
                self.end_headers()
                self.wfile.write(str(e).encode())

        def do_GET(self):  # noqa: N802
            if self.path == "/replicas":
                import json

                self.send_response(200)
                self.end_headers()
                self.wfile.write(json.dumps({"ports": backend_ports}).encode())
                return
            self._forward(None)

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            self._forward(self.rfile.read(n) if n else None)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, proxy_port), Handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="launch N serving replicas over disjoint CUDA device slices "
                    "(ipexrun --ninstances analog)")
    ap.add_argument("-n", "--ninstances", type=int, default=2)
    ap.add_argument("--port", type=int, default=8100,
                    help="base port; replica i serves at port+i")
    ap.add_argument("--proxy-port", type=int,
                    help="also run a round-robin proxy at this port")
    ap.add_argument("--devices", type=int,
                    help="total CUDA devices to slice (default: torch.cuda.device_count())")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command template; {port}/{instance} substituted")
    args = ap.parse_args(argv)
    template = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not template:
        ap.error("missing command template after --")
    n_dev = args.devices
    if n_dev is None:
        import torch

        n_dev = torch.cuda.device_count()
    cmds = build_commands(template, args.ninstances, args.port)
    rs = ReplicaSet(cmds, device_slices(args.ninstances, n_dev))
    rs.start()
    stop = lambda *a: rs.terminate()
    signal.signal(signal.SIGINT, stop)
    signal.signal(signal.SIGTERM, stop)
    proxy = None
    if args.proxy_port:
        proxy = make_proxy(args.proxy_port,
                           [args.port + i for i in range(args.ninstances)])
        threading.Thread(target=proxy.serve_forever, daemon=True).start()
        print(f"[lia-tpu-launch] proxy :{args.proxy_port} -> "
              f"{args.ninstances} replicas from :{args.port}", file=sys.stderr)
    codes = rs.wait()
    if proxy is not None:
        proxy.shutdown()
    return max(codes, default=0)


if __name__ == "__main__":
    sys.exit(main())
