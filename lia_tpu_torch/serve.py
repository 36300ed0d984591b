"""HTTP serving front end over the port's continuous-batching engine
(port of the repository's root ``serve.py``).

Standard library only (``ThreadingHTTPServer``): handler threads queue requests
and block on completion events; ONE engine thread owns every CUDA call (the
batcher's steps). Weights come from ``--checkpoint``, a directory of Hugging
Face ``*.safetensors`` shards (``load_hf_checkpoint``, as the root server's
flag); without it they are random, drawn on the device from a seed at the
registry's widths (``device_dummy_params``). The quantization flags quantize
a checkpoint's weights on the host (``quantize_params``) and draw dummy
weights directly in the quantized formats.

    python -m lia_tpu_torch.serve -m opt-1.3b --paged --port 8000
    python -m lia_tpu_torch.serve -m falcon-7b --checkpoint /path/to/falcon-7b --port 8000
    curl -d '{"prompt_ids": [5, 9, 23], "max_new_tokens": 16}' localhost:8000/generate

Endpoints:
  POST /generate  {"prompt_ids": [...]}, or {"prompt": "text"} where the
                  ServingFrontend was given a tokenizer (a Hugging Face-style
                  callable with ``decode``; the CLI gives none: the port
                  imports no ``transformers``)
                  + optional max_new_tokens, do_sample, temperature, top_k,
                  top_p, stop_token_ids, and the logits processors'
                  repetition_penalty, min_new_tokens, no_repeat_ngram_size
                  (these three need a batcher built with enable_processors,
                  ``--enable-processors``; without it they answer 400)
  GET  /stats     throughput / TTFT / TPOT / prefix-cache counters + queue depth
  GET  /health
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch


class ServingFrontend:
    """Thread-safe facade: handler threads submit, the engine thread steps."""

    def __init__(self, batcher, tokenizer=None):
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.lock = threading.Lock()
        self.events: dict[int, threading.Event] = {}
        self.requests: dict[int, object] = {}
        self._n_done = 0
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self._stop = True
        self.thread.join(timeout=30)

    def _loop(self):
        while not self._stop:
            with self.lock:
                b = self.batcher
                busy = bool(b.queue) or b.active.any() or b._pending is not None
                if busy:
                    b.step()
                for r in b.done[self._n_done:]:
                    self._n_done += 1
                    self.requests[r.req_id] = r
                    ev = self.events.pop(r.req_id, None)
                    if ev is not None:
                        ev.set()
            if not busy:
                time.sleep(0.005)

    def submit(self, prompt_ids, **kw) -> int:
        ev = threading.Event()
        with self.lock:
            rid = self.batcher.submit(prompt_ids, **kw)
            self.events[rid] = ev
        return rid

    def wait(self, rid: int, timeout: float = 600.0):
        ev = self.events.get(rid)
        if ev is not None and not ev.wait(timeout):
            raise TimeoutError(f"request {rid} timed out after {timeout}s")
        return self.requests.pop(rid)

    def stats(self) -> dict:
        with self.lock:
            s = self.batcher.stats()
            s["queued"] = float(len(self.batcher.queue))
            s["running"] = float(self.batcher.active.sum())
        return s


REQUEST_KEYS = ("max_new_tokens", "do_sample", "temperature", "top_k", "top_p", "stop_token_ids",
                "repetition_penalty", "min_new_tokens", "no_repeat_ngram_size")


def make_handler(frontend: ServingFrontend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access logs
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                self._json(200, frontend.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                ids = req.get("prompt_ids")
                if ids is None:
                    text = req.get("prompt")
                    if text is None or frontend.tokenizer is None:
                        raise ValueError("pass prompt_ids (a text prompt needs a tokenizer, and this server has none)")
                    ids = frontend.tokenizer(text)["input_ids"]
                kw = {k: req[k] for k in REQUEST_KEYS if k in req}
                rid = frontend.submit([int(t) for t in ids], **kw)
                r = frontend.wait(rid)
                out = {
                    "request_id": rid,
                    "output_ids": r.output,
                    "ttft_s": r.ttft_s,
                    "latency_s": r.finished_at - r.submitted_at,
                }
                if frontend.tokenizer is not None:
                    out["text"] = frontend.tokenizer.decode(r.output)
                self._json(200, out)
            except (ValueError, NotImplementedError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def build_frontend(args) -> ServingFrontend:
    from lia_tpu_torch.config import GenerationConfig, QuantConfig
    from lia_tpu_torch.engine.serving import ContinuousBatcher
    from lia_tpu_torch.models.registry import get_config
    from lia_tpu_torch.ops.quant import quantize_params
    from lia_tpu_torch.utils.checkpoint import device_dummy_params, load_hf_checkpoint, to_device

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("the server needs a CUDA device (pass --device cpu to run on the CPU)")
    device = torch.device(args.device or "cuda")
    cfg = get_config(args.model).replace(dtype=args.dtype)
    quant = QuantConfig(weight_dtype=args.weight_dtype, group_size=args.group_size, act_quant=args.act_quant)
    if args.checkpoint:
        params = load_hf_checkpoint(cfg, args.checkpoint)
        if quant.enabled:
            params = quantize_params(cfg, params, quant)
        params = to_device(params, device)
    else:
        params = device_dummy_params(cfg, seed=0, device=device, quant=quant if quant.enabled else None)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens, eos_token_id=args.eos_token_id)
    batcher = ContinuousBatcher(
        cfg, params, max_batch=args.max_batch, max_len=args.max_len, gen=gen,
        paged=args.paged, block_size=args.block_size, prefill_chunk=args.prefill_chunk,
        speculate_k=args.speculate_k, fused_steps=args.fused_steps,
        enable_processors=args.enable_processors or None, device=device,
    )
    return ServingFrontend(batcher)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="lia_tpu_torch HTTP serving")
    ap.add_argument("-m", "--model", default="opt-1.3b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", help="default: cuda")
    ap.add_argument("--checkpoint", help="a directory of Hugging Face *.safetensors shards")
    ap.add_argument("--weight-dtype", default="none")
    ap.add_argument("--group-size", type=int, default=-1)
    ap.add_argument("--act-quant", default="none")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--eos-token-id", type=int)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int)
    ap.add_argument("--speculate-k", type=int)
    ap.add_argument("--fused-steps", type=int, default=1,
                    help="decode up to K tokens per dispatch when no chunked admission is in flight")
    ap.add_argument("--enable-processors", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    frontend = build_frontend(args)
    frontend.start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(frontend))
    print(f"serving {args.model} on http://{args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        frontend.stop()


if __name__ == "__main__":
    main()
