"""Serving worker: an HTTP server and a job-queue entry.

Port of ``stablediffusion_tpu/serve/worker.py``: a threaded HTTP server that
takes the job schema {id, input: {...}} by POST /, answers health checks on
GET /, serves the web UI (``serve/webapp.index_html``) on GET /ui, and
merges concurrent txt2img requests through the micro-batcher
(``--max_batch`` > 1); and ``trigger_fn``, the job-queue entry with the same
schema, which ``main`` registers with ``runpod.serverless.start`` when the
``runpod`` package imports (it serves HTTP otherwise)::

    python -m stablediffusion_tpu_torch.serve.worker \\
        --model_dir D --model_name N [--model_type sdxl|sd15|sd3] [--lora_dir L] \\
        [--quantize auto|w8|w8a8|w8a8:N] [--warmup] [--device cpu]

loads the diffusers folder ``D/{model_type}_N`` (``--model_type`` "sdxl"
unless given, as in JAX; "sd3" serves an SD3-family folder, with or without
T5), or the A1111 single file ``D/N`` when N ends in .safetensors or .ckpt
(SD1.x and SDXL), onto the card and serves it on ``--port`` (8000).
Requests' ``loras`` are read from ``L/{model_type}_{name}.safetensors``
(``--lora_dir``, default the model dir).  ``--quantize`` quantizes the
loaded model after ``expected_batch`` is set from ``--max_batch``, so
"auto" resolves for the batcher's merge batch.  The server, its handler and
its batcher are one object (``make_server``), so a program can run one in a
thread and shut it down; ``trigger_fn`` goes through the server that
``make_server`` made last while it is open (its batcher, or the lock its serial
requests share), else through ``get_handler()`` under that lock.

Under ``torchrun`` with ``--mesh_dp N [--mesh_tp K]`` (N x K processes, one
per GPU; -1 takes every rank the tensor axis leaves) every rank builds the
same handler and model; rank 0 serves HTTP and the batcher, and the other
ranks follow its calls (``serve/handler.Handler.follow``): merged batches
split over the data groups, the denoiser over the tensor ranks.  The
kernels build into the persistent cache (``core/compile_cache``).

    torchrun --nproc_per_node 2 -m stablediffusion_tpu_torch.serve.worker \
        --model_dir D --model_name N --mesh_dp 2
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence

from stablediffusion_tpu_torch.serve.batcher import Batcher
from stablediffusion_tpu_torch.serve.handler import Handler

logger = logging.getLogger(__name__)

# the model slot has a single writer: serial requests of the server and
# trigger_fn take this lock
_LOCK = threading.Lock()
HANDLER: Optional[Handler] = None
SERVER: Optional["Server"] = None


def get_handler(**kw) -> Handler:
    """The worker's handler: the one ``make_server`` registered last, else a
    new one."""
    global HANDLER
    if HANDLER is None:
        HANDLER = Handler(**kw)
    return HANDLER


def trigger_fn(request: Dict[str, Any]) -> Dict[str, Any]:
    """Job-queue entry: {id, input: {mode?, model?, params?, prompt...}}."""
    if SERVER is not None:
        return SERVER.trigger(request)
    handler = get_handler()
    with _LOCK:
        return handler(request.get("input") or {}, request.get("id", ""))


class Server(ThreadingHTTPServer):
    """The HTTP server with its handler and, when max_batch > 1, its
    batcher.  Requests the batcher does not take run one at a time (the
    model slot has a single writer)."""

    # the stdlib accept backlog is 5: size it for a burst of clients
    request_queue_size = 128

    def __init__(self, addr, handler: Handler, batcher: Optional[Batcher] = None):
        super().__init__(addr, _HTTPHandler)
        self.handler = handler
        self.batcher = batcher
        self._lock = _LOCK

    def trigger(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Job entry: {id, input: {mode?, model?, params?, prompt...}}."""
        if self.batcher is not None:
            return self.batcher.submit(request.get("input") or {}, request.get("id", ""))
        with self._lock:
            return self.handler(request.get("input") or {}, request.get("id", ""))

    def server_close(self):
        global SERVER
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()
        if SERVER is self:
            SERVER = None


class _HTTPHandler(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        try:
            request = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as e:
            self._reply(400, {"error": f"bad json: {e}"})
            return
        result = self.server.trigger(request)
        self._reply(200 if "error" not in result else 500, result)

    def do_GET(self):  # noqa: N802 — health check and the web UI
        path = self.path.rstrip("/")
        if path == "/ui":
            from stablediffusion_tpu_torch.serve.webapp import index_html

            body = index_html().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path:
            self._reply(404, {"error": f"no page {self.path!r}"})
            return
        self._reply(200, {"status": "ok", "model": getattr(
            self.server.handler.model, "model_type", None)})

    def _reply(self, code: int, obj: Dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        logger.info("%s " + fmt, self.client_address[0], *args)


def make_server(handler: Handler, host: str = "0.0.0.0", port: int = 8000,
                max_batch: int = 8, batch_window_ms: float = 25.0) -> Server:
    """A server bound to (host, port); port 0 picks a free one
    (``server.server_address``).  max_batch=1 serves strictly serially.
    The server and its handler become the ones ``trigger_fn`` and
    ``get_handler`` use."""
    global HANDLER, SERVER
    batcher = (Batcher(handler, max_batch=max_batch, window_ms=batch_window_ms)
               if max_batch > 1 else None)
    HANDLER, SERVER = handler, Server((host, port), handler, batcher)
    return SERVER


def serve_http(port: int = 8000, max_batch: int = 8, batch_window_ms: float = 25.0,
               host: str = "0.0.0.0", **handler_kw) -> None:
    """Serve until interrupted ("auto" quantization resolves for
    `max_batch`)."""
    handler = Handler(**handler_kw)
    handler.expected_batch = max(1, int(max_batch))
    server = make_server(handler, host, port, max_batch, batch_window_ms)
    logger.info("serving on %s:%d (max_batch=%d)", host, server.server_address[1], max_batch)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--model_type", type=str, default="sdxl")
    p.add_argument("--lora_dir", type=str, default=None,
                   help="where requests' LoRA files live (default: --model_dir)")
    p.add_argument("--model_name", type=str, default=None,
                   help="load this checkpoint before serving")
    p.add_argument("--max_batch", type=int, default=8,
                   help="HTTP micro-batch cap; 1 = serial")
    p.add_argument("--batch_window_ms", type=float, default=25.0)
    p.add_argument("--mesh_dp", type=int, default=0,
                   help="split merged batches over N data ranks (torchrun processes); "
                        "-1 = every rank the tensor axis leaves, 0 = off")
    p.add_argument("--mesh_tp", type=int, default=1,
                   help="split the denoiser's attention/MLP projections over K ranks "
                        "(ranks used = dp*tp)")
    p.add_argument("--quantize", default=None,
                   help="int8 mode applied to the preloaded model before --warmup (auto | "
                        "w8 | w8a8 | w8a8:N); 'auto' picks by --max_batch "
                        "(ops/quant.resolve_quant_mode); requests can still change it")
    p.add_argument("--device", default=None,
                   help="the device the handler loads models onto (default: cuda)")
    p.add_argument("--warmup", action="store_true",
                   help="run each batch size the batcher forms (powers of two "
                        "up to --max_batch) once before serving")
    return p.parse_args(argv)


def build_serving_mesh(dp: int, tp: int = 1, device=None):
    """``--mesh_dp N [--mesh_tp K]``: the process group from torchrun's
    environment and a data x tensor mesh over its ranks (JAX:
    ``worker.build_serving_mesh``); None for a 1 x 1 mesh without torchrun."""
    from stablediffusion_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed

    if not maybe_initialize_distributed(device) and dp in (0, 1, -1) and tp == 1:
        return None  # one process: no mesh overhead
    return make_mesh(data=dp if dp else -1, tensor=tp)


def build(args: argparse.Namespace) -> Server:
    """The server that ``main`` runs: the handler, the preloaded model, its
    quantization, the warmup, the batcher.  Under a mesh, call it on every
    rank; the ranks but 0 then run ``server.handler.follow()``."""
    from stablediffusion_tpu_torch.core.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    mesh = (build_serving_mesh(args.mesh_dp, args.mesh_tp, args.device)
            if (args.mesh_dp or args.mesh_tp > 1) else None)
    if mesh is not None:
        logger.info("serving mesh: %s", mesh.shape)
    handler = Handler(model_dir=args.model_dir, lora_dir=args.lora_dir, device=args.device,
                      mesh=mesh)
    # every rank runs the same set-up in step, so none of it is sent
    with handler.lockstep():
        # before --quantize, so that "auto" resolves for the merge batch
        handler.expected_batch = max(1, int(args.max_batch))
        if args.model_name:
            handler.maybe_reload_model({"type": args.model_type, "name": args.model_name})
        if args.quantize:
            if handler.model is None:
                logger.warning("--quantize ignored: no model preloaded")
            else:
                handler.maybe_reload_model({"quantize": args.quantize})
        if args.warmup:
            if handler.model is None:
                logger.warning("--warmup ignored: no model preloaded")
            else:
                # the batcher pads merged groups to powers of two
                batches = [1]
                while batches[-1] * 2 <= args.max_batch:
                    batches.append(batches[-1] * 2)
                handler.warmup(batches=tuple(batches))
    # only rank 0 serves HTTP: the other ranks bind a free port they close
    port = args.port if mesh is None or mesh.rank == 0 else 0
    return make_server(handler, args.host, port, args.max_batch, args.batch_window_ms)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    server = build(parse_args(argv))
    mesh = server.handler.mesh
    if mesh is not None and mesh.rank != 0:
        server.server_close()  # rank 0 serves; this rank renders its share
        server.handler.follow()
        return
    try:
        try:
            import runpod  # the serverless job queue, when installed
        except ImportError:
            logger.info("serving on %s:%d", *server.server_address[:2])
            server.serve_forever()
        else:
            runpod.serverless.start({"handler": trigger_fn})
    finally:
        server.handler.stop_followers()
        server.server_close()


if __name__ == "__main__":
    main()
