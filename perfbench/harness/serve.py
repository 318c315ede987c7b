"""The serving driver: the port's handler behind its micro-batcher, under a
closed loop of client threads, each submitting its next request when its
previous reply arrives (a serverless worker's backlog).  Set-up makes the
weights on the card, builds the model and warms every batch shape the
traffic forms; the window runs `seconds`, then drains what was sent."""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import List, Optional

import torch

from perfbench.harness import check, program, trace, traffic, weights


class _Tracer:
    """Wraps the handler's merged call so that a traced run profiles calls
    [first, first + count) whole: the device is drained before the first and
    after the last, and the profiler runs in between."""

    def __init__(self, handler, batcher, first: int, count: int, on_device: bool):
        self.batcher = batcher
        self.first, self.count, self.on_device = first, count, on_device
        self.calls, self.prof, self.traced = 0, None, []
        self._padded = batcher.padded_samples
        self._inner = handler._generate
        handler._generate = self._generate

    def _generate(self, args, output_type="uint8"):
        i = self.calls
        self.calls += 1
        if self.on_device and i in (self.first, self.first + self.count):
            torch.cuda.synchronize()
            if i == self.first:
                self.prof = trace.capture_start()
            else:
                self.prof.stop()
        # the batcher counts its padding rows just before the call
        pad, self._padded = self.batcher.padded_samples - self._padded, self.batcher.padded_samples
        if self.first <= i < self.first + self.count:
            rows = len(args["prompt"])
            self.traced.append({"rows": rows, "images": rows - pad})
        return self._inner(args, output_type)

    def finish(self) -> Optional[trace.DeviceTrace]:
        if self.prof is None:
            return None
        if self.calls < self.first + self.count:  # the window ended first
            torch.cuda.synchronize()
            self.prof.stop()
        return trace.reduce(self.prof)


class _Stages:
    """Seconds of each stage of a run, on standard error."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"stage {name}: {now - self.t:.2f} s", file=sys.stderr, flush=True)
        self.t = now


def _merged_args(reqs: List[dict]) -> dict:
    base = {k: v for k, v in reqs[0].items() if k not in ("prompt", "negative_prompt", "seed")}
    return dict(base, prompt=[r["prompt"] for r in reqs],
                negative_prompt=[r.get("negative_prompt") or "" for r in reqs],
                seed=[r["seed"] for r in reqs])


def _batch_sizes(max_batch: int) -> List[int]:
    """The merged batch sizes the batcher forms: powers of two up to it."""
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return out


def run(ctx) -> dict:
    """One run of a serving cell; returns the harness's result fields."""
    mix, spec, device, seed = ctx.mix, ctx.spec, ctx.device, ctx.seed
    on_device = device.type == "cuda"
    requests = traffic.serve_requests(mix, seed)
    stage = _Stages(ctx.t_process)
    stage("process start to the driver")
    model = program.build_model(spec, weights.make_weights(spec, seed, device), device)
    stage("weights and model")
    if ctx.control and ctx.control not in check.REFERENCE_CONTROLS:
        model.quantize(ctx.control)  # the program's own int8 path as the control
    handler, batcher = program.serving(model, mix["max_batch"], mix["window_ms"], mix["adaptive"])
    warm = traffic.serve_requests(dict(mix, clients=1, requests_per_client=mix["max_batch"]), seed + 1)[0]
    for b in _batch_sizes(mix["max_batch"]):
        out = handler._generate(dict(_merged_args(warm[:b]), num_inference_steps=mix["warm_steps"]),
                                output_type="uint8_device")
        check.jpeg_roundtrip(out.images[0].cpu().numpy())
    stage("warm-up")
    if on_device:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = _Tracer(handler, batcher, *mix["trace_calls"], on_device) if ctx.trace else None
    calls0 = batcher.merged_calls
    setup_s = time.perf_counter() - ctx.t_process

    log: List[dict] = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    stop_at = t0 + ctx.seconds

    exhausted = []

    def client(c: int) -> None:
        for req in requests[c]:
            if time.perf_counter() >= stop_at:
                return
            ts = time.perf_counter()
            reply = batcher.submit(dict(req), request_id=f"{c}")
            te = time.perf_counter()
            with lock:
                log.append({"request": req, "reply": reply, "t_submit": ts, "t_done": te,
                            "ok": "images" in reply})
        exhausted.append(c)

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(mix["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, stop_at + ctx.drain_s - time.perf_counter()))
    late = sum(t.is_alive() for t in threads)  # requests that never came back
    if exhausted:
        raise RuntimeError(f"clients {exhausted} ran out of requests: raise requests_per_client")
    t_last = max((r["t_done"] for r in log), default=t0)
    calls = batcher.merged_calls - calls0
    peak = torch.cuda.max_memory_allocated() if on_device else 0
    traced = tracer.finish() if tracer else None
    traced_calls = tracer.traced if tracer else []
    samples = check.sample(log, mix["check_samples"], seed)

    batcher.close()
    del handler, batcher, model, tracer
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()

    done = [r for r in log if r["ok"]]
    result = {
        "attempted": len(log) + late, "failed": len(log) - len(done) + late,
        "setup_s": setup_s, "window": (t0, t_last), "log": log, "merged_calls": calls,
        "memory_peak_bytes": peak, "trace": traced, "traced_calls": traced_calls,
        "images": len(done),
    }
    stage("window and drain")
    # nothing came back: every compared number fails
    with check.tf32_off():
        result["checks"] = check.served_images(samples, spec, seed, device, ctx.control) if samples else {}
    result["compared"] = len(samples)
    stage("reference")
    return result
