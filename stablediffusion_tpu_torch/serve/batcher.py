"""Dynamic request micro-batching for the HTTP worker.

The port's copy of ``stablediffusion_tpu/serve/batcher.py``.  Concurrent
txt2img requests whose shared arguments match (same height/width/steps/
guidance/clip_skip: the "bucket") are merged into ONE pipeline call: prompts
and negatives concatenate into batch lists, and every request keeps its own
noise streams through the pipeline's per-sample seed lists, so a request's
draws do not depend on the batch it lands in.  The merged call returns its
uint8 images on the card ("uint8_device"); a postprocess thread copies them
to the host and encodes the JPEGs while the next group runs.

Requests that can't batch (other modes, model blocks, image/mask/control
inputs, seed lists, num_images_per_prompt > 1) fall through to the serial
handler path unchanged.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

# args that force the serial path (graph-changing inputs or non-txt2img).
# prompt_weighting is here because the A1111 chunk count is computed over
# the WHOLE encoded batch (longest prompt wins) — merging would make a
# request's KV length depend on its batch-mates, breaking the
# composition-invariance contract; it is gated on truthiness, not presence.
_NON_BATCHABLE = (
    "image",
    "mask_image",
    "masked_image_latents",
    "control_image",
    "ip_adapter_image",
    "ip_adapter_image_embeds",
    "latents",
    "prompt_embeds",
    "model",
    "params",
    "prompt_weighting",
)
# args the merged call composes per-request instead of sharing
_MERGED_KEYS = ("prompt", "negative_prompt", "seed")

_BUCKET_KEYS_CACHE = None


def _bucket_keys():
    """Every member of a batch must share these (the bucket key).  DERIVED
    from the handler's INFERENCE_ARG_KEYS so a newly added pipeline arg is
    automatically a bucket key (splitting batches — the safe default) rather
    than silently applying request #1's value to the whole merged group.
    test_serve asserts the three-way partition stays total."""
    global _BUCKET_KEYS_CACHE
    if _BUCKET_KEYS_CACHE is None:
        from stablediffusion_tpu_torch.serve.handler import INFERENCE_ARG_KEYS

        _BUCKET_KEYS_CACHE = tuple(
            k
            for k in INFERENCE_ARG_KEYS
            if k not in _MERGED_KEYS and k not in _NON_BATCHABLE
        )
    return _BUCKET_KEYS_CACHE


def _to_host(images) -> np.ndarray:
    """A pipeline's images as a host array: a tensor on the card is
    copied (which waits for the work that produced it)."""
    if isinstance(images, torch.Tensor):
        return images.cpu().numpy()
    return np.asarray(images)


class _Pending:
    __slots__ = (
        "args",
        "request_id",
        "event",
        "result",
        "t0",
        "generation",
        "abandoned",
    )

    def __init__(self, args, request_id, generation=0):
        self.args = args
        self.request_id = request_id
        self.event = threading.Event()
        self.result: Optional[Dict] = None
        self.t0 = time.time()
        # handler.model_generation snapshot at enqueue; a mismatch at run
        # time means the model was reconfigured while we queued
        self.generation = generation
        # set when submit()'s wait times out: the worker must not burn card
        # time generating an image nobody will read
        self.abandoned = False


def _batchable(request_input: Dict[str, Any]) -> bool:
    if request_input.get("mode", "inference") != "inference":
        return False
    if any(
        k in request_input for k in _NON_BATCHABLE if k != "prompt_weighting"
    ):
        return False
    if request_input.get("prompt_weighting"):
        return False  # chunk count would depend on batch-mates (see above)
    if not isinstance(request_input.get("prompt"), str):
        return False
    if request_input.get("num_images_per_prompt", 1) != 1:
        return False
    seed = request_input.get("seed")
    if seed is not None and not isinstance(seed, int):
        return False
    neg = request_input.get("negative_prompt")
    if neg is not None and not isinstance(neg, str):
        return False
    return True


def _freeze(v):
    """Hashable view of any JSON value (lists/dicts recursively frozen)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def _bucket(request_input: Dict[str, Any]):
    return tuple(_freeze(request_input.get(k)) for k in _bucket_keys())


class Batcher:
    """Blocking submit() front-end over a single batching worker thread.

    The worker drains the queue, groups compatible requests arrived within
    `window_ms` of the first (up to `max_batch`), and runs each group as one
    merged Handler call.

    `adaptive=True` (default): the window is an upper bound, not a tax — the
    worker stops waiting as soon as no other submit is in flight, so a single
    interactive client pays ~0 ms of merge latency while concurrent clients
    still coalesce (they queue up behind the in-progress merged call).
    `adaptive=False` restores the fixed window (deterministic merge
    composition; used by composition-exactness tests)."""

    def __init__(
        self,
        handler,
        max_batch: int = 8,
        window_ms: float = 25.0,
        max_queue: int = 64,
        timeout_s: float = 1800.0,
        adaptive: bool = True,
        grace_ms: float = 5.0,
    ):
        self.handler = handler
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.grace_ms = grace_ms
        # bound on how long a PARTIAL gather may stay open waiting for an
        # in-flight postprocess release burst (see _loop); generous vs the
        # sub-second encode+turnaround it bridges, small vs the seconds-long
        # device batch a cohesive merge saves
        self.max_gather_s = 2.0
        # after a release, its clients still need one host turnaround (HTTP
        # response write + next POST) before resubmits hit the queue — the
        # gather treats this window like an in-flight burst
        self.release_grace_ms = 75.0
        self.max_queue = max_queue  # overload shedding threshold
        self.timeout_s = timeout_s
        self.adaptive = adaptive
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._lock = threading.Lock()  # model-slot single-writer
        # live waiter count for shedding — Queue.qsize() is approximate and
        # keeps counting abandoned (timed-out) items until the worker drains
        # them, so a stall would shed new requests on ghost entries
        self._pending = 0
        self._pending_lock = threading.Lock()
        # batches currently between device dispatch and response release:
        # while > 0 a release burst is imminent and partial gathers wait
        # for it (burst cohesion, see _loop)
        self._post_inflight = 0
        self._last_release = float("-inf")
        # hysteresis for the adaptive window: if the PREVIOUS gather had >1
        # requests we are under concurrent load, so the next gather keeps the
        # full window even when submits momentarily race (all N clients of a
        # just-completed batch re-submit within a few ms of each other; the
        # first one must not be dispatched alone)
        self._last_gather = 1
        self.merged_calls = 0  # observability; test hook
        self.shed_requests = 0  # observability; overload-shed counter
        self.padded_samples = 0  # observability; pow2 shape-padding counter
        # postprocess stage: device->host fetch + JPEG/b64 (or upload) runs
        # on this single worker so the batching loop can dispatch batch N+1
        # to the device while batch N still computes/encodes, keeping that
        # host work off the device's critical path.  One worker keeps
        # FIFO response order; depth is naturally bounded by max_queue.
        from concurrent.futures import ThreadPoolExecutor

        self._post = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="batcher-post"
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, request_input: Dict[str, Any], request_id: str = "") -> Dict:
        # all three families support per-sample seed lists (the invariance
        # mechanism); anything else (no model yet, unknown type) stays serial
        if (
            not _batchable(request_input)
            or getattr(self.handler.model, "model_type", None)
            not in ("sd15", "sdxl", "sd3")
        ):
            with self._lock:
                return self.handler(request_input, request_id)
        # overload shedding: beyond max_queue pending requests the client is
        # better served by an immediate 503-style error than a multi-minute
        # queue wait (each merged call is seconds of card time)
        with self._pending_lock:
            if self._pending >= self.max_queue:
                self.shed_requests += 1
                return {
                    "error": "OverloadedError: request queue full, retry later"
                }
            self._pending += 1
        item = _Pending(
            dict(request_input),
            request_id,
            generation=getattr(self.handler, "model_generation", 0),
        )
        self._q.put(item)
        try:
            if not item.event.wait(timeout=self.timeout_s):
                # mark abandoned so the worker drops it from future groups
                # instead of generating an image nobody reads; if generation
                # already started the result is simply discarded
                item.abandoned = True
                return {"error": "TimeoutError: batched request timed out"}
            return item.result
        finally:
            with self._pending_lock:
                self._pending -= 1

    def close(self):
        """Stop the worker thread (used by tests; servers run forever)."""
        self._q.put(None)
        self._thread.join(timeout=10.0)
        self._post.shutdown(wait=True)

    # -- worker side --------------------------------------------------------
    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            now = time.monotonic()
            t_first = now
            deadline = now + self.window_ms / 1e3
            # hysteresis: under concurrent load (previous gather >1) the
            # early break is disabled for the whole window — when a merged
            # batch completes, its N clients re-submit within milliseconds
            # of each other, and an eager break would dispatch the first
            # racer alone (then the other N-1 as a second partial batch).
            # From an IDLE state the hysteresis hasn't kicked in yet, so a
            # fresh concurrent burst would hit the same race on its very
            # first batch — a few-ms grace floor lets near-simultaneous racers register
            # their submits, at a negligible latency cost (grace_ms of a
            # multi-hundred-ms generation) to a truly lone client.
            if self._last_gather > 1:
                grace_until = deadline
            else:
                grace_until = now + min(self.window_ms, self.grace_ms) / 1e3
            while len(batch) < self.max_batch:
                now2 = time.monotonic()
                # burst cohesion: with postprocess off the worker thread,
                # the worker is free to gather WHILE a finished batch's
                # responses are still being encoded and released — its
                # clients then resubmit staggered by host turnaround, and a
                # fixed window would catch only the first few.
                # While any release burst is in flight, hold a PARTIAL
                # gather's window open (bounded by max_gather_s) so the
                # whole burst coalesces; full batches exit by size and are
                # never delayed.
                post_busy = False
                if self.adaptive:
                    with self._pending_lock:
                        post_busy = self._post_inflight > 0
                    # released clients need a host turnaround (HTTP write +
                    # next POST) before their resubmits are visible — bridge
                    # that gap too, not just the encode span
                    if not post_busy and (
                        now2 - self._last_release
                    ) * 1e3 < self.release_grace_ms:
                        post_busy = True
                    if post_busy:
                        deadline = min(
                            max(deadline, now2 + self.window_ms / 1e3),
                            t_first + self.max_gather_s,
                        )
                remaining = deadline - now2
                if remaining <= 0:
                    break
                # adaptive window: only keep waiting while other submits are
                # actually in flight (self._pending counts increment-before-
                # put, decrement-after-completion).  A single interactive
                # client never pays more than the grace floor; concurrent
                # clients still coalesce.  Short poll, not a full-window
                # block: an in-flight submit lands within microseconds of
                # the count.
                if self.adaptive:
                    grace_left = grace_until - now2
                    if grace_left <= 0:
                        with self._pending_lock:
                            in_flight = self._pending
                        # post_busy suppresses the quiet break: the burst's
                        # clients are mid-turnaround, not absent
                        if (not post_busy and in_flight <= len(batch)
                                and self._q.empty()):
                            break
                        remaining = min(remaining, 0.002)
                    else:
                        # during the grace period block only until it
                        # expires so the quiet-check runs promptly after
                        remaining = min(remaining, grace_left)
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    continue
                if nxt is None:  # close() during gather: finish then exit
                    self._q.put(None)
                    break
                batch.append(nxt)
                # concurrency detected mid-gather: commit to the full window
                # so the rest of the burst coalesces into this batch instead
                # of an early quiet-check splitting it
                grace_until = deadline
            self._last_gather = len(batch)
            # group by bucket; each group is one merged call.  Nothing here
            # may kill the singleton worker thread — a dead loop would hang
            # every pending and future batchable request.
            try:
                groups: Dict[Any, list] = {}
                for item in batch:
                    groups.setdefault(_bucket(item.args), []).append(item)
                for group in groups.values():
                    self._run_group(group)
            except Exception as e:  # pragma: no cover — belt and braces
                logger.exception("batch loop error: %s", e)
                for item in batch:
                    if not item.event.is_set():
                        item.result = {"error": f"{type(e).__name__}: {e}"}
                        item.event.set()

    def _run_group(self, group):
        from stablediffusion_tpu_torch.serve.handler import INFERENCE_ARG_KEYS

        group = [it for it in group if not it.abandoned]
        if not group:
            return
        try:
            # mirror Handler.__call__'s arg filtering exactly: the batched
            # path must honor the same keys the serial path does, no more
            merged = {
                k: v
                for k, v in group[0].args.items()
                if k in INFERENCE_ARG_KEYS
            }
            with self._lock:
                # revalidate model identity under the lock: a concurrent
                # serial request carrying a model block may have swapped
                # checkpoints / LoRA / scheduler state between enqueue and
                # now — those items re-run through the full serial handler
                # (fresh validation against the CURRENT model)
                cur_gen = getattr(self.handler, "model_generation", 0)
                # re-check abandonment HERE, under the lock: items can time
                # out while the worker waited for the model slot, and each
                # one kept in the merged list burns a whole generation
                group = [it for it in group if not it.abandoned]
                stale = [it for it in group if it.generation != cur_gen]
                group = [it for it in group if it.generation == cur_gen]
                for it in stale:
                    if it.abandoned:
                        continue
                    try:
                        it.result = self.handler(it.args, it.request_id)
                    except Exception as e:  # handler catches; belt+braces
                        it.result = {"error": f"{type(e).__name__}: {e}"}
                    it.event.set()
                if not group:
                    return
                merged["prompt"] = [it.args["prompt"] for it in group]
                merged["negative_prompt"] = [
                    it.args.get("negative_prompt") or "" for it in group
                ]
                # ALWAYS a seed list (even batch of 1): the per-sample
                # stream depends only on the request's own seed, making
                # results independent of batch composition
                merged["seed"] = [
                    it.args["seed"]
                    if it.args.get("seed") is not None
                    else int(np.random.randint(0, int(1e9)))
                    for it in group
                ]
                # pad to the next power of two (<= max_batch) by repeating
                # the last request, so that merged calls take a few batch
                # shapes only (the JAX package's compiled programs; here the
                # kernels' and cuDNN's per-shape choices).  Per-sample seed
                # streams make the duplicates inert for real outputs; the
                # pads are sliced off below.
                n_real = len(group)
                n_padded = 1
                while n_padded < n_real:
                    n_padded *= 2
                for k in ("prompt", "negative_prompt", "seed"):
                    merged[k] = merged[k] + [merged[k][-1]] * (
                        n_padded - n_real
                    )
                self.padded_samples += n_padded - n_real
                self.merged_calls += 1
                # "uint8_device": the pipeline returns the uint8 images on
                # the card without copying them to the host, so the lock is
                # released and the NEXT batch can be dispatched while the
                # postprocess thread waits for this one's copy.
                out = self.handler._generate(merged, output_type="uint8_device")
            # fetch + encode + respond happen on the postprocess worker,
            # off the device critical path.  Only MULTI-request groups mark
            # the release-burst state: a lone client's own completed
            # request must not make its next gather wait out the bridge
            # (that would tax every interactive request ~release_grace_ms)
            is_burst = len(group) > 1
            if is_burst:
                with self._pending_lock:
                    self._post_inflight += 1
            try:
                self._post.submit(self._postprocess, group, out, is_burst)
            except RuntimeError:
                # executor already shut down (close() racing a last group):
                # don't leak the burst marker; the outer except routes the
                # group to its error channel
                if is_burst:
                    with self._pending_lock:
                        self._post_inflight -= 1
                raise
        except Exception as e:  # error channel per request
            logger.error("batched group failed: %s", e)
            tb = traceback.format_exc()
            for it in group:
                if not it.event.is_set():
                    it.result = {
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": tb,
                    }
                    it.event.set()

    def _postprocess(self, group, out, is_burst=True):
        """Device->host fetch, per-request JPEG/b64 (or upload), respond.
        Runs on the single `_post` worker; a device-side runtime error
        (e.g. out of memory) surfaces at the fetch and
        is routed to each request's error channel.

        All results are encoded FIRST and released TOGETHER: per-item
        release would stagger the clients' resubmits across the whole
        encode span and shred the next gather's batch composition (burst
        cohesion, see _loop)."""
        try:
            images = _to_host(out.images)  # waits for the card
            for i, it in enumerate(group):
                if self.handler.uploader is not None:
                    imgs = self.handler.uploader.upload(
                        images[i : i + 1], it.request_id
                    )
                else:
                    from stablediffusion_tpu_torch.serve.handler import (
                        encode_images_b64,
                    )

                    imgs = encode_images_b64(images[i : i + 1])
                it.result = {
                    "images": imgs,
                    "seed": out.seed[i],
                    "batched": len(group),
                    "time_sec": round(time.time() - it.t0, 3),
                }
        except Exception as e:
            logger.error("batched postprocess failed: %s", e)
            tb = traceback.format_exc()
            for it in group:
                if it.result is None:
                    it.result = {
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": tb,
                    }
        finally:
            # grouped release, and only THEN drop the inflight marker so a
            # gathering worker keeps its window open until the whole burst
            # of resubmits is on its way
            for it in group:
                if not it.event.is_set():
                    it.event.set()
            if is_burst:
                with self._pending_lock:
                    self._post_inflight -= 1
                    self._last_release = time.monotonic()
