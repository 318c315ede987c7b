"""Serving request router (the runpod-worker handler).

Port of ``stablediffusion_tpu/serve/handler.py:103-530``:
  * request schema {id, input: {mode?, model?, params?, prompt...}};
  * the "inference", "constructor" and "train" modes (the second a grid
    over schedulers x lora_scales x steps_grid x guidance_grid, which
    restores the adapters' own scales after; the third trains a LoRA on the
    loaded model through ``train/trainer.SDLoRATrainer``);
  * an optional model block {type, name, scheduler, prediction_type, loras,
    textual_inversion, ip_adapter, quantize}:
    - ``name`` hot-reloads the model from the diffusers folder
      ``{type}_{name}`` under the model dir (type "sd15", "sdxl" or "sd3";
      with no type and no model loaded, "sdxl", as in JAX), or from the
      A1111 single file it names, with the tokenizers of a ``tokenizer/``
      folder beside it or in the model dir (SD3 single files are refused,
      as in JAX);
    - ``loras`` ({name: scale} or names) fuses
      ``{lora_dir}/{type}_{name}.safetensors`` (the lora dir defaults to
      the model dir; an SD3 model's go on its MM-DiT and CLIP towers); an
      empty value clears them;
    - ``textual_inversion`` is declarative: the list is the state (.pt
      files load with ``weights_only=True`` only);
    - ``ip_adapter`` names an IP-Adapter file (a path, or one under the
      model dir) that ``load_ip_adapter`` loads without an image encoder, as
      JAX's handler does (``handler.py:225-242``); a falsy value unloads it;
      an SD3 model refuses a file;
    - ``quantize`` ("auto" | "w8" | "w8a8" | "w8a8:N" | null) is
      declarative too: "auto" resolves against ``expected_batch`` (the
      worker sets it to its batcher's max_batch), and a request that names
      the model's mode again does not quantize again;
  * SDXL requests take ``prompt_2`` / ``negative_prompt_2``, and
    ``use_refiner`` through ``params`` (without a loaded refiner it answers
    on the error channel, as the JAX pipeline raises);
  * an SD3 model's requests go to ``pipelines/sd3.StableDiffusion3Pipeline``
    (``prompt_3``, ``negative_prompt_3``, ``max_sequence_length``); the keys
    its ``__call__`` does not take are dropped with a warning
    (``handler.py:352-368``), so an SDXL payload still serves;
  * `params` merge into the top-level arguments; a seed is drawn when absent
    and echoed; ``image``, ``mask_image``, ``control_image`` and
    ``ip_adapter_image`` given as base64 strings are decoded;
  * images come back as base64 JPEG, or as URLs through an upload sink;
  * every failure answers on the error channel ({"error", "traceback"}).

The "inference_wandb" mode (``handler.py:422-470``) renders as
"inference" and logs the run's config and images to wandb when it imports;
without it (neither machine this port runs on has it) the answer carries
the config inline, as JAX's does.  The "train" mode trains SD1.5 and SDXL
models, as the JAX handler's does: an SD3 model is refused, with a pointer
to ``train/sd3_train.SD3LoRATrainer``.

A serving mesh (``parallel/mesh.py``, one process per GPU under torchrun):
rank 0 owns HTTP and the batcher, and sends each request (with its seed
drawn) and each merged call to every rank, which :meth:`Handler.follow`
runs on the other ranks.  A call whose rows are per-sample (prompt and seed
lists of one length, as the batcher's merged calls are) and divide by
``data`` is split: each data group renders its rows (``parallel.mesh.rows``)
and rank 0 gathers them in order; any other call stays whole on every rank,
as JAX leaves such a batch replicated.  With ``tensor`` > 1 the denoiser's
projections split over it (``parallel/tp.py``), marked again at each call,
so that the model's state after any adapter, int8 or reload change is what
splits.  Each pipeline call is one "generate" span
(``utils/observability.trace``).  An SD3 model has no
``load_ip_adapter`` or ``load_textual_inversion``, so those keys answer "not
supported", as they do in JAX.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import inspect
import io
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from stablediffusion_tpu_torch.core.config import resolve_device
from stablediffusion_tpu_torch.io.loader import (
    load_sd3_model,
    load_sd_model,
    load_sd_single_file,
    resolve_checkpoint,
)
from stablediffusion_tpu_torch.models.wrapper import SDModel
from stablediffusion_tpu_torch.ops.quant import resolve_quant_mode
from stablediffusion_tpu_torch.pipelines.sd3 import SD3Model, StableDiffusion3Pipeline
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
from stablediffusion_tpu_torch.utils.observability import trace

logger = logging.getLogger(__name__)

INFERENCE_ARG_KEYS = (
    "prompt",
    "prompt_2",
    "negative_prompt",
    "negative_prompt_2",
    "height",
    "width",
    "num_images_per_prompt",
    "num_inference_steps",
    "denoising_start",
    "denoising_end",
    "guidance_scale",
    "guidance_rescale",
    "clip_skip",
    "prompt_weighting",
    "seed",
    "image",
    "strength",
    "image_guidance_scale",
    "mask_image",
    "masked_image_latents",
    "padding_mask_crop",
    "cache_interval",
    "vae_tiling",
    "freeu",
    "pag_scale",
    "pag_applied_layers",
    "hires_scale",
    "hires_strength",
    "hires_steps",
    "timesteps",
    "sigmas",
    "control_image",
    "controlnet_conditioning_scale",
    "cross_attention_kwargs",
    "ip_adapter_image",
    "ip_adapter_scale",
    # SD3-family extras
    "prompt_3",
    "negative_prompt_3",
    "max_sequence_length",
)


def encode_images_b64(images01: np.ndarray, fmt: str = "JPEG") -> list:
    """[B, H, W, 3] in [0, 1] float or uint8 -> base64 strings."""
    from PIL import Image

    from stablediffusion_tpu_torch.utils.images import as_uint8

    out = []
    for im in as_uint8(images01):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format=fmt, quality=95)
        out.append(base64.b64encode(buf.getvalue()).decode("ascii"))
    return out


def decode_image_b64(data: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
    return np.asarray(im, np.float32) / 255.0


class Handler:
    """Request router bound to one model slot, on one device: the model's,
    or ``cuda`` unless `device` says otherwise (raises without a card)."""

    def __init__(
        self,
        model: Union[SDModel, SD3Model, None] = None,
        model_dir: Optional[str] = None,
        lora_dir: Optional[str] = None,
        uploader=None,
        mesh=None,
        device: Union[str, torch.device, None] = None,
    ):
        from stablediffusion_tpu_torch.serve.upload import make_uploader

        self.mesh = mesh
        # this rank's part in a mesh over more than one process: the
        # "leader" (rank 0) sends each call to the "follower" ranks
        self.role = None
        if mesh is not None:
            import torch.distributed as dist

            if dist.is_initialized() and dist.get_world_size() > 1:
                self.role = "leader" if mesh.rank == 0 else "follower"
        self._in_step = False  # inside a span every rank runs (see lockstep)
        self.device = model.device if model is not None and device is None \
            else resolve_device(device)
        if mesh is not None and self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        self.model_dir = model_dir
        self.lora_dir = lora_dir or model_dir
        # bumped on every request that may change the model's state; the
        # Batcher snapshots it at enqueue and re-runs requests queued under
        # another state serially (see serve/batcher.py)
        self.model_generation = 0
        # BUCKET_ENDPOINT_URL-gated image sink: URLs in place of base64
        self.uploader = uploader if uploader is not None else make_uploader()
        # the merge batch that quantize="auto" resolves against: the
        # worker sets its batcher's max_batch; alone, the batch-1 mode
        self.expected_batch = 1

    # -- model hot-swap --------------------------------------------------------
    def maybe_reload_model(self, model_cfg: Dict[str, Any]) -> None:
        mtype = model_cfg.get("type", getattr(self.model, "model_type", "sdxl"))
        name = model_cfg.get("name")
        if name is not None:
            path = resolve_checkpoint(mtype, name, cache_dir=self.model_dir)
            if self.model is None or self.model.path not in (path, os.path.abspath(path)):
                logger.info("loading model %s (%s)", name, path)
                if mtype == "sd3":  # a folder; load_sd3_model refuses single files
                    self.model = load_sd3_model(path, device=self.device)
                elif os.path.isfile(path):  # an A1111 single file
                    tok_dir = next((d for d in (os.path.dirname(path), self.model_dir)
                                    if d and os.path.isdir(os.path.join(d, "tokenizer"))),
                                   None)
                    self.model = load_sd_single_file(
                        path, tokenizer_dir=tok_dir, device=self.device,
                        prediction_type=model_cfg.get("prediction_type"))
                else:
                    self.model = load_sd_model(path, model_type=mtype, device=self.device)
        if self.model is None:
            raise ValueError("no model loaded and no model.name provided")
        if model_cfg.get("prediction_type"):
            # applies even when the checkpoint was already loaded
            if self.model.scheduler_config.prediction_type != model_cfg["prediction_type"]:
                self.model.scheduler_config = dataclasses.replace(
                    self.model.scheduler_config,
                    prediction_type=model_cfg["prediction_type"],
                )
                self.model._scheduler = None  # rebuilt from the new config
        if "loras" in model_cfg:
            if model_cfg["loras"]:
                self.model.load_loras(model_cfg["loras"], lora_dir=self.lora_dir)
            else:
                self.model.delete_adapters()
        if "scheduler" in model_cfg:
            self.model.set_scheduler(model_cfg["scheduler"])
        if "textual_inversion" in model_cfg:
            # declarative: the list is the wanted state.  Requests name files
            # on disk, so .pt embeddings load with weights_only=True only
            tis = model_cfg["textual_inversion"] or []
            if not hasattr(self.model, "load_textual_inversion"):  # SD3
                if tis:  # clearing is a no-op
                    raise ValueError(f"textual_inversion is not supported for model type "
                                     f"{self.model.model_type!r}")
            else:
                self.model.unload_textual_inversion()
            for ti in tis:
                src = ti["path"] if isinstance(ti, dict) else str(ti)
                if not os.path.exists(src) and self.model_dir:
                    src = os.path.join(self.model_dir, src)
                self.model.load_textual_inversion(
                    src, token=ti.get("token") if isinstance(ti, dict) else None)
        if "ip_adapter" in model_cfg:
            ip = model_cfg["ip_adapter"]
            if not hasattr(self.model, "load_ip_adapter"):  # SD3; clearing is a no-op
                if ip:
                    raise ValueError(f"ip_adapter is not supported for model type "
                                     f"{self.model.model_type!r}")
            elif ip:
                path = ip if os.path.exists(str(ip)) else os.path.join(self.model_dir or ".",
                                                                         str(ip))
                self.model.load_ip_adapter(path)
            else:
                self.model.unload_ip_adapter()
        if "quantize" in model_cfg:
            # resolved here, so that a client sending "auto" with every
            # request compares concrete modes and quantizes once
            q = resolve_quant_mode(model_cfg["quantize"] or None, self.expected_batch)
            if q != self.model.quant_mode:
                self.model.quantize(q)  # validates before it changes state

    # -- the serving mesh -----------------------------------------------------
    def _sends(self) -> bool:
        """Whether a call made now must first go to the followers: on the
        leader, outside a span that every rank runs already."""
        return self.role == "leader" and not self._in_step

    @staticmethod
    def _send(msg) -> Any:
        import torch.distributed as dist

        box = [msg]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    @contextlib.contextmanager
    def lockstep(self, msg=None):
        """A span that every rank of the mesh runs at once, such as the
        worker's set-up: nothing called inside it is sent again.  Given a
        message (a call the followers run), the leader sends it first."""
        if msg is not None and self._sends():
            self._send(msg)
        outer, self._in_step = self._in_step, True
        try:
            yield
        finally:
            self._in_step = outer

    def follow(self) -> None:
        """A follower's loop: run each request and call the leader sends,
        until :meth:`stop_followers`."""
        while True:
            kind, payload = self._send(None)
            if kind == "stop":
                return
            with self.lockstep():
                try:
                    if kind == "call":
                        self(*payload)
                    else:
                        self._generate(*payload)
                except Exception as e:  # the leader answers on the error channel
                    logger.error("follower call failed: %s", e)

    def stop_followers(self) -> None:
        if self._sends():
            self._send(("stop", None))

    def _split_rows(self, args: Dict[str, Any]):
        """(this rank's args, rows) when the call's rows are per-sample and
        divide over ``data``; else None (the call stays whole)."""
        from stablediffusion_tpu_torch.parallel.mesh import rows

        mesh = self.mesh
        if mesh is None or mesh.shape["data"] == 1:
            return None
        seed, prompt = args.get("seed"), args.get("prompt")
        if not (isinstance(seed, list) and isinstance(prompt, list)
                and len(seed) == len(prompt) and (args.get("num_images_per_prompt") or 1) == 1):
            return None
        B = len(seed)
        per_row = ("prompt", "negative_prompt", "seed", "prompt_2", "negative_prompt_2",
                   "prompt_3", "negative_prompt_3")
        for k, v in args.items():
            if (k not in per_row and isinstance(v, (list, np.ndarray, torch.Tensor))
                    and len(v) == B):
                return None  # another input with a row each: stays whole
        sl = rows(mesh, B)
        if sl == slice(None):
            return None
        local = dict(args)
        for k in per_row:
            if isinstance(local.get(k), list) and len(local[k]) == B:
                local[k] = local[k][sl]
        return local, B

    def _gather_rows(self, out, B: int):
        """Rank 0's whole output from every data group's rows."""
        mesh = self.mesh
        images = out.images.cpu().numpy() if isinstance(out.images, torch.Tensor) \
            else np.asarray(out.images)
        parts = mesh.all_gather_object((images, list(out.seed)), "data")
        n = mesh.shape["data"]
        whole = np.empty((B, *images.shape[1:]), images.dtype)
        seeds = [None] * B
        for d, (im, sd) in enumerate(parts):
            whole[d::n] = im
            seeds[d::n] = sd
        return dataclasses.replace(out, images=whole, seed=seeds)

    # -- entry ----------------------------------------------------------------
    def __call__(self, request_input: Dict[str, Any], request_id: str = "") -> Dict:
        t0 = time.time()
        if self._sends():
            # the seed is drawn here, so that every rank renders with it
            params = request_input.get("params") or {}
            if request_input.get("seed") is None and params.get("seed") is None:
                request_input = dict(request_input, seed=int(np.random.randint(0, int(1e9))))
        with self.lockstep(("call", (request_input, request_id))):
            return self._call(request_input, request_id, t0)

    def _call(self, request_input: Dict[str, Any], request_id: str, t0: float) -> Dict:
        try:
            mode = request_input.get("mode", "inference")
            if "model" in request_input and request_input["model"]:
                self.maybe_reload_model(request_input["model"])
                self.model_generation += 1
            if mode in ("constructor", "train"):  # scales, adapters or weights move
                self.model_generation += 1
            if self.model is None:
                raise ValueError("no model loaded")

            args = dict(request_input.get("params") or {})
            for k in INFERENCE_ARG_KEYS:
                if k in request_input:
                    args[k] = request_input[k]
            if args.get("seed") is None:
                args["seed"] = int(np.random.randint(0, int(1e9)))

            if mode == "inference":
                return self.inference_mode(args, t0, request_id=request_id)
            if mode == "constructor":
                return self.constructor_mode(args, t0)
            if mode == "train":
                return self.train_mode(request_input)
            if mode == "inference_wandb":
                return self.inference_wandb_mode(args, t0)
            raise ValueError(f"unknown mode {mode!r}")
        except Exception as e:  # the error channel
            logger.error("request %s failed: %s", request_id, e)
            return {
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(),
            }

    # -- modes ----------------------------------------------------------------
    def _generate(self, args: Dict[str, Any], output_type: str = "uint8"):
        """One pipeline call.  "uint8" quantizes on the card and copies; the
        batcher passes "uint8_device" to copy on its postprocess thread.
        Under a mesh, the call runs on every rank (see the module
        docstring)."""
        from stablediffusion_tpu_torch.parallel import tp

        with self.lockstep(("generate", (args, output_type))):
            split = self._split_rows(args)
            denoisers = [getattr(self.model, n, None)
                         for n in ("unet", "transformer", "refiner", "controlnet")]
            with trace("generate"), tp.parallel(denoisers, self.mesh):
                out = self._render(split[0] if split else args, output_type)
            return self._gather_rows(out, split[1]) if split else out

    def _render(self, args: Dict[str, Any], output_type: str):
        for key in ("image", "mask_image", "control_image", "ip_adapter_image"):
            if isinstance(args.get(key), str):
                args = dict(args, **{key: decode_image_b64(args[key])})
        if self.model.model_type == "sd3":
            # SD3's narrower argument surface: drop what its __call__ does not
            # take, with a warning, rather than fail a reused SDXL payload
            known = set(inspect.signature(StableDiffusion3Pipeline.__call__).parameters)
            dropped = sorted(k for k in args if k not in known)
            if dropped:
                logger.warning("sd3: ignoring unsupported args %s", dropped)
            args = {k: v for k, v in args.items() if k in known}
            pipe = StableDiffusion3Pipeline(do_cfg=True, output_type=output_type,
                                            device=self.device)
            return pipe(self.model, **args)
        pipe = StableDiffusionUnifiedPipeline(do_cfg=True, output_type=output_type,
                                              device=self.device)
        return pipe(self.model, **args)

    def warmup(self, steps: int = 25, size: Optional[int] = None, batches=(1,)) -> float:
        """One generation per batch size before serving, so the first
        requests do not pay for the kernels' build, the cuDNN algorithm
        search or the allocator's growth.  Returns seconds spent."""
        t0 = time.time()
        for k in batches:
            args: Dict[str, Any] = {
                "prompt": "warmup",
                "num_inference_steps": int(steps),
                "num_images_per_prompt": int(k),
                "seed": 0,
            }
            if size:
                args["height"] = args["width"] = int(size)
            self._generate(args)
        dt = time.time() - t0
        logger.info("warmup: batches %s, %d steps in %.1f s", tuple(batches), steps, dt)
        return dt

    def inference_mode(self, args: Dict[str, Any], t0: float, request_id: str = "") -> Dict:
        out = self._generate(args)
        if self.uploader is not None:
            images = self.uploader.upload(out.images, request_id)
        else:
            images = encode_images_b64(out.images)
        return {
            "images": images,
            "seed": out.seed,
            "time_sec": round(time.time() - t0, 3),
        }

    def inference_wandb_mode(self, args: Dict[str, Any], t0: float) -> Dict:
        """Generation and experiment logging (``handler.py:422-470``): the
        run's config and images go to a wandb run when wandb imports, with
        a per-image config table; without it the config comes back inline
        (the reference crashes there, JAX fixed it)."""
        out = self._generate(args)
        config = {
            "prompt": args.get("prompt"),
            "negative_prompt": args.get("negative_prompt"),
            "scheduler": self.model.scheduler_name,
            "steps": args.get("num_inference_steps", 50),
            "cfg": args.get("guidance_scale", 5.0),
            "clip_skip": args.get("clip_skip"),
            "seed": out.seed,
            "adapters": self.model.get_list_adapters(),
        }
        run_url = None
        try:
            import wandb
        except ImportError:
            logger.info("wandb unavailable; returning config inline")
        else:
            run = wandb.init(project="sdtpu-inference", config=config)
            columns = ["prompt", "negative_prompt", "scheduler", "steps", "cfg", "clip_skip",
                       "seed", "adapters", "image"]
            table = wandb.Table(columns=columns)
            for im in out.images:
                table.add_data(config["prompt"], config["negative_prompt"],
                               config["scheduler"], config["steps"], config["cfg"],
                               config["clip_skip"], config["seed"], str(config["adapters"]),
                               wandb.Image(im))
            run.log({"images": [wandb.Image(im) for im in out.images], "generations": table})
            run_url = run.get_url()
            run.finish()
        return {
            "images": encode_images_b64(out.images),
            "seed": out.seed,
            "config": config,
            "wandb_url": run_url,
            "time_sec": round(time.time() - t0, 3),
        }

    def constructor_mode(self, args: Dict[str, Any], t0: float) -> Dict:
        """A grid sweep (``handler.py:471-508``): every scheduler x LoRA
        scale (applied to every active adapter) x step count x guidance
        scale, one generation each; the adapters' own scales come back
        after."""
        schedulers = args.pop("schedulers", ["DPM++ 2M SDE Karras"])
        lora_scales = args.pop("lora_scales", [0.7])
        steps_grid = args.pop("steps_grid", [30])
        cfg_grid = args.pop("guidance_grid", [7])
        base_adapters = self.model.get_list_adapters()
        results = []
        for sched in schedulers:
            self.model.set_scheduler(sched)
            for scale in lora_scales:
                if base_adapters:
                    self.model.set_adapters({n: scale for n in base_adapters})
                for steps in steps_grid:
                    for cfg in cfg_grid:
                        out = self._generate(dict(args, num_inference_steps=int(steps),
                                                  guidance_scale=float(cfg)))
                        results.append({"scheduler": sched, "lora_scale": scale,
                                        "steps": steps, "guidance_scale": cfg,
                                        "seed": out.seed,
                                        "images": encode_images_b64(out.images)})
        if base_adapters:
            self.model.set_adapters(base_adapters)
        return {"grid": results, "time_sec": round(time.time() - t0, 3)}

    def train_mode(self, request_input: Dict[str, Any]) -> Dict:
        """In-process training (``handler.py:510-530``): the request's
        "train" block holds ``data_dir`` and any ``SDTrainingArgs`` fields;
        the answer holds the logged (step, loss) pairs and the saved
        adapter's path, or, under ``full_finetune``, the saved folder's.
        Under textual inversion the JAX handler also answers a
        ``lora_path`` naming no file, and so does this one."""
        from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs

        if self.model.model_type == "sd3":
            # JAX hands any model to SDLoRATrainer, which cannot train an
            # MM-DiT; no route of the JAX handler trains SD3
            raise ValueError(
                "the train mode trains SD1.5/SDXL models (SDLoRATrainer), as the JAX "
                "handler's does; train an SD3 model with "
                "train/sd3_train.SD3LoRATrainer")
        cfg = dict(request_input.get("train") or {})
        data_dir = cfg.pop("data_dir", None)
        if not data_dir:
            raise ValueError("train mode requires train.data_dir")
        args = SDTrainingArgs(**cfg)
        trainer = SDLoRATrainer(self.model, args, data_dir, mesh=self.mesh)
        trainer.train()
        out: Dict[str, Any] = {"history": trainer.history}
        if args.full_finetune:
            out["model_path"] = args.output_dir
        else:
            out["lora_path"] = f"{args.output_dir}/pytorch_lora_weights.safetensors"
        return out


