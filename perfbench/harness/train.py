"""The training driver: the port's ``SDLoRATrainer.train()`` itself, on a
folder of seeded captioned JPEGs read through its own folder dataset.  A
feed around that dataset ends the run: its first batches are set-up (they
warm every shape, and the reference follows their steps), then it hands
out batches for `seconds`, data loading included, and stops."""

from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import check, program, trace, traffic, weights
from perfbench.harness.serve import _Stages
from perfbench.reference import shapes as shape_specs
from perfbench.reference import train as ref_train


def write_images(folder: Path, n: int, size: int, seed: int, mix: dict) -> None:
    """`n` seeded size x size JPEGs (quality 95: smooth colour fields with
    fine noise), with a caption file each."""
    from PIL import Image

    rng = np.random.default_rng([int(seed) % 2**63, 13])
    words = traffic.vocabulary(rng)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        small = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
        smooth = np.asarray(Image.fromarray(small).resize((size, size), Image.BICUBIC), np.float32)
        img = np.clip(smooth + rng.normal(0.0, 8.0, smooth.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(folder / f"img{i:04d}.jpg", quality=95)
        k = int(rng.integers(mix["min_words"], mix["max_words"] + 1))
        (folder / f"img{i:04d}.txt").write_text(" ".join(rng.choice(words, size=k)))


def flips_of(batch: dict, data_dir: Path) -> List[bool]:
    """Which rows of a collated batch the dataset flipped: each row against
    the benchmark's own decode of its file and that decode's mirror image.
    The flip is the dataset's draw; the reference takes only that bit."""
    rows = batch["pixel_values"]
    out = []
    for row, name in zip(rows, batch["filenames"]):
        own = ref_train.load_pixels([str(data_dir / name)], "cpu")[0].permute(1, 2, 0).numpy()
        out.append(bool(np.abs(row - own[:, ::-1]).mean() < np.abs(row - own).mean()))
    return out


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    rn = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med) for k in keep)


def compare(rec: dict, spec: dict, mix: dict, seed: int, device, data_dir: Path,
            control: bool = False) -> Dict[str, float]:
    """The reference's first steps on the rows the program took, against the
    program's (or, as the control, the reference in float8 in its place).
    Run it under ``check.tf32_off``."""
    comps, a = spec["components"], mix["trainer"]
    w = weights.make_weights(spec, seed, device, torch.float32)
    unet_shapes = shape_specs.unet(comps["unet"])

    def follow(quantize=None):
        gen = torch.Generator(device=device).manual_seed(rec["train_seed"])
        f = ref_train.flat(ref_train.init_lora(unet_shapes, a.get("rank", 16), gen))
        f0 = {k: v.clone() for k, v in f.items()}
        opt = ref_train.AdamW(a.get("learning_rate", 1e-4), a.get("lr_warmup_steps", 500))
        losses, g1 = [], None
        for files, flips in zip(rec["files"], rec["flips"]):
            paths = [str(data_dir / n) for n in files]
            caps = [(data_dir / n).with_suffix(".txt").read_text() for n in files]
            pixels = ref_train.load_pixels(paths, device, flips)
            loss, grads = ref_train.step_loss_and_grads(w, comps, f, pixels, caps, gen,
                                                        quantize=quantize)
            if g1 is None:
                g1 = opt.clipped(grads)
            opt.step(f, grads)
            losses.append(loss)
        return {"f0": f0, "losses": losses, "g1": g1, "delta": {k: f[k] - f0[k] for k in f}}

    ref = follow()
    prog = follow(ref_train.quantize_fp8) if control else {
        "f0": rec["f0"], "losses": rec["losses"], "g1": rec["g1"],
        "delta": {k: rec["f3"][k] - rec["f0"][k] for k in rec["f0"]}}
    # leaves whose first gradient is nought to rounding in the reference (a
    # fresh LoRA's down factors, behind up = 0) move by round-off alone
    gn = {k: float(v.norm()) for k, v in ref["g1"].items()}
    med = float(np.median(list(gn.values())))
    keep = [k for k, n in gn.items() if n >= 1e-3 * med]
    return {
        "init_gap": max(float((prog["f0"][k] - ref["f0"][k]).abs().max()) for k in ref["f0"]),
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": _leaf_gap(prog["g1"], ref["g1"], keep),
        "change_norm_gap": _leaf_gap(prog["delta"], ref["delta"], keep),
    }


def _step_times(marks) -> None:
    """The window's step times on the host's clock and the device's, on
    standard error (median, quartiles, extremes, in ms)."""
    if len(marks) < 5:
        return
    host = sorted(1e3 * (b[0] - a[0]) for a, b in zip(marks, marks[1:]))
    dev = sorted(a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:]))
    for name, xs in (("host", host), ("device", dev)):
        n = len(xs)
        print(f"step ms {name}: median {xs[n // 2]:.1f} quartiles {xs[n // 4]:.1f}-{xs[3 * n // 4]:.1f} "
              f"range {xs[0]:.1f}-{xs[-1]:.1f}", file=sys.stderr)


def run(ctx) -> dict:
    """One run of a training cell; returns the harness's result fields."""
    mix, seed = ctx.mix, ctx.seed
    stage = _Stages(ctx.t_process)
    stage("process start to the driver")
    data_dir = Path(tempfile.mkdtemp(prefix="perfbench-images-"))
    try:
        write_images(data_dir, mix["images"], mix["trainer"]["resolution"], seed, mix)
        stage("images")
        return _run(ctx, data_dir, stage)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


class Feed:
    """The folder dataset as ``train()`` reads it, ended at the window's end.
    Its first `checked` batches pass as set-up, their files and flips kept
    for the reference; asked for the next, it drains the device and opens
    the window; it then hands out batches until `seconds` have passed,
    drains the device again, and stops, which ends ``train()``'s loop."""

    def __init__(self, dataset, ctx, data_dir: Path):
        self.dataset, self.ctx, self.data_dir = dataset, ctx, data_dir
        self.on_device = ctx.device.type == "cuda"
        self.checked = ctx.mix["checked_steps"]
        self.files, self.flips, self.marks, self.traced = [], [], [], []
        self.prof, self.steps, self.setup_s, self.t0, self.t_end = None, 0, None, None, None

    def __len__(self) -> int:
        return len(self.dataset)

    def _sync(self) -> None:
        if self.on_device:
            torch.cuda.synchronize()

    def batches(self, batch_size: int, **kw):
        it = self.dataset.batches(batch_size, **kw)
        try:
            for _ in range(self.checked):
                batch = next(it)
                self.files.append(list(batch["filenames"]))
                self.flips.append(flips_of(batch, self.data_dir))
                yield batch
            self._sync()
            if self.on_device:
                torch.cuda.reset_peak_memory_stats()
            self.setup_s = time.perf_counter() - self.ctx.t_process
            first, count = self.ctx.mix["trace_steps"]
            tracing = self.ctx.trace and self.on_device
            self.t0 = time.perf_counter()
            stop_at = self.t0 + self.ctx.seconds
            while time.perf_counter() < stop_at:
                if self.on_device:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.marks.append((time.perf_counter(), ev))
                if tracing and self.steps in (first, first + count):
                    self._sync()
                    if self.steps == first:
                        self.prof = trace.capture_start()
                    else:
                        self.prof.stop()
                batch = next(it)
                if self.ctx.trace and first <= self.steps < first + count:
                    n = len(batch["filenames"])
                    self.traced.append({"rows": n, "images": n})
                self.steps += 1
                yield batch
            self._sync()
            self.t_end = time.perf_counter()
            if self.prof is not None and self.steps < first + count:
                self.prof.stop()
        finally:
            it.close()


def _run(ctx, data_dir: Path, stage) -> dict:
    mix, spec, device, seed = ctx.mix, ctx.spec, ctx.device, ctx.seed
    on_device = device.type == "cuda"
    train_seed = int(seed) % 2**63
    args = dict(mix["trainer"], seed=train_seed, output_dir=str(data_dir / "out"), report_to=None)
    model = program.build_model(spec, weights.make_weights(spec, seed, device), device)
    feed = Feed(program.folder_dataset(str(data_dir), args), ctx, data_dir)
    trainer = program.lora_trainer(model, args, feed)
    stage("weights and model")
    rec = {"train_seed": train_seed, "losses": []}
    b1 = trainer.args.adam_beta1

    def unet_factors(trainable):
        return {f"{p}.{n}": t.detach().clone() for p, f in trainable["unet"].items()
                for n, t in f.items()}

    def seen(i, trainable, opt_state, metrics):
        if i < 0:
            rec["f0"] = unet_factors(trainable)
            return
        rec["losses"].append(metrics["loss"])
        if i == 0:  # the first gradient as AdamW got it, from its first moment
            rec["g1"] = {k[len("unet."):]: v.detach().clone() / (1.0 - b1)
                         for k, v in opt_state["mu"].items() if k.startswith("unet.")}
        if i == mix["checked_steps"] - 1:
            rec["f3"] = unet_factors(trainable)

    with program.watched_steps(mix["checked_steps"], seen):
        trainer.train()
    stage("first steps, window and the trainer's end")
    rec.update(files=feed.files, flips=feed.flips, losses=[float(x) for x in rec["losses"]])
    _step_times(feed.marks)
    peak = torch.cuda.max_memory_allocated() if on_device else 0
    tr = trace.reduce(feed.prof) if feed.prof is not None else None
    del trainer, model, feed.dataset
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    with check.tf32_off():
        checks = compare(rec, spec, mix, seed, device, data_dir, control=bool(ctx.control))
    stage("reference")
    B = mix["trainer"]["train_batch_size"]
    steps = feed.steps
    return {"attempted": steps, "failed": 0 if all(math.isfinite(x) for x in rec["losses"]) else steps,
            "setup_s": feed.setup_s, "window": (feed.t0, feed.t_end), "images": steps * B,
            "steps": steps, "memory_peak_bytes": peak, "trace": tr, "traced_calls": feed.traced,
            "checks": checks, "compared": len(rec["files"]), "log": []}
