"""The comparison that decides ``correct``: what the timed path served, held
against the plain reference run after the window, with the program freed."""

from __future__ import annotations

import base64
import contextlib
import io
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import weights as weights_mod
from perfbench.reference import pipeline as ref_pipeline
from perfbench.reference.train import quantize_fp8

# controls that put the reference, in a lower precision, in the program's
# place: each maps a component's weights to their rounded copy
REFERENCE_CONTROLS = {"fp8": quantize_fp8}


@contextlib.contextmanager
def tf32_off():
    """TF32 off for the reference's float32 products, and back as it was
    after, so that a later run in the same process times the program as
    configured."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def decode_jpeg(b64: str) -> np.ndarray:
    """A served image (base64 JPEG) as float [H, W, 3] in [0, 255]."""
    from PIL import Image

    im = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    return np.asarray(im, np.float32)


def jpeg_roundtrip(image: np.ndarray) -> np.ndarray:
    """The reference image through the same lossy step the served one took
    (JPEG at quality 95, PIL's encoder), so that the comparison measures the
    pixels and not the codec."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image.astype(np.uint8)).save(buf, format="JPEG", quality=95)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"), np.float32)


def sample(log: List[dict], n: int, seed: int) -> List[dict]:
    """`n` completed requests drawn from the seed, the one with the longest
    prompt among them."""
    done = [r for r in log if r["ok"]]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["request"]["prompt"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % 2**63, 11])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in pick]


def image_gaps(got: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """Gaps in 8-bit levels between two [H, W, 3] images: the RMS of the
    pixels, and the RMS of their means over 64 x 64 blocks, where the
    codec's rounding and the finest detail average out."""
    d = got.astype(np.float64) - ref.astype(np.float64)
    H, W, _ = d.shape
    b = min(64, H, W)
    pooled = d[: H // b * b, : W // b * b].reshape(H // b, b, W // b, b, 3).mean(axis=(1, 3))
    return {"image_rms": float(np.sqrt(np.mean(d ** 2))),
            "image_rms_pool64": float(np.sqrt(np.mean(pooled ** 2)))}


def served_images(samples: List[dict], spec: dict, seed: int, device,
                  control: str = None) -> Dict[str, float]:
    """The worst gaps (:func:`image_gaps`) between a sampled served image and
    the reference's image of the same request (float32, TF32 off), through
    the same JPEG step.  With a `control` of :data:`REFERENCE_CONTROLS`, the
    reference with every matrix and kernel so rounded renders each request
    in the served image's place.  Run it under :func:`tf32_off`."""
    w = weights_mod.make_weights(spec, seed, device, torch.float32)
    lower = ({c: REFERENCE_CONTROLS[control](sd) for c, sd in w.items()}
             if control in REFERENCE_CONTROLS else None)
    worst: Dict[str, float] = {}
    for r in samples:
        req = r["request"]
        args = (spec["components"], req["prompt"], req.get("negative_prompt"), req["seed"],
                req["height"], req["num_inference_steps"], req["guidance_scale"], device)
        ref = jpeg_roundtrip(ref_pipeline.txt2img(w, *args).cpu().numpy())
        if lower is None:
            got = decode_jpeg(r["reply"]["images"][0])
        else:
            got = jpeg_roundtrip(ref_pipeline.txt2img(lower, *args).cpu().numpy())
        gaps = image_gaps(got, ref) if got.shape == ref.shape else {"image_rms_pool64": float("inf")}
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
