"""Image pre- and post-processing.

Port of ``stablediffusion_tpu/utils/images.py:25-231``: the
VaeImageProcessor analogues (``preprocess_image`` to NHWC in [-1, 1],
``preprocess_mask`` to a binarized one-channel NHWC mask), the
``padding_mask_crop`` helpers (``get_crop_region``, ``apply_overlay``), the
[-1, 1] -> [0, 1] / uint8 conversions, ``clip_image_preprocess`` (the image
encoder's input), and ``postprocess_uint8_device``, which
quantizes to uint8 on the tensor's device (on the card, so the host fetches a
quarter of the bytes).  Host-side numpy, with PIL's bilinear resize where
PIL is installed, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

ImageLike = Union["Image.Image", np.ndarray, Sequence]


def _to_numpy_batch(image: ImageLike) -> np.ndarray:
    """PIL / array / list thereof -> float32 [B, H, W, C] in [0, 1]."""
    if _HAS_PIL and isinstance(image, Image.Image):
        image = [image]
    if isinstance(image, (list, tuple)):
        arrs = []
        for im in image:
            if _HAS_PIL and isinstance(im, Image.Image):
                arrs.append(np.asarray(im).astype(np.float32) / 255.0)
            else:
                arrs.append(np.asarray(im, np.float32))
        image = np.stack(arrs)
    else:
        image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[None, :, :, None]
    elif image.ndim == 3:
        # HWC single image vs BHW batch of masks: a trailing 1/3/4 is channels
        if image.shape[-1] in (1, 3, 4):
            image = image[None]
        else:
            image = image[..., None]
    if image.max() > 1.0 + 1e-6:
        image = image / 255.0
    return image


def _resize(batch: np.ndarray, h: int, w: int, nearest: bool = False) -> np.ndarray:
    B, H, W, C = batch.shape
    if (H, W) == (h, w):
        return batch
    if _HAS_PIL and not nearest:
        out = np.empty((B, h, w, C), np.float32)
        for b in range(B):
            for c in range(C):
                im = Image.fromarray((batch[b, :, :, c] * 255).astype(np.uint8))
                out[b, :, :, c] = (
                    np.asarray(im.resize((w, h), Image.BILINEAR), np.float32) / 255.0
                )
        return out
    rows = (np.arange(h) * (H / h)).astype(np.int64)
    cols = (np.arange(w) * (W / w)).astype(np.int64)
    return batch[:, rows][:, :, cols]


def preprocess_image(image: ImageLike, height: int, width: int) -> np.ndarray:
    """-> float32 NHWC in [-1, 1]."""
    batch = _to_numpy_batch(image)
    if batch.shape[-1] == 4:
        batch = batch[..., :3]
    if batch.shape[-1] == 1:
        batch = np.repeat(batch, 3, axis=-1)
    batch = _resize(batch, height, width)
    return batch * 2.0 - 1.0


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_image_preprocess(image: ImageLike, size: int = 224) -> np.ndarray:
    """-> float32 NHWC, CLIP-normalised: the image encoder's input for
    IP-Adapter (``images.py:88``).  The shortest side is resized to `size`,
    then the centre is cropped to size x size, as CLIPImageProcessor does."""
    batch = _to_numpy_batch(image)
    if batch.shape[-1] == 4:
        batch = batch[..., :3]
    if batch.shape[-1] == 1:
        batch = np.repeat(batch, 3, axis=-1)
    h, w = batch.shape[1:3]
    if h != w:
        if h < w:
            nh, nw = size, max(size, round(w * size / h))
        else:
            nh, nw = max(size, round(h * size / w)), size
        batch = _resize(batch, nh, nw)
        top, left = (nh - size) // 2, (nw - size) // 2
        batch = batch[:, top : top + size, left : left + size]
    else:
        batch = _resize(batch, size, size)  # [0, 1]
    return (batch - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


def preprocess_mask(mask: ImageLike, height: int, width: int) -> np.ndarray:
    """-> float32 NHWC (one channel) binarized to {0, 1}; 1 = inpaint."""
    batch = _to_numpy_batch(mask)
    if batch.shape[-1] > 1:
        batch = batch.mean(axis=-1, keepdims=True)
    batch = _resize(batch, height, width)
    return (batch >= 0.5).astype(np.float32)


def postprocess_image(images: np.ndarray) -> np.ndarray:
    """[-1, 1] NHWC -> [0, 1] float32."""
    return np.clip(np.asarray(images, np.float32) / 2.0 + 0.5, 0.0, 1.0)


def to_uint8(images: np.ndarray) -> np.ndarray:
    return (postprocess_image(images) * 255).round().astype(np.uint8)


def postprocess_uint8_device(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC tensor -> uint8 [0, 255] on its own device, with the
    fp32 clip, scale and round of ``to_uint8``."""
    x = (images.float() / 2.0 + 0.5).clamp(0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)


def as_uint8(images: np.ndarray) -> np.ndarray:
    """[0, 1] float or uint8 [0, 255] -> uint8 (the encoders take both
    pipeline output types)."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return arr
    return (arr * 255).round().astype(np.uint8)


# -- padding_mask_crop --------------------------------------------------------


def get_crop_region(
    mask: np.ndarray, width: int, height: int, pad: int = 0
) -> Tuple[int, int, int, int]:
    """Bounding box of the masked region grown by `pad` and to the
    processing aspect ratio (VaeImageProcessor.get_crop_region)."""
    m = mask[..., 0] if mask.ndim == 3 else mask
    ys, xs = np.where(m > 0.5)
    H, W = m.shape
    if len(xs) == 0:
        return 0, 0, W, H
    x1 = max(int(xs.min()) - pad, 0)
    y1 = max(int(ys.min()) - pad, 0)
    x2 = min(int(xs.max()) + 1 + pad, W)
    y2 = min(int(ys.max()) + 1 + pad, H)

    ratio_crop = (x2 - x1) / (y2 - y1)
    ratio_proc = width / height
    if ratio_crop > ratio_proc:
        desired_h = int((x2 - x1) / ratio_proc)
        diff = desired_h - (y2 - y1)
        y1 -= diff // 2
        y2 += diff - diff // 2
    else:
        desired_w = int((y2 - y1) * ratio_proc)
        diff = desired_w - (x2 - x1)
        x1 -= diff // 2
        x2 += diff - diff // 2
    if y1 < 0:
        y2 -= y1
        y1 = 0
    if y2 > H:
        y1 -= y2 - H
        y2 = H
    if x1 < 0:
        x2 -= x1
        x1 = 0
    if x2 > W:
        x1 -= x2 - W
        x2 = W
    return max(x1, 0), max(y1, 0), min(x2, W), min(y2, H)


def apply_overlay(
    base: np.ndarray,
    generated: np.ndarray,
    mask: np.ndarray,
    crop: Optional[Tuple[int, int, int, int]] = None,
) -> np.ndarray:
    """Paste `generated` (HWC [0, 1]) into `base` over the masked region."""
    out = base.copy()
    if crop is None:
        crop = (0, 0, base.shape[1], base.shape[0])
    x1, y1, x2, y2 = crop
    gen = _resize(generated[None], y2 - y1, x2 - x1)[0]
    m = _resize(mask[None], y2 - y1, x2 - x1, nearest=True)[0]
    region = out[y1:y2, x1:x2]
    out[y1:y2, x1:x2] = region * (1 - m) + gen * m
    return out
