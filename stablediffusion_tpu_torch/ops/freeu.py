"""FreeU (arXiv 2309.11497): backbone and skip scaling in the UNet's decoder.

Port of ``stablediffusion_tpu/ops/freeu.py``: at the two deepest decoder
stages the first half of the backbone's channels is amplified by b, and the
skip's centred low frequencies are scaled by s (diffusers' ``enable_freeu(s1,
s2, b1, b2)`` convention, so A1111 and diffusers settings carry over).  The
JAX package runs it in XLA, not in a Pallas kernel; here the 2-D FFTs are
``torch.fft`` (cuFFT on the card) in complex64, as JAX's are complex64.
Layout NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch

# diffusers' recommended (b1, b2, s1, s2)
SD15_DEFAULTS: Tuple[float, float, float, float] = (1.5, 1.6, 0.9, 0.2)
SDXL_DEFAULTS: Tuple[float, float, float, float] = (1.3, 1.4, 0.9, 0.2)


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred low-frequency 2-D Fourier components of an NCHW map
    by `scale`: the half-open box [c - thr, c + thr) on each axis, c = n // 2
    after ``fftshift`` (which puts the zero frequency at n // 2 for odd n
    too); the rest passes unchanged (``freeu.py:29``)."""
    H, W = x.shape[-2:]
    xf = torch.fft.fftn(x.to(torch.complex64), dim=(-2, -1))
    xf = torch.fft.fftshift(xf, dim=(-2, -1))
    crow, ccol = H // 2, W // 2
    rows = torch.arange(H, device=x.device)[:, None]
    cols = torch.arange(W, device=x.device)[None, :]
    low = ((rows >= crow - threshold) & (rows < crow + threshold)
           & (cols >= ccol - threshold) & (cols < ccol + threshold))
    mask = torch.where(low, torch.tensor(scale, dtype=torch.float32, device=x.device),
                       torch.tensor(1.0, dtype=torch.float32, device=x.device))
    xf = xf * mask.to(torch.complex64)
    xf = torch.fft.ifftshift(xf, dim=(-2, -1))
    return torch.fft.ifftn(xf, dim=(-2, -1)).real.to(x.dtype)


def apply_freeu(backbone: torch.Tensor, skip: torch.Tensor, resolution_idx: int,
                params: Tuple[float, float, float, float]):
    """FreeU at one decoder skip concat (``freeu.py:51``): the first half of
    the backbone's channels times b, the skip low-passed by s; active at up
    block 0 (b1, s1) and 1 (b2, s2), a pass-through elsewhere."""
    if resolution_idx not in (0, 1):
        return backbone, skip
    b1, b2, s1, s2 = params
    b, s = (b1, s1) if resolution_idx == 0 else (b2, s2)
    half = backbone.shape[1] // 2
    backbone = torch.cat([backbone[:, :half] * torch.tensor(b, dtype=backbone.dtype,
                                                            device=backbone.device),
                          backbone[:, half:]], dim=1)
    return backbone, fourier_filter(skip, threshold=1, scale=s)
