"""PyTorch/CUDA port of stablediffusion_tpu for NVIDIA Hopper (H100).

The JAX package ``stablediffusion_tpu`` is the reference; this package
imports nothing of it and nothing of JAX.  Slice 1 covers SD1.5 txt2img
(CLIP-L encode, DDIM denoise with classifier-free guidance, VAE decode).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
