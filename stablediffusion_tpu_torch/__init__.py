"""PyTorch/CUDA port of stablediffusion_tpu for NVIDIA Hopper (H100).

The JAX package ``stablediffusion_tpu`` is the reference; this package
imports nothing of it and nothing of JAX.  It covers SD1.5: txt2img,
img2img and inpainting under the 15 schedulers, diffusers checkpoint
folders, the HTTP serving worker with its micro-batcher, and the LoRA train
step.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
