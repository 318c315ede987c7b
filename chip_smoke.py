"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, nothing caught):

1. Card and build: print the card's name and power limit, build the three
   CUDA sources of ``stablediffusion_tpu_torch/csrc`` (one nvcc each, all
   started together) into a fresh kernel build cache directory in the
   checkout (``core/compile_cache``), print each kernel's registers and spilled bytes
   (``-Xptxas -v``; a spill in ``flash_bwd.cu``, in any instantiation of
   ``flash_fwd.cu`` (bf16 and fp32) or in an fp32 (3xTF32) instantiation
   of ``flash_stream.cu`` fails the run, and so does ptxas's notice that it
   serialized the wgmma of any instantiation); compile the three sources to
   PTX beside the build (``nvcc -ptx``, the build's flags) and print, for
   each Hopper kernel of ``HOPPER_KERNELS``, the counts in each of its
   instantiations of the products it names (``wgmma.mma_async`` with
   ``.bf16``, or with ``.tf32`` for the fp32 kernels of ``flash_fwd``,
   ``flash_bwd`` and ``flash_stream``)
   and of ``cp.async.bulk.tensor``, and, where the toolkit has
   ``cuobjdump``, of ``HGMMA`` with ``BF16`` or ``TF32`` and ``UTMALDG`` in
   the built libraries' SASS (any of them 0 fails the run); set and print
   the TF32 switches.
2. txt2img main path: the full-width SD1.5 model with random weights answers
   three 512x512, 20-step DDIM, CFG 7.5 requests through the pipeline call
   (batch 1, batch 1 with another seed, a two-prompt batch).  Outputs must be
   finite and of the right shape, and the kernels' launch counts must equal
   what the path implies (no forward writes an lse there).  The wrappers
   also count their launches by call shape, which gives phase 3 its cases.
3. Forward kernels against their plain versions: every call shape the main
   path launched, the UNet's also at B=16 (batch 8 under CFG), and a ragged
   VAE length, each in fp32 and bf16, against the plain version evaluated in
   fp32 on the same inputs under the per-element limit of
   ``utils/testing.KERNEL_TOL`` (the bf16 ``flash_fwd``, which rounds p to
   bf16, against ``attention_p_rounded``, the same online softmax over the
   kernel's key tiles (``ops/attention.flash_fwd_key_tile``) with the same
   rounding, plus ``P_FLIP_RTOL`` times its p near a rounding
   midpoint); at [2,4096,8,40] bf16 three wrong forwards (no accumulator
   rescale, the scale applied twice, the accumulator kept in bf16 between
   tiles) must break that limit, and at [1,4096,1,512] (``flash_stream``)
   and at [1,257,16,104] and the causal [1,77,12,64] (``flash_fwd``), fp32,
   two products that are not fp32-accurate (``utils/testing.
   tf32_wrong_variants``, with the kernel's key tiles and mask: TF32
   operands rounded once, and hi*hi + hi*lo) must break the fp32 limit that
   the 3xTF32 kernels keep (``TEETH_CASES`` names them all).  Each kernel's device time (its own kernel
   events under torch.profiler; the event-timed call, which includes the
   wrapper's host work, beside it), the plain version's and one library
   call's (``F.scaled_dot_product_attention``, a yardstick the port never
   calls) beside the card's bound.
4. Full width in bf16: one UNet forward at B=2 on the main path's weights,
   through the kernels and through the plain attention, each against an fp32
   copy with the plain attention.  The random weights' biases are ones, which
   makes the main path's images almost the same for every prompt and seed, so
   phase 2 alone would not see a wrong kernel output.
5. Reference check: a narrow model (two UNet levels at the SD1.5 head dims
   40/80, a 2-layer CLIP-L, a VAE whose mid-block takes flash_stream) runs
   the pipeline on the card and on the CPU (plain attention) in fp32 with the
   same weights and injected latents; latents and pixels must agree.
6. Where the time goes: one more batch-1 request under torch.profiler;
   device time by kernel group and the device's busy share.
7. Training main path: ``make_train_step`` on the full-width SD1.5 model at
   512x512, batch 8, rank-16 LoRA on the UNet's attention projections,
   Min-SNR 5, AdamW, bf16 UNet, fp32 VAE encode; one warm step and three
   timed ones.  Loss and grad norm finite, every LoRA ``up`` factor moved by
   step 1 (a non-zero gradient), and exact launches per step: 32
   ``flash_fwd`` with lse, 12 causal ``flash_fwd`` without for CLIP, 32 of
   each backward kernel, 1 ``flash_stream`` (the VAE encoder).  Step wall
   time, images/s and peak memory, then one step under torch.profiler.
8. Backward kernels against their plain version: every (shape, dtype,
   causal) the train path launched, each also in the other dtype, CLIP's
   causal shape and a ragged Sq; ``flash_bwd_dq`` and ``flash_bwd_dkv``
   evaluated per element under ``utils/testing.GRAD_TOL``: in bf16 against
   ``attention_bwd_rounded`` (p and ds rounded to bf16 where the kernels and
   the JAX library round them) plus ``P_FLIP_RTOL`` times its flip term, in
   fp32 against ``flash_bwd_plain``; the forward's lse against
   ``attention_plain_lse``; at each bf16 ``BWD_TEETH_CASES`` shape (every
   bf16 head-dim instantiation the train paths launch) four wrong backwards
   (di = 0, dK/dV kept in bf16 between query tiles, ds unscaled, p from the
   row max), and at each fp32 one (CLIP-L's causal shape, D = 80 and D =
   160) two backwards whose products are not fp32-accurate (1xTF32; hi*hi
   + hi*lo: ``utils/testing.tf32_bwd_wrong_variants``, with the mask) must
   break the rule; each kernel's device time as the median of 20
   profiled launches after warm-up, with their min and max, the plain and
   SDPA-backward times beside the bound.
9. Train reference: a narrow SD1.5-layout model, card against CPU, fp32:
   loss and every LoRA gradient of one ``loss_fn`` + backward.
10. Serving: a full-width SD1.5 folder written by ``save_sd_model`` (random
   weights, a synthetic byte-level BPE vocabulary) is loaded by the HTTP
   worker (``serve.worker``, max_batch 4) on 127.0.0.1, every tensor equal
   to the saved one, and asked over loopback: 512x512 txt2img under six
   schedulers switched by the model block, img2img at strength 0.6 from the
   first reply's JPEG, blend4 inpainting, a 768x768 request with the tiled
   decode, a request naming a LoRA file that is not there (answered on the
   error channel), a burst of four that the batcher merges, and one
   request twice alone (the same bytes).  Each request's launches must equal what its plan implies.
   Walls, images/s, group sizes, JPEG time, and merged against solo pixels
   (the kernels themselves batch-invariant, bit for bit).
11. The forward kernels at every shape the serving path launched that no
   earlier phase held, under phase 3's rules and times.
12. Inpaint reference: concat9 on a narrow 9-channel model, card against
   CPU, fp32, the same injected draws, a stochastic scheduler.
13. SDXL main path: the full-width SDXL model (random weights: CLIP-L and
   bigG, the bf16 UNet, the fp32 VAE, the "leading" DDIM plan) answers
   three 1024x1024, 20-step, CFG 7.5 requests (batch 1, batch 1 with
   prompt_2 and negative_prompt_2, two prompts), with exact launches:
   2800 UNet ``flash_fwd`` plus both towers each way, one ``flash_stream``.
14. Where the time goes in one SDXL request, under torch.profiler.
15. Refiner: a full-width random refiner UNet refines the first image,
   img2img at strength 0.3 with ``use_refiner=True``, exact launches.
16. Full-width bf16 SDXL UNet at B=2 and 128x128 latents, as phase 4.
17. The forward kernels at every shape the SDXL and refiner paths launched
   that no earlier phase held (head dim 64 at 4096, 1024 and 256 tokens,
   bigG's causal 77, the 16384-token decode and encode), under phase 3's
   rules and times.
18. SDXL reference: a narrow SDXL-layout model (dual towers, linear
   projections, text_time, two transformer layers at one level, head dim
   64), card against CPU, fp32, 4 DDIM steps.
19. Serving SDXL: a full-width SDXL folder written by ``save_sd_model`` is
   loaded by the worker with no --model_type (the "sdxl" default), every
   tensor equal, and asked over loopback at 1024x1024: DDIM and DPM++ 2M
   Karras, img2img at 0.6, blend4 at 1.0, use_refiner without a refiner
   (error channel) and a burst of two that the batcher merges, each with
   its launches; then phase 17 for the shapes serving added.
20. LoRA and textual inversion on SDXL 1024², through phase 19's worker
   (started with --lora_dir apart from the model dir): a kohya file (rank
   16 on every linear of the UNet's transformer blocks, lora_te1_/lora_te2_
   on q/k/v/out_proj), a peft file (rank 8, UNet attention) and a
   dual-tower textual inversion (2 vectors), over six requests at one
   seed: none, kohya 0.8, + peft 0.5, + the textual inversion and its
   trigger, the text towers at 0.5 (``cross_attention_kwargs``), and
   ``loras: []``.  Exact launches each (2888 + 1); the fused weights within
   one bf16 ulp of the plain ``fuse`` on the CPU; the last image and every
   weight bit for bit the first request's; each adapter image differs from
   it.  Load and ``set_adapters`` times, walls and peak memory.
21. A1111 single file: the full-width SD1.5 model written as an LDM
   .safetensors (``utils/testing.save_ldm_single_file``) and as a folder;
   the handler loads the file by name (every tensor equal to its source)
   and serves it with the folder's image byte for byte; then a kohya LoRA
   on the attention linears and a constructor grid of 2 schedulers x 2
   LoRA scales x 20 steps x CFG 7.5, each image with exact launches.
22. Adapter reference: the narrow SD1.5 and SDXL-layout models of phases 5
   and 18, each with a kohya LoRA on the UNet and every tower and a
   textual inversion, card against CPU in fp32, the text scale through
   ``cross_attention_kwargs``: images within 1e-4 of max(1, max |ref|).

23. The trainer (run after phase 9): ``SDLoRATrainer.train()`` on the
   full-width SDXL model over a seeded folder of four 1024x1024 JPEGs with
   captions (``utils/testing.write_image_folder``): batch 2, rank 16 on the
   UNet's attention projections and both towers' q/k/v/out_proj
   (train_text_encoder, the JAX trainer's default), Min-SNR 5, constant
   LR, 4 steps, a checkpoint every 2, a one-image 4-step validation render
   each epoch, no remat.  Each step's wall, loss, grad norm and launches by
   kernel and shape, held exactly to the plan: 140 UNet + 12 CLIP-L + 32
   bigG forwards with lse, 140 + 11 + 32 of each backward kernel (SDXL
   reads CLIP-L's penultimate states, so its last layer's attention gets
   no backward), one ``flash_stream`` (the encode); each render 648 + 1.
   Every factor of the saved file moved except the four ``up``s of
   CLIP-L's last layer, which are named.  Peak memory, images/s over the
   three timed steps, a profiled step; then the saved file through
   ``load_loras`` in one 1024² request (2888 + 1).
24. The trainer's kernels at every (shape, dtype) phases 23 and 25
   launched that no earlier phase held: the bf16 ``<64>`` backward at
   [2,4096,10,64], [2,1024,20,64] and their x77 rows, the fp32 causal pair
   at [2,77,12,64] and [2,77,20,64], ``flash_stream`` at [2,16384,1,512],
   under phase 3's and phase 8's rules and times.
25. Trainer variants on the full-width SD1.5 model at 512², batch 2: 8-bit
   Adam, two-step bf16 accumulation, cache_latents (the separate no-grad
   encode), a kohya file; 4 steps straight against 2 steps and a resume
   from checkpoint-2 for 2 more, factors within ``RESUME_TOL``; exact
   launches per data step; the kohya file equal to the trainer's factors.

26. SD3 main path (run after phase 22): SD3-medium and T5-XXL at full
   width (``random_full_model("sd3", with_t5=True)``, every module in
   bf16) answer 1024x1024 requests at 28 FlowMatchEuler steps and CFG 7.0:
   two seeds, then the first again, bit for bit; exact launches: 672 joint
   ``flash_fwd`` (24 blocks x 28 steps at [2,4429,24,64]), CLIP-L's and
   bigG's causal layers each way, T5's 24 layers each way through the
   counted masked route (``ATTENTION_MASKED_LAUNCHES``), one
   ``flash_stream``, no lse.  One request profiled: device time by group,
   busy share, peak memory, wall.
27. Full width in bf16: one MM-DiT forward at B=2 on 128x128 latents with
   333 text tokens, SD3-medium and a random SD3.5-medium (MMDiT-X, QK-RMSNorm),
   through the kernels and through the plain attention, each against an
   fp32 copy, under UNET_SLACK.
28. The forward kernels at every shape the SD3 path launched that no earlier
   phase held (the ragged joint [2,4429,24,64]), MMDiT-X's attn2
   [2,4096,24,64] and SD3.5-large's [2,4429,38,64], under phase 3's rules
   and times, with three wrong forwards as teeth at each of those three.
29. SD3 reference: a narrow SD3 model (two joint blocks at head dim 64, the
   first MMDiT-X with QK-RMSNorm, 2-layer CLIP-L/bigG at full width, a
   2-layer T5 with d_kv 64, a 16-channel VAE whose mid-block takes
   flash_stream), card against CPU, fp32, the same injected draws:
   txt2img, img2img and inpainting, latents and pixels within REF_TOL.
30. Serving SD3: the T5-free SD3-medium folder (``save_sd3_model``) loaded
   by the worker with ``--model_type sd3``, every tensor equal; txt2img, a
   payload with SDXL-only keys (dropped with a warning), img2img, inpainting
   and a merged burst of two over loopback at 1024², each with exact
   launches; then phase 28 for the shapes serving added.

31. SD3 training (run after phase 30): ``SD3LoRATrainer`` on SD3-medium
   with T5-XXL at 1024² (the joint stream 4096 + 77 + 77 = 4250 tokens),
   batch 1, rank 16 on both streams' attention projections, 4 steps with a
   checkpoint at step 2 and a resume from it for 2 more (bit for bit the
   straight run); exact launches per step: 24 joint forwards with lse at
   [1,4250,24,64] and 24 of each backward kernel, CLIP-L's 12 and bigG's
   32 causal forwards without lse, T5's 24 masked plain calls, 1
   ``flash_stream``; a profiled step; one step's loss and gradients under
   "full", "dots" and "offload" against none (within REMAT_TOL, launches
   with lse doubled by the recompute), with each policy's wall and peak
   ("full" and "offload" under REMAT_PEAK_SHARE of none's);
   ``cache_latents`` for 2 steps, bit for bit the straight run's
   checkpoint-2.
32. Full fine-tuning: the full-width SD1.5 UNet at 512², batch 8, with an
   EMA for 3 steps (every forward with lse in bf16; the EMA's move against
   its fp64 recomputation's, over the whole UNet, within EMA_TOL, which an
   EMA left unchanged or one update short exceeds), the saved folder reloaded in fp32 by
   ``load_sd_model`` with every UNet tensor equal to the fp32 EMA and
   apart from the initial weights, rendering a finite image, then 2
   steps with the 8-bit Adam; peak memory.
33. Textual inversion on the full-width SDXL model at 1024², batch 2, two
   vectors in both towers, 3 steps: every other row of both tables
   unchanged bit for bit; ``learned_embeds.safetensors`` loaded into a
   fresh model by the handler's model block and a request with the
   trigger answered with a finite image, exact launches.
34. DreamBooth with prior preservation, SD1.5 512²: the port's pipeline
   renders 2 class images on the card, then 2 LoRA steps on [instance |
   class] batches, exact launches.
   After each of phases 31-34, phase 24's kernel check at every shape it
   launched that no earlier phase held (the forward with lse and the
   backward pair at [1,4250,24,64], with wrong variants as teeth).

35. int8 serving (run after phase 34): the full-width SD1.5 model quantized
   "w8", "w8a8" and "w8a8:2048" answers one 512² request each with phase
   2's launches and exactly the int8 products its int8 layers plan (each
   once a UNet forward; ``ops/quant.INT8_LINEAR_CALLS`` /
   ``INT8_CONV_CALLS``), its PSNR against the bf16 image printed; one UNet
   forward per mode on the card (bf16) against the CPU (fp32) on the same
   int8 modules, within UNET_SLACK ("w8") or INT8_A8_SLACK ("w8a8") times
   the bf16 UNet's own distance; SDXL 1024² under "w8a8:2048" likewise
   (``add_embedding`` and every GEGLU projection int8, full "w8a8" padding
   add_embedding's 2 rows for the int8 GEMM, counted); the denoise step's
   device and event ms in bf16 and each mode at SD1.5 batch 1 and 8 and
   SDXL batch 1 (``ops/quant.AUTO_QUANT_*`` come from these rows),
   ``torch._int_mm`` against bf16 at the main linear shapes, the UNets'
   resident bytes.
36. int8 checkpoints: the SDXL model written by ``save_sd_model(quantize=
   "w8a8:2048")`` and loaded back ``quant_frozen``, its UNet's tensors, a
   forward and the 1024² image equal bit for bit to the in-memory model's,
   its allocated bytes at most INT8_FOLDER_SHARE of the bf16 UNet's, LoRA
   fusion refused; the SD1.5 model's fp folder through ``python -m
   stablediffusion_tpu_torch.io.quantize_cli --mode w8a8`` (on the CPU),
   its UNet equal to the card's own "w8a8" quantization.
37. SD3 LoRA serving: phase 31's trained file through the handler's model
   block on the same base: phase 26's launches (760, 48 masked, 1), every
   fused weight within a bf16 ulp of the CPU's fp32 base + B·A, a request
   under ``quantize: "w8a8"`` with exact launches and int8 products, then
   ``quantize: null`` and ``loras: []`` restoring every MM-DiT and CLIP
   weight bit for bit (T5 never written).
38. The front doors: the worker over phase 36's int8 SD1.5 folder answers
   GET /ui with ``serve/webapp.index_html()``, a ``build_ui_request``
   payload by POST with phase 2's launches and the planned int8 products,
   and ``serve/worker.trigger_fn`` the same job with the same image.

39. The pipeline extensions (run after phase 38) on the full-width SD1.5
   model at 512², 20 DDIM steps, CFG 7.5, batch 1, one request each: a
   weighted prompt with a ``[from:to:when]`` edit, a prompt of more than 75
   tokens (two chunks: each tower pass runs on two rows), FreeU, PAG 3.0 on
   "mid" and on every group, DeepCache at interval 3, the hires fix (512²
   base, 1024² at strength 0.7), InstructPix2Pix (an 8-channel UNet,
   image guidance 1.5), a ControlNet at control_v11p_sd15_canny's config
   written as a folder and loaded (``utils/testing.write_controlnet_folder``:
   its zero convolutions seeded non-zero), and IP-Adapter standard and Plus
   over the ViT-H/14 image encoder, both written and loaded through the
   loaders.  Each request's launches against its plan (from the modules and
   the schedule: the tower passes, the full and shallow UNet calls, PAG's
   call on the conditional half with its perturbed self-attentions left
   out, the ControlNet's and the image encoder's and Resampler's
   attentions), finite pixels, a repeat under torch.profiler bit for bit
   (its device time), and the ControlNet, IP-Adapter, PAG, FreeU, DeepCache
   and edit images apart from the plain one; each extension on the narrow
   model of phase 5, card against CPU in fp32 within REF_TOL (the hires
   fix with both passes' draws injected); the kernels at every new shape,
   the hires pass's [2,16384,8,40] held head by head.
40. SDXL at 1024², 20 steps: one request with a ControlNet at
   diffusers/controlnet-canny-sdxl-1.0's config (its text_time embedding),
   an IP-Adapter at ip-adapter_sdxl's over the ViT-bigG/14 image encoder
   (head dim 104), and FreeU, with its plan, a repeat and the peak memory;
   the narrow SDXL model with all three, card against CPU; the new shapes.
41. Serving and the lifecycle: phase 39's model behind the worker's server
   (its ControlNet loaded in the program): a model block naming an
   IP-Adapter file with a base64 ``ip_adapter_image`` (without an image
   encoder it answers on the error channel, as the JAX handler's does; with
   one loaded, its plan), a base64 ``control_image``, and phase 38's UI
   payload with FreeU, PAG and the hires fix; then ``load_ip_adapter``,
   ``load_loras``, ``quantize("w8")`` (every IP linear int8 where JAX's
   plan puts it), ``quantize(None)``, ``delete_adapters`` and
   ``unload_ip_adapter`` leave the UNet bit for bit as before.
42. ControlNet training (after phase 41): ``ControlNetTrainer`` on the
   full-width SD1.5 model at 512², batch 4, lr 5e-6, a ControlNet at
   control_v11p_sd15_canny's config initialized from the UNet, over a
   folder pair of seeded images and edge maps: 3 steps with a checkpoint at
   step 2 and the launch plan exact each step (the ControlNet's and the
   UNet's up-block attentions under grad; the UNet's down and mid blocks,
   where the residuals have not joined yet, and CLIP-L without), a profiled
   step, a resumed step 3 bit for bit the straight run's (cuDNN
   deterministic for the phase), the saved fp32 folder reloaded equal, one
   ControlNet request served with it; then every new kernel shape (batch 4)
   against its plain version.
43. The parallel paths on a 1-rank NCCL process group: an SD1.5 512² LoRA
   trainer step under DP, ZeRO-1 and FSDP, each bit for bit and launch for
   launch the meshless step, and one request through a ``Handler(mesh=)``.
44. The tooling: the convert CLI's folder renders the image of the handler's
   single-file render bit for bit; phase 1's cold build into the cache
   directory against a fresh process's warm load; the native BPE loop's
   word count; a request's "generate" span in a ``profile_to`` trace; an
   ``inference_wandb`` request (config inline); one request's FLOPs
   (FlopCounterMode plus the kernels' launch records) equal to
   FlopCounterMode's count of the request through SDPA, and its MFU.

Prints one JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

PEAK_FLOPS = {
    "bfloat16": 989e12,  # H100 SXM dense bf16 tensor-core rate
    # fp32-accurate products on the tensor cores: 3xTF32 (each operand split
    # into two TF32 parts, three products) at a third of the H100 SXM's
    # dense TF32 rate, 495e12 / 3
    "float32": 495e12 / 3,
}
# the H100 SXM's fp32 rate outside the tensor cores: the floor of exact fp32
# products on FFMAs, reported beside an fp32 bound ("products_ffma")
FFMA_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# reference check: card (kernels) vs CPU (plain) in fp32 with TF32 off; the
# sums run in other orders through 4 DDIM steps of the UNet
REF_TOL = 1e-3
# the same with adapters and a textual inversion (phase 22), on the images in
# [0, 1], relative to max(1, max |ref|), as the port's CPU parity tests hold
ADAPTER_REF_TOL = 1e-4
# full-width bf16 UNet: both paths round the probabilities to bf16 for the
# product with v (the kernel from its fp32 running max, the plain path after
# the softmax), so the kernels' path should lie as far from the fp32 model
# as the plain one; 25% covers the other bf16 roundings, which differ
UNET_SLACK = 1.25
# the training main path: batch 8 as benchmarks/bench_train.py (it fits the
# card without checkpointing the UNet), one warm step and this many timed ones
TRAIN_BATCH = 8
TRAIN_STEPS = 3
# train reference: loss and LoRA gradients, card (kernels) vs CPU (plain),
# fp32 with TF32 off, relative to each tensor's largest element
TRAIN_REF_TOL = 1e-3
# exponentials a clock on one SM of an H100 SXM: 16 on the MUFU, plus the
# 128 FMA lanes at 4 FMA-pipe operations each for a polynomial exp2 (range
# reduction and three Horner steps, as FlashAttention-4 emulates it); and
# the card's SMs
MUFU_PER_CLOCK = 16
FMA_EXP_PER_CLOCK = 128 / 4
SMS = 132


def _wrong_bf16_forwards(q, k, v, causal, tile):
    """three wrong bf16 forwards against attention_p_rounded"""
    from stablediffusion_tpu_torch.utils.testing import attention_wrong_variants

    return attention_wrong_variants(q, k, v, causal, block=tile)


def _wrong_fp32_products(q, k, v, causal, tile):
    """products that are not fp32-accurate (1xTF32; hi*hi + hi*lo), with
    the kernel's key tiles and mask, against the plain version"""
    from stablediffusion_tpu_torch.utils.testing import tf32_wrong_variants

    return tf32_wrong_variants(q, k, v, causal)


# (kernel, B, Sq, H, D, Skv, dtype) where wrong versions of a kernel must
# break its rule -> the function that makes them.  bf16 flash_fwd: SD1.5's
# heaviest self-attention; SD3's ragged joint attention at 1024² (served
# with T5 at 256 tokens, trained with 77), MMDiT-X's attn2 and SD3.5-large's
# joint attention.  The fp32 kernels, whose rule 3xTF32 keeps: flash_stream
# at an SD1.5 request's decode; flash_fwd at the SDXL IP-Adapter's image
# encoder (ViT-bigG/14) and at CLIP-L's causal self-attention.
TEETH_CASES = {
    **dict.fromkeys([("flash_fwd", 2, 4096, 8, 40, 4096, "bfloat16"),
                     ("flash_fwd", 2, 4429, 24, 64, 4429, "bfloat16"),
                     ("flash_fwd", 1, 4250, 24, 64, 4250, "bfloat16"),
                     ("flash_fwd", 2, 4096, 24, 64, 4096, "bfloat16"),
                     ("flash_fwd", 2, 4429, 38, 64, 4429, "bfloat16")], _wrong_bf16_forwards),
    **dict.fromkeys([("flash_stream", 1, 4096, 1, 512, 4096, "float32"),
                     ("flash_fwd", 1, 257, 16, 104, 257, "float32"),
                     ("flash_fwd", 1, 77, 12, 64, 77, "float32")], _wrong_fp32_products),
}
# the backward pairs (B, Sq, H, D, Skv, dtype) where wrong backwards must
# break the rule.  bf16 (four wrong backwards: attention_bwd_wrong_variants):
# SD1.5's three self-attention widths (D = 40, 80 and 160: every padded
# width of the bf16 kernels), SD3's ragged joint stream in training at
# 1024² (4250 = 33 * 128 + 26) and the SDXL trainer's heaviest.  fp32 (two
# backwards whose products are not fp32-accurate, which the 3xTF32 kernels'
# rule must refuse: tf32_bwd_wrong_variants): CLIP-L's causal
# self-attention (phase 8's and the SDXL trainer's: the fp32 kernels' D <=
# 64 bucket), D = 80 and D = 160 (their other two)
BWD_TEETH_CASES = {(TRAIN_BATCH, 4096, 8, 40, 4096, "bfloat16"),
                   (TRAIN_BATCH, 1024, 8, 80, 1024, "bfloat16"),
                   (TRAIN_BATCH, 256, 8, 160, 256, "bfloat16"),
                   (1, 4250, 24, 64, 4250, "bfloat16"),
                   (2, 4096, 10, 64, 4096, "bfloat16"),
                   (8, 77, 12, 64, 77, "float32"), (2, 77, 12, 64, 77, "float32"),
                   (TRAIN_BATCH, 1024, 8, 80, 1024, "float32"),
                   (TRAIN_BATCH, 256, 8, 160, 256, "float32")}
# profiled launches a backward kernel's time is the median of, after warm-up
BWD_TIMED_LAUNCHES = 20


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, key: str, reps: int) -> float:
    """Mean device time of one launch of the CUDA kernel whose name holds
    `key` (each wrapper launches it once a call), from torch.profiler's
    kernel events over `reps` calls after one warm-up: the kernel's own
    time, without the wrapper's host work.  The mean is over the events
    the profiler kept: late in a long run it drops some, and a profiling
    run that kept none is repeated; after three such runs the calls are
    timed with CUDA events, and a ``device_ms_fallback`` line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and key in e.name]
        if us:
            return sum(us) / 1e3 / len(us)
    # the profiler kept no event of the kernel: time the calls with CUDA
    # events instead (the wrapper's host work included), and say so
    ms = _time_ms(fn, reps)
    print(json.dumps({"device_ms_fallback": key, "event_ms": ms,
                      "why": "torch.profiler kept no kernel event in 3 runs"}), flush=True)
    return ms


def _device_ms_spread(fn, key: str, reps: int) -> dict:
    """Device time of one launch of the CUDA kernel whose name holds `key`
    over `reps` calls after three warm-up calls, from torch.profiler's
    kernel events: {"median", "min", "max", "n"} in ms (n: the events the
    profiler kept).  The median holds still where a mean of a few launches
    swung between runs; a profiling run that kept fewer than half the
    events is repeated, and after three such runs the calls are timed with
    CUDA events (the wrapper's host work included; every field the mean),
    which a ``device_ms_fallback`` line says."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA and key in e.name]
        if 2 * len(us) >= reps:
            return {"median": statistics.median(us), "min": min(us), "max": max(us),
                    "n": len(us)}
    ms = _time_ms(fn, reps)
    print(json.dumps({"device_ms_fallback": key, "event_ms": ms,
                      "why": "torch.profiler kept too few kernel events in 3 runs"}),
          flush=True)
    return {"median": ms, "min": ms, "max": ms, "n": 0}


@functools.lru_cache(maxsize=None)
def _sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def _pairs(Sq, Skv, causal):
    """(query, key) pairs a call computes: a causal call only j <= i."""
    return sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv


def _roofline(flops, nbytes, dtype, exps=0):
    """(least ms on the card, what bounds it, each term in ms): the largest
    of products / peak, exponentials on the MUFU and the FMA lanes together
    / (SMs x their rate x the max SM clock), and bytes / HBM rate; products
    and exponentials are both "operations".  Each term alone is a floor, so
    their maximum is one.  ``exp_mufu`` (every exponential on the MUFU, as
    the port's kernels compute them) and, in fp32, ``products_ffma`` (the
    products on FFMAs) are reported beside, not part of the bound."""
    clock = SMS * _sm_clock_hz()
    terms = {"products": flops / PEAK_FLOPS[dtype] * 1e3,
             "exp": exps / (clock * (MUFU_PER_CLOCK + FMA_EXP_PER_CLOCK)) * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    bound = max(terms.values())
    terms["exp_mufu"] = exps / (clock * MUFU_PER_CLOCK) * 1e3
    if dtype == "float32":
        terms["products_ffma"] = flops / FFMA_FLOPS * 1e3
    return bound, ("bytes" if bound == terms["bytes"] else "operations"), terms


def _bound(B, Sq, H, D, Skv, causal, dtype, itemsize):
    """The forward's bound: 4 operations per pair and head dim and one
    exponential per pair; q, k, v read once, out written once."""
    pairs = B * H * _pairs(Sq, Skv, causal)
    return _roofline(4 * pairs * D, itemsize * B * H * D * (2 * Sq + 2 * Skv), dtype,
                     exps=pairs)


def _bwd_bound(kernel, B, Sq, H, D, Skv, causal, dtype, itemsize):
    """A backward kernel's bound on its own function.  dkv: s, dp, dV, dK,
    8 operations per pair and head dim; reads q, k, v, dO, lse, di, writes
    dK, dV.  dq: s, dp, dQ, 6 per pair; reads the same, writes dQ.  (The
    pair together could do with 10: s and dp once.)  Each kernel recomputes
    p = exp(s - lse): one exponential per pair."""
    dkv = kernel == "flash_bwd_dkv"
    pairs = B * H * _pairs(Sq, Skv, causal)
    rows = 2 * Sq + 2 * Skv + (2 * Skv if dkv else Sq)
    return _roofline((8 if dkv else 6) * pairs * D,
                     itemsize * B * H * D * rows + 2 * 4 * B * H * Sq, dtype, exps=pairs)


def kernel_case(name, kernel, plain, B, Sq, H, D, Skv, dtype, causal,
                launches, launches_batch1):
    import torch
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops.attention import flash_fwd_key_tile
    from stablediffusion_tpu_torch.utils.testing import attention_p_rounded, kernel_error

    g = torch.Generator(device="cuda").manual_seed(1234)
    q = torch.randn(B, Sq, H, D, device="cuda", dtype=dtype, generator=g)
    k = torch.randn(B, Skv, H, D, device="cuda", dtype=dtype, generator=g)
    v = torch.randn(B, Skv, H, D, device="cuda", dtype=dtype, generator=g)
    kw = {"causal": True} if causal else {}
    out = kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    # the plain version in fp32 on the same input values; the bf16 flash_fwd
    # rounds p to bf16 from the running max of its key tiles (128 keys up to
    # head dim 128, 64 above: ops/attention.flash_fwd_key_tile), and its
    # plain version does the same
    dname = str(dtype).replace("torch.", "")
    if B * H * Sq * Skv >= 2**32:
        # fp32 logits of 16 GiB and more (the hires pass's [2,16384,8,40]):
        # the same function on one head at a time
        plain = functools.partial(_per_head, plain)
    tile = flash_fwd_key_tile(D)[1] if (name, dname) == ("flash_fwd", "bfloat16") else None
    if tile is not None:
        ref, flips = attention_p_rounded(q, k, v, causal, block=tile)
    else:
        ref, flips = plain(q.float(), k.float(), v.float(), **kw), None
    err = kernel_error(out, ref, flips)
    teeth = None
    wrong = TEETH_CASES.get((name, B, Sq, H, D, Skv, dname))
    if wrong is not None:
        teeth = {n: kernel_error(w, ref, flips)["worst_over_limit"]
                 for n, w in wrong(q, k, v, causal, tile).items()}
        print(json.dumps({"rule_teeth": f"{name} {dname}: {' '.join(wrong.__doc__.split())}",
                          "shape": [B, Sq, H, D], "skv": Skv, "worst_over_limit": teeth}),
              flush=True)
    del ref, flips
    big = B * Sq * Skv * H >= 2**31  # plain logits of 8 GiB and up
    ms = _device_ms(lambda: kernel(q, k, v, **kw), name, 10)
    event_ms = _time_ms(lambda: kernel(q, k, v, **kw), 10)
    plain_ms = _time_ms(lambda: plain(q, k, v, **kw), 2 if big else 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 10
    )
    bound_ms, bound_by, terms = _bound(B, Sq, H, D, Skv, causal, dname, q.element_size())
    row = dict(kernel=name, shape=[B, Sq, H, D], skv=Skv, dtype=dname,
               causal=causal, launches=launches, launches_batch1=launches_batch1,
               **err, kernel_ms=ms, event_ms=event_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_terms_ms=terms)
    print(json.dumps(row), flush=True)
    if not err["worst_over_limit"] <= 1.0:
        raise AssertionError(f"{name} {row['shape']} Skv={Skv} {dname}: max abs err "
                             f"{err['max_abs_err']}, {err['worst_over_limit']} x its limit")
    if teeth is not None and not min(teeth.values()) > 1.0:
        raise AssertionError(f"the {dname} limit accepts a wrong forward: {teeth}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return row


def _per_head(fn, q, k, v, **kw):
    """`fn` over [B, S, H, D] called head by head: the same values, a
    head's logits at a time."""
    import torch

    return torch.cat([fn(q[:, :, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1], **kw)
                      for h in range(q.shape[2])], dim=2)


def _cases(by_shape, widen=True):
    """Every (kernel, B, Sq, H, D, Skv, causal) a path launched; with
    `widen`, the UNet's (flash_fwd, not causal) at batch 1 also at B=16,
    and a ragged VAE length."""
    cases = set()
    for name, shapes in by_shape.items():
        for (qs, skv, _dtype, causal, _lse) in shapes:
            cases.add((name, *qs, skv, causal))
            if widen and name == "flash_fwd" and not causal and qs[0] == 2:
                cases.add((name, 16, *qs[1:], skv, causal))
    if widen:
        cases.add(("flash_stream", 1, 4096, 1, 512, 4100, False))
    return sorted(cases)


def phase_kernels(by_shape, by_shape_batch1):
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import (
        flash_stream,
        flash_stream_plain,
    )

    fns = {"flash_fwd": (flash_fwd, attention_plain),
           "flash_stream": (flash_stream, flash_stream_plain)}
    rows = []
    for (name, B, Sq, H, D, Skv, causal) in _cases(by_shape):
        for dtype in (torch.bfloat16, torch.float32):
            key = ((B, Sq, H, D), Skv, str(dtype).replace("torch.", ""), causal, False)
            rows.append(kernel_case(
                name, *fns[name], B, Sq, H, D, Skv, dtype, causal,
                by_shape[name].get(key, 0), by_shape_batch1[name].get(key, 0)))
    for name in fns:
        per_request = sum(r["launches_batch1"] for r in rows if r["kernel"] == name)
        print(f"{name}: {sum(r['kernel'] == name for r in rows)} cases; launches of "
              f"the batch-1 request summed over them: {per_request}", flush=True)
    return rows


def _n_tf(unet):
    from stablediffusion_tpu_torch.models.unet import BasicTransformerBlock

    return sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())


def _count_blocks(model):
    from stablediffusion_tpu_torch.models.vae import VAEAttention

    n_vae = sum(isinstance(m, VAEAttention) for m in model.vae.decoder.modules())
    return _n_tf(model.unet), n_vae


def _narrow_sd15(seed):
    """The narrow SD1.5-layout model of phase 5 on the CPU, fp32: two UNet
    levels at the SD1.5 head dims 40/80, a 2-layer CLIP-L, a VAE whose
    mid-block takes flash_stream."""
    import dataclasses

    import torch

    from stablediffusion_tpu_torch.core.config import SD15_TEXT_ENCODER, SD15_UNET, VAEConfig
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        SD15_UNET, sample_size=16, block_out_channels=(320, 640),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1,
    )
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    return random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device="cpu",
                        dtype=torch.float32, seed=seed)


def _narrow_sdxl(seed):
    """The narrow SDXL-layout model of phase 18 on the CPU, fp32: CLIP-L and
    bigG at full width and 2 layers each, a UNet of two levels at SDXL's
    head dim 64 (5 and 10 heads), two transformer layers at the first,
    linear projections, text_time, a VAE whose mid-block takes
    flash_stream."""
    import dataclasses

    import torch

    from stablediffusion_tpu_torch.core.config import (
        SDXL_TEXT_ENCODER,
        SDXL_TEXT_ENCODER_2,
        SDXL_UNET,
        VAEConfig,
    )
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        SDXL_UNET, sample_size=16, block_out_channels=(320, 640),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1, transformer_layers_per_block=(2, 1), num_attention_heads=(5, 10))
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    t1 = dataclasses.replace(SDXL_TEXT_ENCODER, num_hidden_layers=2)
    t2 = dataclasses.replace(SDXL_TEXT_ENCODER_2, num_hidden_layers=2)
    return random_model(ucfg, vcfg, t1, bench_tokenizer(), device="cpu", dtype=torch.float32,
                        seed=seed, text_encoder_2_config=t2,
                        tokenizer_2=bench_tokenizer(pad_token_id=0))


def _to_card(cpu):
    """A copy of a CPU SDModel on the card, with its own tokenizers."""
    import dataclasses

    mods = {c: copy.deepcopy(getattr(cpu, c)).cuda()
            for c in ("unet", "vae", "text_encoder", "text_encoder_2")
            if getattr(cpu, c) is not None}
    return dataclasses.replace(cpu, tokenizer=copy.deepcopy(cpu.tokenizer),
                               tokenizer_2=copy.deepcopy(cpu.tokenizer_2), **mods)


def phase_reference():
    """Narrow model, card vs CPU, fp32, same weights and latents."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import (
        StableDiffusionUnifiedPipeline,
    )

    cpu = _narrow_sd15(seed=3)
    gpu = _to_card(cpu)
    lat = np.random.default_rng(7).standard_normal((1, 16, 16, 4)).astype(np.float32)
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        pipe = StableDiffusionUnifiedPipeline(device=dev, dtype=torch.float32)
        common = dict(prompt="a small red house", num_inference_steps=4,
                      guidance_scale=7.5, latents=torch.from_numpy(lat))
        f0, s0 = FLASH_FWD_LAUNCHES.count, FLASH_STREAM_LAUNCHES.count
        latents = pipe(model, output_type="latents", **common).latents
        images = pipe(model, output_type="np", **common).images
        outs[name] = (latents.float().cpu().numpy(), images)
        if dev == "cuda" and (FLASH_FWD_LAUNCHES.count == f0
                              or FLASH_STREAM_LAUNCHES.count == s0):
            raise AssertionError("reference run on the card launched no kernel")
    lat_err = float(np.abs(outs["cpu"][0] - outs["cuda"][0]).max())
    img_err = float(np.abs(outs["cpu"][1] - outs["cuda"][1]).max())
    print(json.dumps({"reference": "narrow SD1.5 layout, card vs CPU, fp32",
                      "latents_max_abs_err": lat_err,
                      "images_max_abs_err": img_err, "tol": REF_TOL}), flush=True)
    if not (lat_err <= REF_TOL and img_err <= REF_TOL):
        raise AssertionError(f"card disagrees with CPU: {lat_err}, {img_err}")


def _clip_layers(model, refiner=False):
    """Layers one prompt encode runs: every layer of each tower it uses
    (the refiner's encode uses SDXL's second tower alone)."""
    n2 = model.text_encoder_2_config.num_hidden_layers if model.is_sdxl else 0
    return n2 if refiner else model.text_encoder_config.num_hidden_layers + n2


def _want(model, n_evals, streams, refiner=False):
    """The launches of one CFG call: one encode each for the prompts and the
    negatives, two attentions per transformer block per UNet evaluation,
    and `streams` VAE mid-block attentions (one per encode and decode)."""
    unet = model.refiner if refiner else model.unet
    return {"flash_fwd": 2 * _clip_layers(model, refiner) + 2 * _n_tf(unet) * n_evals,
            "flash_stream": streams}


def phase_main_path(name="sd15", res=512, requests=None):
    """`name`'s full-width random model answers three `res`x`res`, 20-step
    DDIM, CFG 7.5 requests through the pipeline call, with exact launches."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import (
        StableDiffusionUnifiedPipeline,
    )
    from stablediffusion_tpu_torch.utils.testing import random_full_model

    t0 = time.perf_counter()
    model = random_full_model(name, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"full-width {name} random model built in {time.perf_counter() - t0:.3f} s",
          flush=True)
    pipe = StableDiffusionUnifiedPipeline(device="cuda")
    steps = 20
    want = _want(model, steps, 1)
    requests = requests or [
        dict(prompt="a photograph of an astronaut riding a horse", seed=0),
        dict(prompt="a watercolor painting of a fox in the snow", seed=1),
        dict(prompt=["a red bicycle by a canal", "a lighthouse at dusk"], seed=2),
    ]
    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    for c in counters.values():
        c.reset()
    results, batch1 = [], None
    torch.cuda.reset_peak_memory_stats()
    for req in requests:
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(model, height=res, width=res, num_inference_steps=steps,
                   guidance_scale=7.5, **req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count - before[n] for n, c in counters.items()}
        B = 1 if isinstance(req["prompt"], str) else len(req["prompt"])
        im = out.images
        print(json.dumps({"model": name, "request": req, "wall_s": wall, "launches": got,
                          "expected_launches": want, "shape": list(im.shape),
                          "dtype": str(im.dtype), "mean": float(im.mean()),
                          "std": float(im.std())}), flush=True)
        if im.shape != (B, res, res, 3) or im.dtype != np.float32:
            raise AssertionError(f"bad output {im.shape} {im.dtype}")
        if not (np.isfinite(im).all() and im.min() >= 0.0 and im.max() <= 1.0):
            raise AssertionError("non-finite or out-of-range pixels")
        if got != want:
            raise AssertionError(f"launch counts {got} != expected {want}")
        results.append(im)
        if batch1 is None:  # launches of the first (batch-1) request by shape
            batch1 = {n: dict(c.by_shape) for n, c in counters.items()}
    if np.array_equal(results[0], results[1]):
        raise AssertionError("two seeds and prompts gave identical images")
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    if min(totals.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {totals}")
    for n, shapes in batch1.items():
        for (qs, skv, dtype, causal, _lse), count in sorted(shapes.items()):
            print(json.dumps({"batch1_launches": n, "model": name, "shape": list(qs),
                              "skv": skv, "dtype": dtype, "causal": causal,
                              "count": count}), flush=True)
    print(f"{name} main path peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return totals, by_shape, batch1, model, pipe, results[0]


def _rel_err(a, ref):
    """rms(a - ref) over the spread of ref (its standard deviation)."""
    return ((a - ref).pow(2).mean().sqrt() / ref.std()).item()


def phase_unet_bf16(model):
    """One full-width UNet forward at B=2 and the model's latent size in
    bf16 through the kernels and through the plain attention, each against
    an fp32 copy of the same UNet with the plain attention, on the same
    inputs (an SDXL UNet also on random pooled embeds and its 1024² time
    ids)."""
    import torch

    import stablediffusion_tpu_torch.models.unet as unet_module
    from stablediffusion_tpu_torch.ops.attention import attention_plain

    unet = model.unet
    dtype = next(unet.parameters()).dtype
    cfg = unet.config
    hw = cfg.sample_size
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, cfg.in_channels, hw, hw, device="cuda", generator=g)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, device="cuda", generator=g)
    t = torch.tensor(500, device="cuda")
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        res = float(hw * model.vae_scale_factor)
        added = {"text_embeds": torch.randn(2, pooled, device="cuda", generator=g),
                 "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * 2, device="cuda")}
    # the pooled embeds in the compute dtype, the time ids in fp32, as the
    # pipeline passes them
    cast = lambda d, dt: None if d is None else dict(  # noqa: E731
        d, text_embeds=d["text_embeds"].to(dt))
    with torch.inference_mode():
        kern = unet(x.to(dtype), t, ctx.to(dtype), cast(added, dtype)).float()
        routed = unet_module.attention
        unet_module.attention = attention_plain
        try:
            plain = unet(x.to(dtype), t, ctx.to(dtype), cast(added, dtype)).float()
            ref = copy.deepcopy(unet).float()(x, t, ctx, added).float()
        finally:
            unet_module.attention = routed
    err_kernel, err_plain = _rel_err(kern, ref), _rel_err(plain, ref)
    print(json.dumps({
        "unet_bf16": f"full-width {model.model_type} UNet, B=2, {hw}x{hw} latents, t=500",
        "dtype": str(dtype), "ref_std": ref.std().item(),
        "kernels_vs_fp32": err_kernel, "plain_vs_fp32": err_plain,
        "kernels_vs_plain": _rel_err(kern, plain),
        "limit": f"kernels_vs_fp32 <= {UNET_SLACK} * plain_vs_fp32"}), flush=True)
    if not (torch.isfinite(kern).all() and err_kernel <= UNET_SLACK * err_plain):
        raise AssertionError(f"bf16 UNet through the kernels: {err_kernel} from "
                             f"fp32, the plain path {err_plain}")
    del ref
    torch.cuda.empty_cache()


def _kernel_group(name: str) -> str:
    low = name.lower()
    for key in ("flash_fwd", "flash_stream", "flash_bwd_dkv", "flash_bwd_dq"):
        if key in low:
            return key
    if any(s in low for s in ("conv", "fprop", "dgrad", "implicit", "cudnn")):
        return "convolution"
    # nvjet: cuBLAS's Hopper GEMM kernels; RowwiseMoments: group norm's
    # statistics pass
    if any(s in low for s in ("gemm", "cublas", "cutlass", "xmma", "nvjet")):
        return "gemm"
    if "norm" in low or "moments" in low:
        return "normalization"
    return "elementwise and other"


def _profile(label, fn):
    """Device time by kernel group over one call of `fn` under
    torch.profiler, and the device's busy share of the call's wall time (the
    profiler's own host cost lowers that share a little).  Only the device's
    activity is traced: the host's events of a whole request took tens of
    seconds to read back, for numbers no phase reads."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, groups, by_name, annotations = [], {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        # a record_function span (the port's ``trace``) also shows as a device
        # range: it is no kernel, and it would cover the kernels it spans
        if getattr(e, "is_user_annotation", False):
            annotations += 1
            continue
        dur = e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):  # union of the device intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {
        "profile": label,
        "wall_ms_profiled": wall_ms, "device_kernel_ms": sum(groups.values()),
        "device_kernels": len(spans), "device_annotations_skipped": annotations,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:90], ms] for n, ms in top],
    }
    print(json.dumps(row), flush=True)
    return row


def phase_profile(model, pipe):
    """Where the time goes in one batch-1 request."""
    _profile("one batch-1 request, 512x512, 20 DDIM steps, CFG 7.5",
             lambda: pipe(model, prompt="a photograph of an astronaut riding a horse",
                          seed=0, height=512, width=512, num_inference_steps=20,
                          guidance_scale=7.5))


def _train_counters():
    from stablediffusion_tpu_torch.ops.attention import (
        FLASH_BWD_DKV_LAUNCHES,
        FLASH_BWD_DQ_LAUNCHES,
        FLASH_FWD_LAUNCHES,
    )
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES

    return {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES,
            "flash_bwd_dq": FLASH_BWD_DQ_LAUNCHES, "flash_bwd_dkv": FLASH_BWD_DKV_LAUNCHES}


def _fwd_split(count, by_shape):
    """flash_fwd launches by kind: with lse (under grad), causal without."""
    with_lse = sum(n for key, n in by_shape.items() if key[4])
    causal = sum(n for key, n in by_shape.items() if key[3] and not key[4])
    return {"with_lse": with_lse, "causal_no_lse": causal,
            "other": count - with_lse - causal}


def phase_train():
    """The training main path: make_train_step on the full-width SD1.5
    model at 512x512, batch 8, rank-16 LoRA on the UNet's attention
    projections, Min-SNR 5, constant-LR AdamW, bf16 UNet, fp32 VAE; one warm
    step and TRAIN_STEPS timed ones.  Launch counts per step are exact."""
    import torch

    from stablediffusion_tpu_torch.core.config import (
        SD15_TEXT_ENCODER,
        SD15_UNET,
        SD15_VAE,
        SchedulerConfig,
    )
    from stablediffusion_tpu_torch.lora.core import UNET_TARGET_SUFFIXES, init_lora
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.optim import make_lr_schedule, make_optimizer
    from stablediffusion_tpu_torch.train.train_step import TrainStatics, make_train_step
    from stablediffusion_tpu_torch.utils.testing import random_full_model, random_train_batch

    model = random_full_model("sd15", device="cuda", seed=1)
    model.vae.float()  # the trainers encode in fp32
    frozen = {"unet": model.unet, "vae": model.vae, "text_encoder": model.text_encoder}
    g = torch.Generator(device="cuda").manual_seed(2)
    lora = {"unet": init_lora(model.unet, 16, UNET_TARGET_SUFFIXES, g, store_alpha=False)}
    statics = TrainStatics(
        unet_config=SD15_UNET, vae_config=SD15_VAE, text_config=SD15_TEXT_ENCODER,
        text_config_2=None, scheduler_config=SchedulerConfig(),
        train_text_encoder=False, snr_gamma=5.0, compute_dtype=torch.bfloat16,
    )
    opt = make_optimizer(make_lr_schedule("constant", 1e-4))
    opt_state = opt.init(lora)
    step = make_train_step(statics, DDPMScheduler(statics.scheduler_config), opt)
    batch = random_train_batch(TRAIN_BATCH, 512, g)

    n_tf, _ = _count_blocks(model)
    n_clip = SD15_TEXT_ENCODER.num_hidden_layers
    want = {"flash_fwd": {"with_lse": 2 * n_tf, "causal_no_lse": n_clip, "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf, "flash_bwd_dkv": 2 * n_tf}
    counters = _train_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(1 + TRAIN_STEPS):
        snap = {n: (c.count, dict(c.by_shape)) for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        lora, opt_state, m = step(lora, opt_state, frozen, batch, g)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count - snap[n][0] for n, c in counters.items()}
        fwd = counters["flash_fwd"]
        now, prev = _fwd_split(fwd.count, fwd.by_shape), _fwd_split(*snap["flash_fwd"])
        got["flash_fwd"] = {k: now[k] - prev[k] for k in now}
        row = {"train_step": i, "warm": i == 0, "wall_s": wall, "loss": loss,
               "grad_norm": gnorm, "launches": got}
        print(json.dumps(row), flush=True)
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"train step {i}: loss {loss}, grad norm {gnorm}")
        if got != want:
            raise AssertionError(f"train step {i}: launches {got} != expected {want}")
        if i == 0:
            # from zero, AdamW moves an element by about lr exactly where its
            # gradient is non-zero: a zero `up` after step 1 had no gradient
            dead = [p for p, f in lora["unet"].items() if not f["up"].abs().max().item() > 0]
            if dead:
                raise AssertionError(f"{len(dead)} LoRA up factors got no gradient: {dead[:3]}")
        else:
            walls.append(wall)
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    if min(totals.values()) == 0:
        raise AssertionError(f"a kernel of the train path never launched: {totals}")
    best = min(walls)
    summary = {
        "train": "SD1.5 512x512 LoRA r16 on to_q/to_k/to_v/to_out.0, Min-SNR 5, "
                 "AdamW constant 1e-4, bf16 UNet, fp32 VAE encode",
        "batch": TRAIN_BATCH, "remat_policy": statics.remat_policy,
        "step_wall_s": walls, "best_step_s": best, "images_per_s": TRAIN_BATCH / best,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want, "launches_total": totals,
        "lora_params": sum(t.numel() for f in lora["unet"].values() for t in f.values()),
    }
    print(json.dumps(summary), flush=True)
    _profile(f"one train step, SD1.5 512x512, batch {TRAIN_BATCH}",
             lambda: step(lora, opt_state, frozen, batch, g)[2]["loss"].item())
    return totals, by_shape, summary


def _train_bwd_cases(by_shape):
    """(B, Sq, H, D, Skv, causal, dtype) of every backward launch of the
    train path, each also in the other dtype, CLIP's causal shape at B=8,
    and a ragged Sq (the SD3 joint stream at 512^2)."""
    import torch

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = set()
    for (qs, skv, dtype, causal, _lse) in by_shape["flash_bwd_dkv"]:
        for d in dtypes:
            cases.add((*qs, skv, causal, d))
    for d in dtypes:
        cases.add((8, 77, 12, 64, 77, True, d))
        cases.add((2, 1101, 8, 64, 1101, False, d))
    return [(*c[:6], dtypes[c[6]]) for c in sorted(cases)]


def bwd_case(B, Sq, H, D, Skv, causal, dtype, launches, teeth):
    """Both backward kernels and the forward's lse at one shape against
    their plain versions evaluated in fp32 on the same inputs (bf16:
    ``attention_bwd_rounded``, which rounds p and ds to bf16 where the
    kernels and the JAX library do, under ``GRAD_TOL`` plus its flip term;
    fp32: ``flash_bwd_plain`` under ``GRAD_TOL``); times of each kernel, of
    the plain backward, and of SDPA's backward (autograd of
    F.scaled_dot_product_attention minus its forward), beside each kernel's
    bound.  With `teeth`, wrong backwards must break the rule: in bf16 four
    (``attention_bwd_wrong_variants``), in fp32 two whose products are not
    fp32-accurate (``tf32_bwd_wrong_variants``, with the same mask)."""
    import torch
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops.attention import (
        _launch_fwd,
        _row_dot,
        attention_plain_lse,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_plain,
    )
    from stablediffusion_tpu_torch.utils.testing import (
        attention_bwd_rounded,
        attention_bwd_wrong_variants,
        grad_error,
        kernel_error,
        tf32_bwd_wrong_variants,
    )

    g = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", dtype=dtype, generator=g)
               for S in (Sq, Skv, Skv))
    do = torch.randn(B, Sq, H, D, device="cuda", dtype=dtype, generator=g)
    scale = D**-0.5
    rounded = dtype == torch.bfloat16
    with torch.no_grad():
        out, lse = _launch_fwd(q, k, v, scale, causal, with_lse=True)
        di = _row_dot(out, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, scale, causal)
        dq = flash_bwd_dq(q, k, v, do, lse, di, scale, causal)
        torch.cuda.synchronize()
        lse_err = kernel_error(lse, attention_plain_lse(
            q.float(), k.float(), v.float(), causal=causal)[1])
        if rounded:
            refs, flips = attention_bwd_rounded(q, k, v, out, do, lse, scale, causal)
        else:
            refs = flash_bwd_plain(*(t.float() for t in (q, k, v, out, do)), lse, scale, causal)
            flips = (None,) * 3
        errs = {n: grad_error(t, r, f)
                for n, t, r, f in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, flips)}
        rejected = None
        if teeth:
            # the rule's teeth: wrong backwards, each in the kernels' output
            # dtype, must fail it
            wrong_fn = attention_bwd_wrong_variants if rounded else tf32_bwd_wrong_variants
            rejected = {
                name: max(grad_error(w, r, f)["worst_over_limit"]
                          for w, r, f in zip(wrong, refs, flips))
                for name, wrong in wrong_fn(q, k, v, out, do, lse, scale, causal).items()}
        del refs, flips
        torch.cuda.empty_cache()
        fwd_lse_ms = _device_ms(lambda: _launch_fwd(q, k, v, scale, causal, with_lse=True),
                                "flash_fwd", 5)
        dkv_ms = _device_ms_spread(lambda: flash_bwd_dkv(q, k, v, do, lse, di, scale, causal),
                                   "flash_bwd_dkv", BWD_TIMED_LAUNCHES)
        dq_ms = _device_ms_spread(lambda: flash_bwd_dq(q, k, v, do, lse, di, scale, causal),
                                  "flash_bwd_dq", BWD_TIMED_LAUNCHES)
        plain_ms = _time_ms(lambda: flash_bwd_plain(q, k, v, out, do, lse, scale, causal), 3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
    fwd_ms = _time_ms(sdpa, 10)
    fwd_bwd_ms = _time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), 10)
    dname = str(dtype).replace("torch.", "")
    rows = []
    for name, spread, outs in (("flash_bwd_dkv", dkv_ms, ("dk", "dv")),
                               ("flash_bwd_dq", dq_ms, ("dq",))):
        bound_ms, bound_by, terms = _bwd_bound(name, B, Sq, H, D, Skv, causal, dname,
                                               q.element_size())
        row = dict(kernel=name, shape=[B, Sq, H, D], skv=Skv, dtype=dname, causal=causal,
                   launches=launches,
                   max_abs_err=max(errs[o]["max_abs_err"] for o in outs),
                   worst_over_limit=max(errs[o]["worst_over_limit"] for o in outs),
                   typical_abs_ref=min(errs[o]["typical_abs_ref"] for o in outs),
                   atol=min(errs[o]["atol"] for o in outs), rtol=errs[outs[0]]["rtol"],
                   ref="attention_bwd_rounded" if rounded else "flash_bwd_plain",
                   lse_worst_over_limit=lse_err["worst_over_limit"], fwd_lse_ms=fwd_lse_ms,
                   kernel_ms=spread["median"], kernel_ms_min=spread["min"],
                   kernel_ms_max=spread["max"], kernel_ms_launches=spread["n"],
                   plain_ms=plain_ms, library_ms=fwd_bwd_ms - fwd_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms_ms=terms)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if rejected is not None:
        what = ("wrong bf16 backwards against attention_bwd_rounded" if rounded else
                "fp32 backwards whose products are not fp32-accurate against flash_bwd_plain")
        print(json.dumps({"grad_rule_teeth": what, "shape": [B, Sq, H, D], "skv": Skv,
                          "dtype": dname, "causal": causal, "worst_over_limit": rejected}),
              flush=True)
        if not min(rejected.values()) > 1.0:
            raise AssertionError(f"the {dname} gradient rule accepts a wrong backward: {rejected}")
    bad = [r for r in rows if not (r["worst_over_limit"] <= 1.0 and r["lse_worst_over_limit"] <= 1.0)]
    if bad:
        raise AssertionError(f"backward kernels outside the rule: {bad}")
    del q, k, v, do, out, lse, di, dq, dk, dv, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_train_kernels(by_shape):
    """The forwards at every shape the train path launched (phase 3's
    check and times; under grad flash_fwd also writes the lse, which
    bwd_case times), then the backward cases."""
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import flash_stream, flash_stream_plain

    fns = {"flash_fwd": (flash_fwd, attention_plain),
           "flash_stream": (flash_stream, flash_stream_plain)}
    rows = []
    for name, fn in fns.items():
        for (qs, skv, dname, causal, _lse), n in sorted(by_shape[name].items()):
            row = kernel_case(name, *fn, *qs, skv, getattr(torch, dname), causal, n, 0)
            rows.append(dict(row, path="train"))
    for (B, Sq, H, D, Skv, causal, dtype) in _train_bwd_cases(by_shape):
        dname = str(dtype).replace("torch.", "")
        key = ((B, Sq, H, D), Skv, dname, causal, False)
        teeth = (B, Sq, H, D, Skv, dname) in BWD_TEETH_CASES
        rows += bwd_case(B, Sq, H, D, Skv, causal, dtype,
                         by_shape["flash_bwd_dkv"].get(key, 0), teeth)
    launched = {n: sum(r["launches"] for r in rows if r["kernel"] == n)
                for n in ("flash_fwd", "flash_stream", "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"train path: {len(rows)} kernel rows; the path's launches summed over "
          f"them: {launched}", flush=True)
    return rows


def phase_train_reference():
    """Narrow SD1.5-layout model, card (kernels) against CPU (plain
    attention), fp32, the same weights, LoRA, batch and draws: loss and
    every LoRA gradient of one loss_fn + backward."""
    import dataclasses

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.core.config import (
        SD15_TEXT_ENCODER,
        SD15_UNET,
        SchedulerConfig,
        VAEConfig,
    )
    from stablediffusion_tpu_torch.lora.core import UNET_TARGET_SUFFIXES, init_lora
    from stablediffusion_tpu_torch.schedulers import DDPMScheduler
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.train.train_step import TrainStatics, loss_fn
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        SD15_UNET, sample_size=16, block_out_channels=(320, 640),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        layers_per_block=1,
    )
    vcfg = VAEConfig(block_out_channels=(64, 192), layers_per_block=1)
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    cpu = random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device="cpu",
                       dtype=torch.float32, seed=3)
    statics = TrainStatics(
        unet_config=ucfg, vae_config=vcfg, text_config=tcfg, text_config_2=None,
        scheduler_config=SchedulerConfig(), train_text_encoder=False, snr_gamma=5.0,
        compute_dtype=torch.float32,
    )
    r = np.random.default_rng(11)
    batch = {"pixel_values": torch.from_numpy(r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(r.integers(0, 49407, (2, 77)))}
    draws = {"latent_eps": torch.from_numpy(r.standard_normal((2, 4, 16, 16)).astype(np.float32)),
             "noise": torch.from_numpy(r.standard_normal((2, 4, 16, 16)).astype(np.float32)),
             "timesteps": torch.from_numpy(np.array([17, 630]))}
    lora = init_lora(cpu.unet, 4, UNET_TARGET_SUFFIXES, torch.Generator().manual_seed(5),
                     store_alpha=False)
    for f in lora.values():  # non-zero up: zeros give zero down gradients
        f["up"] = torch.from_numpy(r.standard_normal(tuple(f["up"].shape)).astype(np.float32) * 0.05)
    counters = _train_counters()
    results = {}
    for dev in ("cpu", "cuda"):
        mods = {"unet": cpu.unet, "vae": cpu.vae, "text_encoder": cpu.text_encoder}
        if dev == "cuda":
            mods = {n: copy.deepcopy(m).cuda() for n, m in mods.items()}
        trainable = {"unet": {p: {n: t.to(dev) for n, t in f.items()} for p, f in lora.items()}}
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(trainable)]
        before = {n: c.count for n, c in counters.items()}
        loss = loss_fn(trainable, mods, batch, None, statics, DDPMScheduler(), draws=draws)
        grads = torch.autograd.grad(loss, leaves)
        results[dev] = [loss.detach().cpu()] + [gr.cpu() for gr in grads]
        launched = {n: c.count - before[n] for n, c in counters.items()}
        if dev == "cuda" and min(launched.values()) == 0:
            raise AssertionError(f"train reference on the card skipped a kernel: {launched}")
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(results["cuda"], results["cpu"]))
    print(json.dumps({"train_reference": "narrow SD1.5 layout, loss and LoRA gradients, "
                      "card vs CPU, fp32", "loss_cpu": results["cpu"][0].item(),
                      "loss_cuda": results["cuda"][0].item(), "tensors": len(results["cpu"]),
                      "worst_rel_err": worst, "tol": TRAIN_REF_TOL}), flush=True)
    if not worst <= TRAIN_REF_TOL:
        raise AssertionError(f"train step on the card disagrees with the CPU: {worst}")


# -- the trainer slice ---------------------------------------------------------

TRAIN_SDXL_BATCH = 2
TRAIN_SDXL_STEPS = 4  # one warm step and three timed ones
TRAIN_PROMPT = "a photograph of an astronaut riding a horse"
# phase 25: 4 steps straight against 2 + a resume for 2 more, each factor
# relative to its largest element.  The kernels use no atomics and the
# frozen UNet computes no weight gradient, but cuBLAS and cuDNN pick their
# algorithms per call, and a last-bit difference in a moment can flip one
# 8-bit code (an update apart by up to 2/127 of its size, ~lr / 64)
RESUME_TOL = 1e-3


def _clone_tree(tree):
    """A copy of a nested dict of tensors."""
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


class _TrainProbe:
    """Wraps a trainer's step, its separate encode (cache_latents) and its
    validation render (``module``: the trainer's module; ``encode``: the
    name of its encode factory; ``trainer``: the class whose
    ``_log_validation`` is wrapped, or None), for the duration of a
    ``with`` block: each data step (its encode included) records its wall,
    loss, grad norm and launches by kernel and call shape (over
    ``counters``, by default ``_train_counters()``), each validation render
    its launches; the first step keeps a copy of the initial trainable
    tree, the last its arguments (for a profiled step after the run);
    ``after_step(trainable)`` runs after each step."""

    def __init__(self, module="stablediffusion_tpu_torch.train.trainer",
                 encode="make_encode_fn", trainer="SDLoRATrainer", counters=None,
                 after_step=None):
        self.steps, self.validations = [], []
        self.initial, self.last_call = None, None
        self._encode = None
        self._names = (module, encode, trainer)
        self.counters = counters or _train_counters()
        self.after_step = after_step

    def _snap(self):
        return {n: (c.count, dict(c.by_shape)) for n, c in self.counters.items()}

    def _delta(self, snap):
        out = {}
        for n, c in self.counters.items():
            count, shapes = snap[n]
            by = {k: v - shapes.get(k, 0) for k, v in c.by_shape.items()
                  if v != shapes.get(k, 0)}
            out[n] = (c.count - count, by)
        return out

    def __enter__(self):
        import importlib

        import torch

        module, encode_name, trainer_name = self._names
        mod = importlib.import_module(module)
        trainer_cls = getattr(mod, trainer_name) if trainer_name else None
        self._mod, self._trainer_cls = mod, trainer_cls
        self._orig = (mod.make_train_step, getattr(mod, encode_name) if encode_name else None,
                      trainer_cls._log_validation if trainer_cls else None)
        probe = self

        def make_encode_fn(statics):
            encode = probe._orig[1](statics)

            def timed(*args, **kw):
                snap = probe._snap()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = encode(*args, **kw)
                torch.cuda.synchronize()
                probe._encode = (snap, time.perf_counter() - t)
                return out

            return timed

        def make_train_step(statics, scheduler, optimizer, **kw):
            step = probe._orig[0](statics, scheduler, optimizer, **kw)

            def timed(trainable, opt_state, frozen, batch, generator, draws=None):
                if probe.initial is None:
                    probe.initial = _clone_tree(trainable)
                snap, encode_s = probe._encode or (probe._snap(), 0.0)
                probe._encode = None
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(trainable, opt_state, frozen, batch, generator, draws)
                loss, gnorm = out[2]["loss"].item(), out[2]["grad_norm"].item()
                torch.cuda.synchronize()
                probe.steps.append({"wall_s": time.perf_counter() - t + encode_s,
                                    "encode_s": encode_s, "loss": loss, "grad_norm": gnorm,
                                    "launches": probe._delta(snap)})
                probe.last_call = (step, trainable, opt_state, frozen, batch, generator)
                if probe.after_step is not None:
                    probe.after_step(out[0])
                return out

            return timed

        def log_validation(trainer, lora, epoch, step):
            snap = probe._snap()
            probe._orig[2](trainer, lora, epoch, step)
            probe.validations.append(probe._delta(snap))

        mod.make_train_step = make_train_step
        if encode_name:
            setattr(mod, encode_name, make_encode_fn)
        if trainer_cls is not None:
            trainer_cls._log_validation = log_validation
        return self

    def __exit__(self, *exc):
        m, (_, encode_name, _) = self._mod, self._names
        m.make_train_step = self._orig[0]
        if encode_name:
            setattr(m, encode_name, self._orig[1])
        if self._trainer_cls is not None:
            self._trainer_cls._log_validation = self._orig[2]


def _step_launches(delta):
    """{kernel: count} of one step's launch delta, flash_fwd split by kind."""
    got = {n: count for n, (count, _) in delta.items()}
    got["flash_fwd"] = _fwd_split(*delta["flash_fwd"])
    return got


def _shape_rows(delta):
    return [[n, list(qs), skv, dt, causal, lse, k]
            for n, (_, by) in sorted(delta.items())
            for (qs, skv, dt, causal, lse), k in sorted(by.items())]


def _check_steps(label, probe, want):
    """Print each step and hold its launches to `want`."""
    import math

    for i, s in enumerate(probe.steps):
        got = _step_launches(s["launches"])
        print(json.dumps({label: i, "wall_s": s["wall_s"], "encode_s": s["encode_s"],
                          "loss": s["loss"], "grad_norm": s["grad_norm"], "launches": got,
                          "by_shape": _shape_rows(s["launches"])}), flush=True)
        if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                and s["grad_norm"] > 0):
            raise AssertionError(f"{label} step {i}: loss {s['loss']}, grad norm "
                                 f"{s['grad_norm']}")
        if got != want:
            raise AssertionError(f"{label} step {i}: launches {got} != expected {want}")


def phase_train_sdxl(smi):
    """The trainer's main path: ``SDLoRATrainer.train()`` on the full-width
    SDXL model at 1024², batch 2, rank 16 on the UNet's attention
    projections and both towers' q/k/v/out_proj (train_text_encoder, the
    JAX trainer's default), Min-SNR 5, constant LR, 4 steps, a checkpoint
    every 2, a 4-step validation render each epoch; then the saved file
    served through ``load_loras`` in one 1024² request.  Exact launches
    per step, per render and for the request."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.lora.formats import load_lora_file
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_train_sdxl_")
    model = random_full_model("sdxl", device="cuda", seed=7)
    data = write_image_folder(os.path.join(root, "data"), 2 * TRAIN_SDXL_BATCH, SDXL_RES,
                              seed=3, caption=TRAIN_PROMPT)
    args = SDTrainingArgs(
        train_batch_size=TRAIN_SDXL_BATCH, rank=16, train_text_encoder=True, snr_gamma=5.0,
        learning_rate=1e-4, lr_scheduler="constant", lr_warmup_steps=0,
        max_train_steps=TRAIN_SDXL_STEPS, log_every=1, checkpointing_steps=2,
        validation_prompt=TRAIN_PROMPT, num_validation_images=1, validation_inference_steps=4,
        report_to=None, resolution=SDXL_RES, output_dir=os.path.join(root, "out"))
    n_tf = _n_tf(model.unet)
    l1 = model.text_encoder_config.num_hidden_layers
    l2 = model.text_encoder_2_config.num_hidden_layers
    # every attention under grad writes its lse; SDXL reads CLIP-L's
    # penultimate states, so its last layer's attention gets no backward
    want = {"flash_fwd": {"with_lse": 2 * n_tf + l1 + l2, "causal_no_lse": 0, "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf + l1 - 1 + l2,
            "flash_bwd_dkv": 2 * n_tf + l1 - 1 + l2}
    counters = _train_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with _TrainProbe() as probe:
        trainer = SDLoRATrainer(model, args, data)
        lora = trainer.train()
    train_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    _check_steps("train_sdxl_step", probe, want)
    want_render = _want(model, args.validation_inference_steps, 1)
    for v in probe.validations:
        got = {n: v[n][0] for n in want_render}
        print(json.dumps({"train_sdxl_validation_launches": got, "expected": want_render}),
              flush=True)
        if got != want_render or v["flash_bwd_dq"][0] or v["flash_bwd_dkv"][0]:
            raise AssertionError(f"validation render launches {got} != {want_render}")
    if len(probe.validations) != TRAIN_SDXL_STEPS // 2:
        raise AssertionError(f"{len(probe.validations)} validation renders, not 2")
    if sorted(os.listdir(args.output_dir)) != ["checkpoint-2", "checkpoint-4",
                                                 "pytorch_lora_weights.safetensors"]:
        raise AssertionError(f"output dir holds {sorted(os.listdir(args.output_dir))}")

    # every factor moved but the four `up`s of CLIP-L's last layer, which
    # SDXL never reads (zero gradient, zero start, decay of zero)
    path = os.path.join(args.output_dir, "pytorch_lora_weights.safetensors")
    saved = load_lora_file(path, model.lora_module_paths())
    last = f"text_model.encoder.layers.{l1 - 1}.self_attn."
    exempt = sorted(f"text_encoder.{last}{p}.up" for p in ("q_proj", "k_proj", "v_proj",
                                                               "out_proj"))
    still = sorted(f"{c}.{p}.{k}" for c, tree in saved.items() for p, f in tree.items()
                   for k in ("down", "up")
                   if torch.equal(f[k], probe.initial[c][p][k].cpu()))
    for c, tree in lora.items():
        for p, f in tree.items():
            for k in ("down", "up"):
                if not torch.equal(saved[c][p][k], f[k].cpu()):
                    raise AssertionError(f"saved {c}.{p}.{k} differs from the trainer's")
    print(json.dumps({"train_sdxl_unmoved_factors": still, "exempt": exempt}), flush=True)
    if still != exempt:
        raise AssertionError(f"unmoved factors {still} != the exempt {exempt}")

    walls = [s["wall_s"] for s in probe.steps[1:]]
    summary = {
        "train_sdxl": "SDLoRATrainer SDXL 1024x1024, LoRA r16 on the UNet's to_q/k/v/out.0 "
                      "and both towers' q/k/v/out_proj, Min-SNR 5, AdamW constant 1e-4, bf16 "
                      "UNet, fp32 towers and VAE encode, no remat",
        "card": smi, "batch": TRAIN_SDXL_BATCH, "remat_policy": "none",
        "step_wall_s": [s["wall_s"] for s in probe.steps],
        "timed_steps_images_per_s": TRAIN_SDXL_BATCH * len(walls) / sum(walls),
        "train_call_s": train_s, "peak_memory_gib": peak,
        "launches_per_step": want, "launches_total": totals,
        "lora_params": {c: sum(t.numel() for f in tree.values() for t in f.values())
                        for c, tree in lora.items()},
    }
    print(json.dumps(summary), flush=True)
    step, *call = probe.last_call
    _profile(f"one SDXL train step, 1024x1024, batch {TRAIN_SDXL_BATCH}, text-encoder LoRA",
             lambda: step(*call)[2]["loss"].item())
    del call, probe

    # the trained file served as a request's LoRA is: `load_loras` reads
    # {lora_dir}/{model_type}_{name}.safetensors and fuses it
    lora_dir = os.path.join(root, "loras")
    os.makedirs(lora_dir)
    shutil.copy(path, os.path.join(lora_dir, "sdxl_trained.safetensors"))
    model.load_loras({"trained": 1.0}, lora_dir=lora_dir)
    for c in counters.values():
        c.reset()
    pipe = StableDiffusionUnifiedPipeline(device="cuda")
    t = time.perf_counter()
    out = pipe(model, prompt=TRAIN_PROMPT, seed=0, height=SDXL_RES, width=SDXL_RES,
               num_inference_steps=SDXL_STEPS, guidance_scale=7.5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = {n: counters[n].count for n in ("flash_fwd", "flash_stream")}
    want_req = _want(model, SDXL_STEPS, 1)
    im = out.images
    print(json.dumps({"train_sdxl_served": "the trained LoRA file, one 1024x1024 request",
                      "wall_s": wall, "launches": got, "expected_launches": want_req,
                      "shape": list(im.shape), "mean": float(im.mean())}), flush=True)
    if got != want_req or not np.isfinite(im).all() or im.shape != (1, SDXL_RES, SDXL_RES, 3):
        raise AssertionError(f"serving the trained LoRA: launches {got}, shape {im.shape}")
    model.delete_adapters()
    del model, pipe, trainer, lora, saved
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals, by_shape, summary


def phase_train_kernels_at(by_shape, path, checked):
    """Phase 8 for `path`: each forward at every shape and dtype it
    launched (phase 3's rule and times; under grad the launch also writes
    the lse, which ``bwd_case`` times), and both backward kernels at every
    shape and dtype it launched (``bwd_case``: the rule, the forward's lse,
    plain and SDPA times, the bounds), skipping the (kernel, shape, Skv,
    causal, dtype) in `checked`, to which it adds its own."""
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import flash_stream, flash_stream_plain

    fns = {"flash_fwd": (flash_fwd, attention_plain),
           "flash_stream": (flash_stream, flash_stream_plain)}
    rows = []
    for name, fn in fns.items():
        launched = {}  # with and without the lse: one case
        for (qs, skv, dname, causal, _lse), n in by_shape[name].items():
            launched[(qs, skv, dname, causal)] = launched.get((qs, skv, dname, causal), 0) + n
        for (qs, skv, dname, causal), n in sorted(launched.items()):
            if (name, *qs, skv, causal, dname) in checked:
                continue
            checked.add((name, *qs, skv, causal, dname))
            row = kernel_case(name, *fn, *qs, skv, getattr(torch, dname), causal, n, 0)
            rows.append(dict(row, path=path))
    for (qs, skv, dname, causal, _lse), n in sorted(by_shape["flash_bwd_dkv"].items()):
        if ("flash_bwd_dkv", *qs, skv, causal, dname) in checked:
            continue
        checked.update(((k, *qs, skv, causal, dname) for k in ("flash_bwd_dkv", "flash_bwd_dq")))
        teeth = (*qs, skv, dname) in BWD_TEETH_CASES
        rows += [dict(r, path=path) for r in
                 bwd_case(*qs, skv, causal, getattr(torch, dname), n, teeth)]
    print(json.dumps({"path_kernel_rows": path, "columns": [
        "kernel", "shape", "skv", "dtype", "causal", "launches", "kernel_ms", "fwd_lse_ms",
        "bound_ms", "plain_ms", "library_ms", "worst_over_limit"],
        "rows": [[r["kernel"], r["shape"], r["skv"], r["dtype"], r["causal"], r["launches"],
                  r["kernel_ms"], r.get("fwd_lse_ms"), r["bound_ms"], r["plain_ms"],
                  r["library_ms"], r["worst_over_limit"]] for r in rows]}), flush=True)
    return rows


def phase_train_variants(smi):
    """The SD1.5 trainer at 512², batch 2, rank 16 on the UNet, with the
    8-bit Adam, two-step bf16 accumulation, cache_latents and a kohya file:
    4 steps straight, against 2 steps and a resume from checkpoint-2 for 2
    more.  Exact launches per data step (the separate encode: CLIP
    without lse and flash_stream; the step: the UNet with lse and both
    backward kernels); the resumed factors within RESUME_TOL of the straight
    run's; the kohya file equal to the trainer's factors."""
    import shutil
    import tempfile

    import torch

    from stablediffusion_tpu_torch.lora.formats import load_lora_file
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_train_variants_")
    model = random_full_model("sd15", device="cuda", seed=8)
    model.vae.float()  # as load_sd_model holds it
    data = write_image_folder(os.path.join(root, "data"), 4, 512, seed=4, caption=TRAIN_PROMPT)
    n_tf = _n_tf(model.unet)
    l1 = model.text_encoder_config.num_hidden_layers
    want = {"flash_fwd": {"with_lse": 2 * n_tf, "causal_no_lse": l1, "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf, "flash_bwd_dkv": 2 * n_tf}

    def run(out, steps, **kw):
        args = SDTrainingArgs(
            train_batch_size=2, rank=16, train_text_encoder=False, snr_gamma=5.0,
            learning_rate=1e-4, lr_scheduler="constant", lr_warmup_steps=0, max_train_steps=steps,
            use_8bit_adam=True, gradient_accumulation_steps=2, accum_dtype="bf16",
            cache_latents=True, checkpointing_steps=2, lora_format="kohya", log_every=1,
            report_to=None, resolution=512, output_dir=os.path.join(root, out), **kw)
        with _TrainProbe() as probe:
            trainer = SDLoRATrainer(model, args, data)
            lora = trainer.train()
        _check_steps(f"train_variants_{out}_step", probe, want)
        return trainer, lora, probe

    counters = _train_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, straight, probe = run("straight", 4)
    straight_s = time.perf_counter() - t
    run("resumed", 2)
    trainer, resumed, _ = run("resumed", 4, resume_from_checkpoint="latest")
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    if [s for s, _ in trainer.history] != [3, 4]:
        raise AssertionError(f"resumed history {trainer.history}")
    worst, exact = 0.0, True
    for p, f in straight["unet"].items():
        for k in ("down", "up"):
            a, b = resumed["unet"][p][k], f[k]
            exact &= torch.equal(a, b)
            worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item())
    saved = load_lora_file(os.path.join(root, "straight", "pytorch_lora_weights.safetensors"),
                           model.lora_module_paths())["unet"]
    file_equal = all(torch.equal(saved[p][k], f[k].cpu())
                     for p, f in straight["unet"].items() for k in ("down", "up"))
    row = {"train_variants": "SD1.5 512x512 trainer, 8-bit Adam, accumulation 2 in bf16, "
                             "cache_latents, kohya file; straight 4 against 2 + resume 2",
           "card": smi, "straight_call_s": straight_s,
           "step_wall_s": [s["wall_s"] for s in probe.steps],
           "encode_s": [s["encode_s"] for s in probe.steps],
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "resumed_equal_bitwise": exact, "resumed_worst_rel_err": worst,
           "tol": RESUME_TOL, "kohya_file_equal": file_equal, "launches_total": totals}
    print(json.dumps(row), flush=True)
    if not worst <= RESUME_TOL:
        raise AssertionError(f"resumed run {worst} from the straight run")
    if not file_equal:
        raise AssertionError("the kohya file differs from the trainer's factors")
    del model, straight, resumed, trainer
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals, by_shape, row


# -- the serving slice ---------------------------------------------------------

SERVE_SCHEDULERS = ("DDIM", "euler_a", "DPM++ 2M Karras", "DPM++ 2M SDE Karras",
                    "uni_pc", "heun")
SERVE_STEPS = 20
SERVE_BURST = 4  # the worker's max_batch and the burst's size
# merged against solo, raw uint8 pixels: the kernels are batch-invariant
# (checked bit-exact below), but cuDNN's and cuBLAS's algorithms for the
# bf16 convolutions and GEMMs are chosen by batch size, so their rounding
# differs, and CFG 7.5 amplifies it through 20 steps; held at 16 levels
SERVE_MERGED_LEVELS = 16


def _post(port: int, body: dict, timeout: float = 900.0):
    """(HTTP status, JSON reply, wall seconds) of one POST to the worker."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t = time.perf_counter()
        conn.request("POST", "/", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        return resp.status, reply, time.perf_counter() - t
    finally:
        conn.close()


def _ask(port, counters, card, label, body, expect):
    """POST one request to the worker and count the launches it made.  With
    `expect` (launches by kernel) the reply must be one image of the
    request's size with its seed, and the launches exact; without, the
    reply is returned as it is (an error-channel request).  Returns (reply,
    its printed row)."""
    import numpy as np

    from stablediffusion_tpu_torch.serve.handler import decode_image_b64

    before = {n: c.count for n, c in counters.items()}
    status, reply, wall = _post(port, {"id": label, "input": body})
    got = {n: c.count - before[n] for n, c in counters.items()}
    row = {"serve_request": label, "status": status, "wall_s": wall,
           "launches": got, "expected_launches": expect,
           "seed": reply.get("seed"), "card": card}
    print(json.dumps(row), flush=True)
    if expect is not None:
        if status != 200 or "error" in reply:
            raise AssertionError(f"{label}: {reply.get('error')}\n"
                                 f"{reply.get('traceback')}")
        if reply["seed"] != body["seed"] or len(reply["images"]) != 1:
            raise AssertionError(f"{label}: seed {reply['seed']} or images wrong")
        px = decode_image_b64(reply["images"][0])
        if px.shape != (body["height"], body["width"], 3) or not np.isfinite(px).all():
            raise AssertionError(f"{label}: image {px.shape}")
        if got != expect:
            raise AssertionError(f"{label}: launches {got} != expected {expect}")
    return reply, row


BURST_WINDOW_MS = 2000.0  # the batcher's fixed window while a burst arrives


def _burst(server, port, counters, card, bodies, want_one):
    """Send `bodies` at once from threads; the batcher must merge them, each
    merged call launching `want_one`.  The burst runs under the batcher's
    fixed window of BURST_WINDOW_MS (``adaptive=False``, its deterministic
    mode): the adaptive window's grace floor of a few ms dispatches the
    first request alone whenever the host is slower than that to hand the
    batcher the second.  A gather still ends as soon as it holds the
    worker's max_batch.  Returns the replies (status, reply, wall) and the
    printed row."""
    import threading

    batcher = server.batcher
    merged_before = batcher.merged_calls
    before = {n: c.count for n, c in counters.items()}
    replies = [None] * len(bodies)

    def go(i):
        replies[i] = _post(port, {"id": f"burst-{i}", "input": bodies[i]})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
    window = batcher.adaptive, batcher.window_ms
    batcher.adaptive, batcher.window_ms = False, BURST_WINDOW_MS
    try:
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        burst_s = time.perf_counter() - t
    finally:
        batcher.adaptive, batcher.window_ms = window
    got = {n: c.count - before[n] for n, c in counters.items()}
    groups = server.batcher.merged_calls - merged_before
    sizes = sorted(r[1].get("batched", 0) for r in replies if r is not None)
    bad = [r for r in replies if r is None or r[0] != 200 or "error" in r[1]]
    if bad:
        raise AssertionError(f"burst: {bad}")
    # each merged call: one CLIP pass each way over the group, one UNet
    # evaluation per step, one decode launch for the group
    expect = {n: groups * v for n, v in want_one.items()}
    row = {"serve_burst": len(bodies), "merged_calls": groups,
           "batched_per_reply": sizes, "wall_s": burst_s,
           "images_per_s": len(bodies) / burst_s,
           "reply_walls_s": [r[2] for r in replies],
           "launches": got, "expected_launches": expect, "card": card}
    print(json.dumps(row), flush=True)
    if max(sizes) < 2:
        raise AssertionError(f"the batcher merged none of the burst: {sizes}")
    if got != expect:
        raise AssertionError(f"burst: launches {got} != expected {expect}")
    return replies, row


def _folder_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _save_and_serve(model, root, folder_name, flags, label, card):
    """Write `model` to ``root/folder_name`` with ``save_sd_model`` (an SD3
    model with ``save_sd3_model``), build
    the HTTP worker on it (``serve.worker`` with `flags`, the worker's own
    --model_name load onto the card) and hold every loaded tensor equal to
    the saved one.  Returns the server, not yet serving."""
    import os

    import torch

    from stablediffusion_tpu_torch.io.loader import save_sd3_model, save_sd_model
    from stablediffusion_tpu_torch.serve.worker import build, parse_args

    sd3 = model.model_type == "sd3"
    folder = os.path.join(root, folder_name)
    t = time.perf_counter()
    (save_sd3_model if sd3 else save_sd_model)(model, folder)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    server = build(parse_args(["--host", "127.0.0.1", "--port", "0", "--model_dir", root,
                               *flags]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    loaded = server.handler.model
    n_tensors = 0
    if sd3:
        comps = ("transformer", "vae", "text_encoder", "text_encoder_2") + (
            ("text_encoder_3",) if model.text_encoder_3 is not None else ())
    else:
        comps = ("unet", "vae", "text_encoder") + (
            ("text_encoder_2",) if model.is_sdxl else ())
    for comp in comps:
        a, b = getattr(model, comp).state_dict(), getattr(loaded, comp).state_dict()
        if a.keys() != b.keys():
            raise AssertionError(f"{comp}: loaded keys differ from the saved ones")
        for k in a:
            if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])):
                raise AssertionError(f"{comp}.{k}: loaded tensor differs from the saved one")
        n_tensors += len(a)
    print(json.dumps({"serve_folder": label, "model_type": loaded.model_type,
                      "bytes": _folder_bytes(folder), "tensors_equal": n_tensors,
                      "save_s": save_s, "load_s": load_s, "card": card}), flush=True)
    return server


def _plan_evals(probe, model, name, steps, strength=1.0):
    """UNet evaluations of a `steps`-step call under scheduler `name` at
    `strength`, from the scheduler's plan."""
    from stablediffusion_tpu_torch.schedulers import make_scheduler

    sched = make_scheduler(name, model.scheduler_config)
    return probe.get_timesteps(sched, steps, strength, None)[0].num_steps


def phase_serve(card: str):
    """Serving: a full-width SD1.5 folder written by ``save_sd_model``,
    loaded by the HTTP worker (``serve.worker``) on 127.0.0.1 and asked
    over loopback, with exact launch counts per request from the plans."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.models.vae import VAEAttention
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.serve.handler import decode_image_b64, encode_images_b64
    from stablediffusion_tpu_torch.utils.testing import (
        random_full_model,
        synthetic_clip_tokenizer,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    server = thread = None
    try:
        # 1. write the folder, 2. load it in the worker
        model = random_full_model("sd15", device="cuda", seed=4)
        model.tokenizer = synthetic_clip_tokenizer()
        server = _save_and_serve(
            model, root, "sd15_chip",
            ["--model_name", "chip", "--model_type", "sd15", "--max_batch", str(SERVE_BURST),
             "--batch_window_ms", "200"],
            "full-width SD1.5, random weights (seed 4), synthetic byte-level BPE", card)
        handler = server.handler
        loaded = handler.model
        del model
        torch.cuda.empty_cache()

        # 3. the worker in a thread
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]

        # the launches a request must make, from its plan: one CLIP encode
        # each for the prompts and the negatives, two attentions per
        # transformer block per UNet evaluation, one mid-block attention
        # per VAE encode and per decode tile
        n_clip = loaded.text_encoder_config.num_hidden_layers
        n_tf, n_dec = _count_blocks(loaded)
        n_enc = sum(isinstance(m, VAEAttention) for m in loaded.vae.encoder.modules())
        probe = StableDiffusionUnifiedPipeline(device="cuda")

        def evals(name, steps, strength=1.0):
            return _plan_evals(probe, loaded, name, steps, strength)

        def want(n_evals, streams):
            return {"flash_fwd": 2 * n_clip + 2 * n_tf * n_evals, "flash_stream": streams}

        counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
        for c in counters.values():
            c.reset()
        base = dict(prompt="a photograph of an astronaut riding a horse", height=512,
                    width=512, num_inference_steps=SERVE_STEPS, guidance_scale=7.5)
        mask = np.zeros((1, 512, 512, 3), np.uint8)
        mask[:, 128:384, 128:384] = 255
        mask_b64 = encode_images_b64(mask)[0]
        rows = []

        def ask(label, body, expect, batch1_txt2img=False):
            reply, row = _ask(port, counters, card, label, body, expect)
            rows.append(dict(row, batch1_txt2img=batch1_txt2img))
            return reply

        # 4. the requests
        first = None
        for k, name in enumerate(SERVE_SCHEDULERS):
            reply = ask(f"txt2img {name}", {**base, "seed": 100 + k,
                                            "model": {"scheduler": name}},
                        want(evals(name, SERVE_STEPS), n_dec), batch1_txt2img=True)
            first = first or reply
        ask("img2img strength 0.6", {**base, "seed": 7, "image": first["images"][0],
                                     "strength": 0.6, "model": {"scheduler": "DDIM"}},
            want(evals("DDIM", SERVE_STEPS, 0.6), n_enc + n_dec))
        ask("inpaint blend4 strength 1.0", {**base, "seed": 8, "image": first["images"][0],
                                            "mask_image": mask_b64, "strength": 1.0},
            want(evals("DDIM", SERVE_STEPS), n_enc + n_dec))
        # 768x768: 96x96 latents decode in 2x2 tiles of 64 (stride 48)
        tiles = (-(-96 // 48)) ** 2
        ask("txt2img 768x768 vae_tiling", {**base, "seed": 9, "height": 768, "width": 768,
                                           "num_inference_steps": 10, "vae_tiling": True},
            want(evals("DDIM", 10), tiles * n_dec))
        err = ask("a missing LoRA on the error channel",
                  {**base, "seed": 10, "model": {"loras": {"missing": 1.0}}}, None)
        if "error" not in err or "FileNotFoundError" not in err["error"]:
            raise AssertionError(f"missing LoRA request: {err}")

        # the burst: concurrent batchable requests the batcher merges
        prompts = ["a red bicycle by a canal", "a lighthouse at dusk",
                   "a bowl of ramen", "a snowy mountain village"]
        burst = [{**base, "prompt": p, "seed": 200 + i} for i, p in enumerate(prompts)]
        replies, _ = _burst(server, port, counters, card, burst,
                            want(evals("DDIM", SERVE_STEPS), n_dec))

        # solo against merged, and the same request twice alone
        solo = [ask(f"burst request 0 alone #{j}", {**burst[0]},
                    want(evals("DDIM", SERVE_STEPS), n_dec), batch1_txt2img=True)
                for j in range(2)]
        serve_launches = {n: c.count for n, c in counters.items()}
        serve_by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
        if min(serve_launches.values()) == 0:
            raise AssertionError(f"a kernel of the serving path never launched: {serve_launches}")
        if solo[0]["images"] != solo[1]["images"]:
            raise AssertionError("the same request twice gave different images")
        jpeg_diff = np.abs(decode_image_b64(solo[0]["images"][0])
                           - decode_image_b64(replies[0][1]["images"][0])) * 255
        walls = sorted(r["wall_s"] for r in rows if r["batch1_txt2img"])
        t = time.perf_counter()
        px = (decode_image_b64(solo[0]["images"][0]) * 255).round().astype(np.uint8)[None]
        for _ in range(10):
            encode_images_b64(px)
        jpeg_ms = (time.perf_counter() - t) / 10 * 1e3

        # the raw pixels of the same merged call and the solo one, through
        # the handler's own pipeline call, and the kernels' batch invariance
        merged_args = dict(base, prompt=prompts, negative_prompt=[""] * SERVE_BURST,
                           seed=[b["seed"] for b in burst])
        solo_args = dict(base, prompt=prompts[:1], negative_prompt=[""], seed=[burst[0]["seed"]])
        raw_merged = handler._generate(merged_args).images[0].astype(np.int16)
        raw_solo = handler._generate(solo_args).images[0].astype(np.int16)
        raw_diff = np.abs(raw_merged - raw_solo)
        _profile("the burst's merged call: 4 prompts (B=8 under CFG), 512x512, 20 DDIM "
                 "steps, CFG 7.5, uint8 out", lambda: handler._generate(merged_args))
        g = torch.Generator(device="cuda").manual_seed(6)
        q, k, v = (torch.randn(8, 4096, 8, 40, device="cuda", dtype=torch.bfloat16,
                               generator=g) for _ in range(3))
        kernel_invariant = torch.equal(flash_fwd(q, k, v)[2:4], flash_fwd(q[2:4], k[2:4], v[2:4]))
        summary = {
            "serve_summary": "HTTP over loopback, full-width SD1.5 512x512, CFG 7.5",
            "p50_wall_s_batch1_txt2img": walls[len(walls) // 2],
            "batch1_txt2img_walls_s": walls, "jpeg_encode_ms_512": jpeg_ms,
            "repeat_bit_identical": True, "merged_vs_solo_jpeg_max_levels": float(jpeg_diff.max()),
            "merged_vs_solo_raw_max_levels": int(raw_diff.max()),
            "merged_vs_solo_raw_mean_levels": float(raw_diff.mean()),
            "merged_vs_solo_limit_levels": SERVE_MERGED_LEVELS,
            "flash_fwd_batch_invariant_bitwise": kernel_invariant,
            "launches": serve_launches, "card": card}
        print(json.dumps(summary), flush=True)
        if not kernel_invariant:
            raise AssertionError("flash_fwd gives another result for a sample in a larger batch")
        if raw_diff.max() > SERVE_MERGED_LEVELS:
            raise AssertionError(f"merged and solo differ by {raw_diff.max()} levels")
        return serve_launches, serve_by_shape
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=30)
        shutil.rmtree(root, ignore_errors=True)


def phase_new_shapes(by_shape, checked, path):
    """Phase 3's check and times at every shape `path` launched that no
    earlier phase held (serving: 768x768, the merged burst's B=8 and B=4;
    SDXL: head dim 64 at 1024², the refiner's levels, bigG, the 16384-token
    decode and encode).  Adds the shapes it holds to `checked`."""
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd
    from stablediffusion_tpu_torch.ops.flash_attention import flash_stream, flash_stream_plain

    fns = {"flash_fwd": (flash_fwd, attention_plain),
           "flash_stream": (flash_stream, flash_stream_plain)}
    rows, seen = [], []
    for (name, B, Sq, H, D, Skv, causal) in _cases(by_shape, widen=False):
        if (name, B, Sq, H, D, Skv, causal) in checked:
            seen.append([name, B, Sq, H, D, Skv, causal])
            continue
        checked.add((name, B, Sq, H, D, Skv, causal))
        for dtype in (torch.bfloat16, torch.float32):
            key = ((B, Sq, H, D), Skv, str(dtype).replace("torch.", ""), causal, False)
            row = kernel_case(name, *fns[name], B, Sq, H, D, Skv, dtype, causal,
                              by_shape[name].get(key, 0), 0)
            rows.append(dict(row, path=path))
    print(json.dumps({f"{path}_shapes_held_by_earlier_phases": seen}), flush=True)
    return rows


def phase_inpaint_reference():
    """concat9 inpainting, card (kernels) against CPU (plain attention),
    fp32, on a narrow 9-channel model from the tiny configs at SD1.5 head
    dims (a VAE whose mid-block takes flash_stream), the same weights and
    the same injected draws, through a stochastic scheduler."""
    import dataclasses

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.core.config import (
        SD15_TEXT_ENCODER,
        tiny_unet_config,
        tiny_vae_config,
    )
    from stablediffusion_tpu_torch.models.wrapper import SDModel
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils.testing import bench_tokenizer, random_model

    ucfg = dataclasses.replace(
        tiny_unet_config(cross_attention_dim=768, in_channels=9),
        block_out_channels=(320, 640), num_attention_heads=8,
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"), norm_num_groups=32)
    vcfg = dataclasses.replace(tiny_vae_config(), block_out_channels=(64, 192))
    tcfg = dataclasses.replace(SD15_TEXT_ENCODER, num_hidden_layers=2)
    cpu = random_model(ucfg, vcfg, tcfg, bench_tokenizer(), device="cpu",
                       dtype=torch.float32, seed=5)
    gpu = SDModel(unet_config=ucfg, unet=copy.deepcopy(cpu.unet).cuda(), vae_config=vcfg,
                  vae=copy.deepcopy(cpu.vae).cuda(), text_encoder_config=tcfg,
                  text_encoder=copy.deepcopy(cpu.text_encoder).cuda(), tokenizer=cpu.tokenizer)
    r = np.random.default_rng(12)
    steps, hw = 4, 16
    draws = {"latents": r.standard_normal((1, hw, hw, 4)).astype(np.float32),
             "encode": r.standard_normal((1, hw, hw, 4)).astype(np.float32),
             "encode_masked": r.standard_normal((1, hw, hw, 4)).astype(np.float32),
             "steps": r.standard_normal((steps, 1, hw, hw, 4)).astype(np.float32)}
    image = r.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 8:24] = 1.0
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        model.set_scheduler("DPM++ 2M SDE Karras")
        pipe = StableDiffusionUnifiedPipeline(device=name, dtype=torch.float32)
        f0, s0 = FLASH_FWD_LAUNCHES.count, FLASH_STREAM_LAUNCHES.count
        outs[name] = pipe(model, prompt="a small red house", image=image, mask_image=mask,
                          num_inference_steps=steps, guidance_scale=7.5, seed=0,
                          draws=draws, output_type="np").images
        if name == "cuda" and (FLASH_FWD_LAUNCHES.count == f0
                               or FLASH_STREAM_LAUNCHES.count == s0):
            raise AssertionError("concat9 reference on the card launched no kernel")
    err = float(np.abs(outs["cpu"] - outs["cuda"]).max())
    print(json.dumps({"inpaint_reference": "concat9, narrow 9-channel SD1.5 layout, "
                      "DPM++ 2M SDE Karras, card vs CPU, fp32", "images_max_abs_err": err,
                      "tol": REF_TOL}), flush=True)
    if not err <= REF_TOL:
        raise AssertionError(f"concat9 on the card disagrees with the CPU: {err}")


# -- SDXL 1024² and the refiner ------------------------------------------------

SDXL_RES = 1024
SDXL_STEPS = 20
SDXL_REQUESTS = [
    dict(prompt="a photograph of an astronaut riding a horse", seed=0),
    dict(prompt="a watercolor painting of a fox in the snow", seed=1,
         prompt_2="soft morning light, fine detail", negative_prompt="blurry",
         negative_prompt_2="low quality, jpeg artifacts"),
    dict(prompt=["a red bicycle by a canal", "a lighthouse at dusk"], seed=2),
]
SDXL_REFINER_STRENGTH = 0.3
SDXL_BURST = 2  # the SDXL worker's max_batch and its burst's size


def phase_sdxl_reference():
    """The narrow SDXL-layout model (``_narrow_sdxl``), card (kernels)
    against CPU (plain attention), fp32, TF32 off, 4 DDIM steps from the
    same latents."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

    cpu = _narrow_sdxl(seed=7)
    gpu = _to_card(cpu)
    lat = np.random.default_rng(8).standard_normal((1, 16, 16, 4)).astype(np.float32)
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        pipe = StableDiffusionUnifiedPipeline(device=name, dtype=torch.float32)
        common = dict(prompt="a small red house", prompt_2="by the sea",
                      num_inference_steps=4, guidance_scale=7.5, latents=torch.from_numpy(lat))
        f0, s0 = FLASH_FWD_LAUNCHES.count, FLASH_STREAM_LAUNCHES.count
        latents = pipe(model, output_type="latents", **common).latents
        images = pipe(model, output_type="np", **common).images
        outs[name] = (latents.float().cpu().numpy(), images)
        if name == "cuda" and (FLASH_FWD_LAUNCHES.count == f0
                               or FLASH_STREAM_LAUNCHES.count == s0):
            raise AssertionError("SDXL reference run on the card launched no kernel")
    lat_err = float(np.abs(outs["cpu"][0] - outs["cuda"][0]).max())
    img_err = float(np.abs(outs["cpu"][1] - outs["cuda"][1]).max())
    print(json.dumps({"reference": "narrow SDXL layout (dual CLIP, linear projections, "
                      "text_time, head dim 64), card vs CPU, fp32",
                      "latents_max_abs_err": lat_err, "latents_max_abs_ref":
                      float(np.abs(outs["cpu"][0]).max()),
                      "images_max_abs_err": img_err, "tol": REF_TOL}), flush=True)
    if not (lat_err <= REF_TOL and img_err <= REF_TOL):
        raise AssertionError(f"SDXL: card disagrees with CPU: {lat_err}, {img_err}")


def phase_refiner(model, pipe, image):
    """The full-width SDXL refiner (random weights) refines a 1024² image:
    img2img at SDXL_REFINER_STRENGTH over SDXL_STEPS, ``use_refiner=True``,
    conditioned on bigG alone; exact launches: bigG each way, two attentions
    per refiner block per evaluation, the encode's and the decode's
    mid-block."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.utils.testing import random_refiner

    random_refiner(model, seed=1)
    model.set_scheduler("DDIM")
    n_evals = _plan_evals(pipe, model, "DDIM", SDXL_STEPS, SDXL_REFINER_STRENGTH)
    want = _want(model, n_evals, 2, refiner=True)
    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = pipe(model, prompt="a photograph of an astronaut riding a horse", image=image,
               strength=SDXL_REFINER_STRENGTH, num_inference_steps=SDXL_STEPS,
               guidance_scale=7.5, seed=3, use_refiner=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = {n: c.count for n, c in counters.items()}
    im = out.images
    print(json.dumps({"refiner": "full-width SDXL refiner, img2img 1024x1024, DDIM",
                      "strength": SDXL_REFINER_STRENGTH, "evaluations": n_evals,
                      "refiner_blocks": _n_tf(model.refiner), "wall_s": wall,
                      "launches": got, "expected_launches": want,
                      "shape": list(im.shape), "mean": float(im.mean())}), flush=True)
    if im.shape != (1, SDXL_RES, SDXL_RES, 3) or not np.isfinite(im).all():
        raise AssertionError(f"refiner output {im.shape}")
    if got != want:
        raise AssertionError(f"refiner: launch counts {got} != expected {want}")
    return got, {n: dict(c.by_shape) for n, c in counters.items()}


def phase_serve_sdxl(card: str):
    """Serving SDXL: a full-width SDXL folder written by ``save_sd_model``
    (synthetic byte-level BPE, bigG padding with "!" = 0) is loaded by the
    HTTP worker with no --model_type (the "sdxl" default) and asked over
    loopback at 1024²: txt2img under DDIM and DPM++ 2M Karras, img2img at
    0.6, blend4 inpainting at 1.0 and a burst of SDXL_BURST that the batcher
    merges, each with the launches its plan implies."""
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.serve.handler import encode_images_b64
    from stablediffusion_tpu_torch.utils.testing import (
        random_full_model,
        synthetic_clip_tokenizer,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_sdxl_")
    server = thread = None
    try:
        model = random_full_model("sdxl", device="cuda", seed=4)
        model.tokenizer = synthetic_clip_tokenizer()
        model.tokenizer_2 = synthetic_clip_tokenizer(pad_token_id=0)
        lora_dir = os.path.join(root, "loras")  # apart from the model dir
        os.makedirs(lora_dir)
        server = _save_and_serve(
            model, root, "sdxl_chip",
            ["--model_name", "chip", "--max_batch", str(SDXL_BURST), "--batch_window_ms",
             "200", "--lora_dir", lora_dir],
            "full-width SDXL, random weights (seed 4), synthetic byte-level BPE", card)
        loaded = server.handler.model
        if loaded.model_type != "sdxl" or loaded.tokenizer_2.pad_token_id != 0:
            raise AssertionError(f"the worker loaded {loaded.model_type}, "
                                 f"pad {loaded.tokenizer_2.pad_token_id}")
        del model
        torch.cuda.empty_cache()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        probe = StableDiffusionUnifiedPipeline(device="cuda")
        counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
        for c in counters.values():
            c.reset()

        def want(name, strength=1.0, streams=1):
            return _want(loaded, _plan_evals(probe, loaded, name, SDXL_STEPS, strength),
                         streams)

        base = dict(prompt="a photograph of an astronaut riding a horse", height=SDXL_RES,
                    width=SDXL_RES, num_inference_steps=SDXL_STEPS, guidance_scale=7.5)
        mask = np.zeros((1, SDXL_RES, SDXL_RES, 3), np.uint8)
        mask[:, 256:768, 256:768] = 255
        walls = []
        first, row = _ask(port, counters, card, "sdxl txt2img DDIM",
                          {**base, "seed": 100, "prompt_2": "fine detail",
                           "model": {"scheduler": "DDIM"}}, want("DDIM"))
        walls.append(row["wall_s"])
        _, row = _ask(port, counters, card, "sdxl txt2img DPM++ 2M Karras",
                      {**base, "seed": 101, "model": {"scheduler": "DPM++ 2M Karras"}},
                      want("DPM++ 2M Karras"))
        walls.append(row["wall_s"])
        _ask(port, counters, card, "sdxl img2img strength 0.6",
             {**base, "seed": 7, "image": first["images"][0], "strength": 0.6,
              "model": {"scheduler": "DDIM"}}, want("DDIM", 0.6, streams=2))
        _ask(port, counters, card, "sdxl inpaint blend4 strength 1.0",
             {**base, "seed": 8, "image": first["images"][0],
              "mask_image": encode_images_b64(mask)[0], "strength": 1.0},
             want("DDIM", streams=2))
        err, _ = _ask(port, counters, card, "sdxl use_refiner without a refiner",
                      {**base, "seed": 9, "params": {"use_refiner": True}}, None)
        if "no refiner loaded" not in err.get("error", ""):
            raise AssertionError(f"use_refiner request: {err}")
        burst = [{**base, "prompt": p, "seed": 200 + i}
                 for i, p in enumerate(["a bowl of ramen", "a snowy mountain village"])]
        _, burst_row = _burst(server, port, counters, card, burst, want("DDIM"))
        launches = {n: c.count for n, c in counters.items()}
        walls.sort()
        print(json.dumps({"serve_summary": "SDXL over HTTP, full width 1024x1024, CFG 7.5",
                          "p50_wall_s_batch1_txt2img": walls[len(walls) // 2],
                          "batch1_txt2img_walls_s": walls,
                          "burst_images_per_s": burst_row["images_per_s"],
                          "batch1_images_per_s": 1.0 / walls[len(walls) // 2],
                          "launches": launches, "card": card}), flush=True)
        by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
        lora = phase_lora_sdxl(server, port, counters, card, lora_dir, want("DDIM"))
        return launches, by_shape, lora
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=30)
        shutil.rmtree(root, ignore_errors=True)


LORA_PROMPT = "a photograph of an astronaut riding a horse"


def _bf16_ulps(got, want):
    """Largest |got - want| over one bf16 ulp of the larger magnitude, per
    element, on the card."""
    import torch

    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return float(((got - want).abs() / ulp).max())


def _fused_against_plain(model):
    """Every weight the active adapters fused on the card against the plain
    ``fuse`` on the CPU from the pristine copies and the same factors:
    returns the largest error in bf16 ulps (fp32 towers: also counted in
    bf16 ulps, which bounds their error far above fp32 rounding), the
    elements held and the seconds of the CPU fuse."""
    import torch

    from stablediffusion_tpu_torch.lora.core import fuse

    worst, n, cpu_s = 0.0, 0, 0.0
    modules = model._lora_modules()
    for comp, pristine in model._pristine.items():
        adapters = {name: {p: {k: v.cpu() for k, v in f.items()}
                           for p, f in model._adapter_store[name][comp].items()}
                    for name in model.adapters if comp in model._adapter_store[name]}
        base = {k: v.cpu() for k, v in pristine.items()}
        t = time.perf_counter()
        ref = fuse(modules[comp], adapters, model.adapters, base=base)
        cpu_s += time.perf_counter() - t
        params = dict(modules[comp].named_parameters())
        for key, want in ref.items():
            worst = max(worst, _bf16_ulps(params[key].detach(), want.to(params[key].device)))
            n += want.numel()
        del ref, base
    return worst, n, cpu_s


def phase_lora_sdxl(server, port, counters, card, lora_dir, want):
    """Phase 20: LoRA adapters and a textual inversion on the full-width
    SDXL folder served by phase 19's worker (started with --lora_dir):
    a kohya file (rank 16 on every linear of the UNet's transformer blocks,
    lora_te1_/lora_te2_ on q/k/v/out_proj), a peft file (rank 8, UNet
    attention) and a dual-tower textual inversion (2 vectors), over six
    requests with the seed of the first; exact launches each; the fused
    weights within one bf16 ulp of the plain fuse on the CPU; after
    ``loras: []`` the image and every weight bit for bit those of the first
    request."""
    import os

    import torch

    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors
    from stablediffusion_tpu_torch.lora.core import TEXT_TARGET_SUFFIXES, UNET_TARGET_SUFFIXES
    from stablediffusion_tpu_torch.lora.formats import load_lora_file, save_lora_file
    from stablediffusion_tpu_torch.utils.testing import random_lora, random_textual_inversion

    model = server.handler.model
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    kohya = {"unet": {p: f for p, f in random_lora(model.unet, ("",), 16, 11, std=0.03).items()
                      if ".transformer_blocks." in p},
             "text_encoder": random_lora(model.text_encoder, TEXT_TARGET_SUFFIXES, 16, 12),
             "text_encoder_2": random_lora(model.text_encoder_2, TEXT_TARGET_SUFFIXES, 16, 13)}
    save_lora_file(kohya, os.path.join(lora_dir, "sdxl_kstyle.safetensors"), format="kohya")
    peft = {"unet": random_lora(model.unet, UNET_TARGET_SUFFIXES, 8, 14, std=0.03)}
    save_lora_file(peft, os.path.join(lora_dir, "sdxl_pstyle.safetensors"), format="peft")
    ti_path = os.path.join(lora_dir, "chiptok.safetensors")
    save_safetensors(random_textual_inversion(model, 2, seed=15), ti_path)
    n_factors = sum(v.numel() for c in kohya.values() for f in c.values() for v in f.values())
    write_s = time.perf_counter() - t
    del kohya, peft
    # the adapter lifecycle alone, timed: parse and move the factors, fuse
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.load_loras({"kstyle": 0.8}, lora_dir=lora_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    model.load_lora_weights("pstyle", load_lora_file(
        os.path.join(lora_dir, "sdxl_pstyle.safetensors"), model.lora_module_paths()))
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.set_adapters({"kstyle": 0.8, "pstyle": 0.5})
    torch.cuda.synchronize()
    set_s = time.perf_counter() - t
    touched = {c: len(p) for c, p in model._pristine.items()}
    touched_params = sum(v.numel() for p in model._pristine.values() for v in p.values())
    pristine_bytes = sum(v.numel() * v.element_size()
                         for p in model._pristine.values() for v in p.values())
    model.delete_adapters()
    snap = {c: {k: v.clone() for k, v in m.state_dict().items()}
            for c, m in model._lora_modules().items()}

    base = dict(prompt=LORA_PROMPT, height=SDXL_RES, width=SDXL_RES,
                num_inference_steps=SDXL_STEPS, guidance_scale=7.5, seed=300)
    both = {"kstyle": 0.8, "pstyle": 0.5}
    ti_prompt = LORA_PROMPT + ", chiptok"
    requests = [
        ("no adapters", {**base, "model": {"scheduler": "DDIM"}}),
        ("kohya 0.8", {**base, "model": {"loras": {"kstyle": 0.8}}}),
        ("kohya 0.8 + peft 0.5", {**base, "model": {"loras": both}}),
        ("+ textual inversion", {**base, "prompt": ti_prompt,
                                 "model": {"loras": both, "textual_inversion": [ti_path]}}),
        ("text scale 0.5", {**base, "prompt": ti_prompt,
                            "cross_attention_kwargs": {"scale": 0.5}}),
        ("loras: []", {**base, "model": {"loras": [], "textual_inversion": []}}),
    ]
    for c in counters.values():
        c.reset()
    replies, walls, fused_ulps = [], [], None
    for label, body in requests:
        reply, row = _ask(port, counters, card, f"sdxl lora: {label}", body, want)
        replies.append(reply["images"][0])
        walls.append(row["wall_s"])
        if label == "kohya 0.8 + peft 0.5":
            t = time.perf_counter()
            fused_ulps, n_fused, cpu_s = _fused_against_plain(model)
            check_s = time.perf_counter() - t
            print(json.dumps({"lora_fused_vs_plain_cpu_bf16_ulps": fused_ulps,
                              "elements": n_fused, "check_s": check_s,
                              "cpu_fuse_s": cpu_s}), flush=True)
            if fused_ulps > 1.0:
                raise AssertionError(f"fused weights {fused_ulps} bf16 ulps from the plain fuse")
    launches = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    if replies[-1] != replies[0]:
        raise AssertionError("the image after loras: [] differs from the first request's")
    same = [label for (label, _), im in zip(requests[1:-1], replies[1:-1]) if im == replies[0]]
    if same or replies[4] == replies[3]:
        raise AssertionError(f"adapter requests gave the plain image: {same}")
    for comp, m in model._lora_modules().items():
        for k, v in m.state_dict().items():
            if not torch.equal(v, snap[comp][k]):
                raise AssertionError(f"{comp}.{k} differs after loras: []")
    print(json.dumps({
        "lora_summary": "SDXL 1024x1024 over HTTP with kohya + peft LoRAs and a dual-tower "
                        "textual inversion, 20 DDIM steps, CFG 7.5",
        "kohya_factor_params": n_factors, "files_written_s": write_s,
        "load_loras_s": load_s, "set_adapters_two_s": set_s,
        "touched_weights": touched, "touched_params": touched_params,
        "pristine_copy_gib": pristine_bytes / 2**30,
        "request_walls_s": dict(zip([r[0] for r in requests], walls)),
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "weights_bit_identical_after_clear": True, "image_bit_identical_after_clear": True,
        "launches": launches, "card": card}), flush=True)
    del snap
    return launches, by_shape


SINGLE_RES = 512
SINGLE_STEPS = 20
SINGLE_SCHEDULERS = ["DDIM", "DPM++ 2M Karras"]
SINGLE_LORA_SCALES = [0.5, 1.0]


def phase_single_file(card: str):
    """Phase 21: the full-width SD1.5 model (random weights, seed 5) written
    as an A1111/LDM .safetensors single file by ``utils/testing.
    save_ldm_single_file`` and as a diffusers folder; the handler loads the
    file by name (``load_sd_single_file``, every tensor equal to its
    source) and serves it with the folder's image bit for bit; then a kohya LoRA on the attention linears
    (UNet and CLIP) and a constructor grid of 2 schedulers x 2 LoRA scales x
    20 steps x CFG 7.5, each image with exact launches."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.io.loader import save_sd_model
    from stablediffusion_tpu_torch.lora.core import TEXT_TARGET_SUFFIXES, UNET_TARGET_SUFFIXES
    from stablediffusion_tpu_torch.lora.formats import save_lora_file
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.serve.handler import Handler, decode_image_b64
    from stablediffusion_tpu_torch.utils.testing import (
        random_full_model,
        random_lora,
        save_ldm_single_file,
        synthetic_clip_tokenizer,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_single_")
    try:
        src = random_full_model("sd15", device="cuda", seed=5)
        src.tokenizer = synthetic_clip_tokenizer()
        path = os.path.join(root, "chip.safetensors")
        t = time.perf_counter()
        save_ldm_single_file(src, path)
        write_s = time.perf_counter() - t
        src.tokenizer.save_pretrained(os.path.join(root, "tokenizer"))
        save_sd_model(src, os.path.join(root, "sd15_chip"))
        by_file = Handler(model_dir=root, lora_dir=os.path.join(root, "loras"),
                          device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        by_file.maybe_reload_model({"type": "sd15", "name": "chip.safetensors"})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        loaded = by_file.model
        n = 0
        for comp in ("unet", "vae", "text_encoder"):
            a, b = getattr(src, comp).state_dict(), getattr(loaded, comp).state_dict()
            if a.keys() != b.keys():
                raise AssertionError(f"single file {comp}: keys differ")
            for k in a:
                if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])):
                    raise AssertionError(f"single file {comp}.{k} differs from its source")
            n += len(a)
        if (loaded.unet_config, loaded.vae_config, loaded.text_encoder_config) != (
                src.unet_config, src.vae_config, src.text_encoder_config):
            raise AssertionError("single file: the converter's configs differ from the source")
        del loaded, src
        torch.cuda.empty_cache()

        counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
        req = dict(prompt="a photograph of an astronaut riding a horse", seed=21,
                   height=SINGLE_RES, width=SINGLE_RES, num_inference_steps=SINGLE_STEPS,
                   guidance_scale=7.5)
        for c in counters.values():
            c.reset()
        t = time.perf_counter()
        r_file = by_file({**req, "model": {"type": "sd15", "name": "chip.safetensors"}},
                         "file")
        wall_file = time.perf_counter() - t
        if "error" in r_file:
            raise AssertionError(f"single file request: {r_file['traceback']}")
        want = _want(by_file.model, SINGLE_STEPS, 1)
        got = {k: c.count for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"single file request: launches {got} != {want}")
        by_folder = Handler(model_dir=root, device="cuda")
        r_folder = by_folder({**req, "model": {"type": "sd15", "name": "chip"}}, "folder")
        del by_folder
        torch.cuda.empty_cache()
        if r_file["images"] != r_folder["images"]:
            raise AssertionError("the single file's image differs from the folder's")

        os.makedirs(os.path.join(root, "loras"))
        model = by_file.model
        save_lora_file({"unet": random_lora(model.unet, UNET_TARGET_SUFFIXES, 16, 21,
                                            std=0.05),
                        "text_encoder": random_lora(model.text_encoder,
                                                    TEXT_TARGET_SUFFIXES, 16, 22)},
                       os.path.join(root, "loras", "sd15_kchip.safetensors"), format="kohya")
        per_image = []
        orig = by_file._generate

        def counted(args, output_type="uint8"):
            before = {k: c.count for k, c in counters.items()}
            out = orig(args, output_type)
            per_image.append({k: c.count - before[k] for k, c in counters.items()})
            return out

        by_file._generate = counted
        for c in counters.values():
            c.reset()
        t = time.perf_counter()
        grid = by_file({**req, "mode": "constructor", "model": {"loras": {"kchip": 1.0}},
                        "params": {"schedulers": SINGLE_SCHEDULERS,
                                   "lora_scales": SINGLE_LORA_SCALES,
                                   "steps_grid": [SINGLE_STEPS], "guidance_grid": [7.5]}},
                       "constructor")
        grid_s = time.perf_counter() - t
        if "error" in grid:
            raise AssertionError(f"constructor: {grid['traceback']}")
        cells = grid["grid"]
        if len(cells) != 4 or per_image != [want] * 4:
            raise AssertionError(f"constructor: {len(cells)} images, launches {per_image}")
        pixels = [decode_image_b64(c["images"][0]) for c in cells]
        if not all(px.shape == (SINGLE_RES, SINGLE_RES, 3) and np.isfinite(px).all()
                   for px in pixels):
            raise AssertionError("constructor: bad images")
        if cells[0]["images"][0] == cells[1]["images"][0]:
            raise AssertionError("constructor: LoRA scales 0.5 and 1.0 gave the same image")
        if model.get_list_adapters() != {"kchip": 1.0}:
            raise AssertionError(f"constructor left adapters {model.get_list_adapters()}")
        launches = {k: c.count for k, c in counters.items()}
        by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
        print(json.dumps({
            "single_file": "full-width SD1.5 as an A1111/LDM .safetensors, random weights "
                           "(seed 5), synthetic byte-level BPE",
            "bytes": os.path.getsize(path), "written_s": write_s, "load_s": load_s,
            "tensors_equal": n, "image_equals_folder": True,
            "request_wall_s": wall_file, "constructor_images": len(cells),
            "constructor_wall_s": grid_s, "launches_per_image": want,
            "constructor_launches": launches, "card": card}), flush=True)
        del by_file, model
        torch.cuda.empty_cache()
        return launches, by_shape
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_adapter_reference():
    """Phase 22: the narrow SD1.5 and SDXL-layout models (phases 5 and 18),
    each with a kohya LoRA on the UNet and every text tower and a textual
    inversion, card (kernels) against CPU (plain attention), fp32, TF32 off,
    2 DDIM steps, the text scale at 0.7 through ``cross_attention_kwargs``:
    the images within ADAPTER_REF_TOL of max(1, max |ref|)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.io.safetensors_io import save_safetensors
    from stablediffusion_tpu_torch.lora.core import TEXT_TARGET_SUFFIXES, UNET_TARGET_SUFFIXES
    from stablediffusion_tpu_torch.lora.formats import save_lora_file
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils.testing import random_lora, random_textual_inversion

    root = tempfile.mkdtemp(prefix="chip_smoke_adapter_ref_")
    try:
        for name, cpu in (("sd15", _narrow_sd15(seed=31)), ("sdxl", _narrow_sdxl(seed=32))):
            comps = {"unet": random_lora(cpu.unet, UNET_TARGET_SUFFIXES, 8, 33, std=0.05),
                     "text_encoder": random_lora(cpu.text_encoder, TEXT_TARGET_SUFFIXES, 8, 34)}
            if cpu.is_sdxl:
                comps["text_encoder_2"] = random_lora(cpu.text_encoder_2,
                                                      TEXT_TARGET_SUFFIXES, 8, 35)
            save_lora_file(comps, os.path.join(root, f"{name}_ref.safetensors"),
                           format="kohya")
            ti = os.path.join(root, f"{name}_ti.safetensors")
            save_safetensors(random_textual_inversion(cpu, 2, seed=36, std=0.5), ti)
            gpu = _to_card(cpu)
            lat = np.random.default_rng(37).standard_normal((1, 16, 16, 4)).astype(np.float32)
            outs = {}
            for dev, model in (("cpu", cpu), ("cuda", gpu)):
                model.load_loras({"ref": 0.9}, lora_dir=root)
                model.load_textual_inversion(ti, token="<chip>")
                pipe = StableDiffusionUnifiedPipeline(device=dev, dtype=torch.float32)
                f0, s0 = FLASH_FWD_LAUNCHES.count, FLASH_STREAM_LAUNCHES.count
                outs[dev] = pipe(model, prompt="a small red house, <chip>",
                                 num_inference_steps=2, guidance_scale=7.5,
                                 latents=torch.from_numpy(lat), output_type="np",
                                 cross_attention_kwargs={"scale": 0.7}).images
                if dev == "cuda" and (FLASH_FWD_LAUNCHES.count == f0
                                      or FLASH_STREAM_LAUNCHES.count == s0):
                    raise AssertionError("adapter reference on the card launched no kernel")
            ref = outs["cpu"]
            err = float(np.abs(outs["cuda"] - ref).max())
            tol = ADAPTER_REF_TOL * max(1.0, float(np.abs(ref).max()))
            print(json.dumps({"adapter_reference": f"narrow {name}, kohya LoRA on the UNet "
                              "and every tower at 0.9, text scale 0.7, textual inversion, "
                              "card vs CPU, fp32", "images_max_abs_err": err, "tol": tol}),
                  flush=True)
            if not err <= tol:
                raise AssertionError(f"{name} adapter reference: card {err} from the CPU")
            del gpu
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_sdxl(smi, checked):
    """The SDXL path: the main path, its kernel shapes, the bf16 UNet, the
    narrow reference, the refiner, a profile, and serving.  Returns the
    kernel rows and the launches by path."""
    import torch

    launches, by_shape, _, model, pipe, image = phase_main_path(
        "sdxl", SDXL_RES, SDXL_REQUESTS)
    _profile("one SDXL batch-1 request, 1024x1024, 20 DDIM steps, CFG 7.5",
             lambda: pipe(model, prompt="a photograph of an astronaut riding a horse",
                          seed=0, height=SDXL_RES, width=SDXL_RES,
                          num_inference_steps=SDXL_STEPS, guidance_scale=7.5))
    refiner_launches, refiner_by_shape = phase_refiner(model, pipe, image)
    phase_unet_bf16(model)
    del model, pipe
    torch.cuda.empty_cache()
    rows = phase_new_shapes(by_shape, checked, "sdxl")
    rows += phase_new_shapes(refiner_by_shape, checked, "refiner")
    phase_sdxl_reference()
    serve_launches, serve_by_shape, (lora_launches, lora_by_shape) = phase_serve_sdxl(smi)
    torch.cuda.empty_cache()
    rows += phase_new_shapes(serve_by_shape, checked, "sdxl_serve")
    rows += phase_new_shapes(lora_by_shape, checked, "sdxl_lora")
    return rows, {"sdxl": launches, "refiner": refiner_launches, "sdxl_serve": serve_launches,
                  "sdxl_lora": lora_launches}


SD3_RES = 1024
SD3_STEPS = 28
SD3_CFG = 7.0
SD3_MAX_SEQ = 256  # T5 tokens, the pipeline's default
SD3_REQUESTS = [
    dict(prompt="a photograph of an astronaut riding a horse", seed=0),
    dict(prompt="a watercolor painting of a fox in the snow", seed=1,
         prompt_3="soft morning light, fine detail", negative_prompt="blurry"),
]
SD3_BURST = 2  # the SD3 worker's max_batch and its burst's size
# the heaviest shapes held in the kernel phase besides those the path
# launched: MMDiT-X's attn2 (SD3.5-medium, image tokens alone) and
# SD3.5-large's joint attention (38 heads)
SD3_EXTRA_CASES = [("flash_fwd", 2, 4096, 24, 64, 4096, False),
                   ("flash_fwd", 2, 4429, 38, 64, 4429, False)]


def _sd3_counters():
    from stablediffusion_tpu_torch.ops.attention import (
        ATTENTION_MASKED_LAUNCHES,
        FLASH_FWD_LAUNCHES,
    )
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES

    return {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES,
            "attention_masked": ATTENTION_MASKED_LAUNCHES}


def _sd3_evals(steps, strength=1.0):
    """MM-DiT evaluations of an SD3 call: the plan sliced at `strength`
    (img2img and inpainting; ``pipelines/sd3.py``)."""
    if strength >= 1.0:
        return steps
    return steps - min(max(int(steps * (1.0 - strength)), 0), steps - 1)


def _want_sd3(model, n_evals, streams):
    """The launches of one CFG call of an SD3 model: one encode each for the
    prompts and the negatives (every layer of CLIP-L and bigG through the
    causal ``flash_fwd``; every T5 layer through the counted masked route),
    one joint attention per block per evaluation plus the MMDiT-X blocks'
    ``attn2``, and `streams` VAE mid-block attentions."""
    clip = (model.text_encoder_config.num_hidden_layers
            + model.text_encoder_2_config.num_hidden_layers)
    tf = model.transformer_config
    t5 = model.text_encoder_3_config.num_layers if model.text_encoder_3 is not None else 0
    per_eval = tf.num_layers + len(tf.dual_attention_layers)
    return {"flash_fwd": 2 * clip + per_eval * n_evals, "flash_stream": streams,
            "attention_masked": 2 * t5}


def phase_sd3_main():
    """SD3-medium and T5-XXL at full width (random weights, every module in
    bf16 as the JAX package's ``_random_full_sd3`` holds them): two batch-1
    1024² requests at 28 FlowMatchEuler steps and CFG 7.0 with two seeds,
    then the first again, bit for bit; exact launches per request."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline
    from stablediffusion_tpu_torch.utils.testing import random_full_model

    t0 = time.perf_counter()
    model = random_full_model("sd3", device="cuda", seed=0, with_t5=True)
    torch.cuda.synchronize()
    n_params = {c: sum(p.numel() for p in getattr(model, c).parameters())
                for c in ("transformer", "text_encoder", "text_encoder_2", "text_encoder_3",
                          "vae")}
    print(json.dumps({"sd3_model": "full-width SD3-medium + T5-XXL, random weights, bf16",
                      "build_s": time.perf_counter() - t0, "parameters": n_params}), flush=True)
    pipe = StableDiffusion3Pipeline(device="cuda")
    counters = _sd3_counters()
    for c in counters.values():
        c.reset()
    want = _want_sd3(model, SD3_STEPS, 1)
    torch.cuda.reset_peak_memory_stats()
    images, batch1 = [], None
    for i, req in enumerate(SD3_REQUESTS + SD3_REQUESTS[:1]):
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(model, height=SD3_RES, width=SD3_RES, num_inference_steps=SD3_STEPS,
                   guidance_scale=SD3_CFG, **req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count - before[n] for n, c in counters.items()}
        im = out.images
        print(json.dumps({"model": "sd3", "request": req, "wall_s": wall, "launches": got,
                          "expected_launches": want, "shape": list(im.shape),
                          "mean": float(im.mean()), "std": float(im.std())}), flush=True)
        if im.shape != (1, SD3_RES, SD3_RES, 3) or im.dtype != np.float32:
            raise AssertionError(f"sd3: bad output {im.shape} {im.dtype}")
        if not (np.isfinite(im).all() and im.min() >= 0.0 and im.max() <= 1.0):
            raise AssertionError("sd3: non-finite or out-of-range pixels")
        if got != want:
            raise AssertionError(f"sd3: launch counts {got} != expected {want}")
        images.append(im)
        if batch1 is None:
            batch1 = {n: dict(c.by_shape) for n, c in counters.items()}
    if np.array_equal(images[0], images[1]):
        raise AssertionError("sd3: two seeds and prompts gave identical images")
    if not np.array_equal(images[0], images[2]):
        raise AssertionError("sd3: the repeated request differs from the first")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for n, shapes in batch1.items():
        for (qs, skv, dtype, causal, _lse), count in sorted(shapes.items()):
            print(json.dumps({"batch1_launches": n, "model": "sd3", "shape": list(qs),
                              "skv": skv, "dtype": dtype, "causal": causal,
                              "count": count}), flush=True)
    print(json.dumps({"sd3_main_path": "repeat bit-identical", "peak_device_memory_gib": peak}),
          flush=True)
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    totals = {n: c.count for n, c in counters.items()}
    return totals, by_shape, model, pipe, images[0]


def phase_sd3_bf16(model):
    """One MM-DiT forward at B=2 on 128x128 latents (1024²) with 77 + 256
    text tokens, in bf16 through the kernels and through the plain
    attention, each against an fp32 copy with the plain attention: the main
    path's SD3-medium and a random SD3.5-medium (MMDiT-X, QK-RMSNorm)."""
    import torch

    import stablediffusion_tpu_torch.models.mmdit as mmdit_module
    from stablediffusion_tpu_torch.core.config import SD35_MEDIUM
    from stablediffusion_tpu_torch.models.mmdit import SD3Transformer2DModel
    from stablediffusion_tpu_torch.ops.attention import attention_plain
    from stablediffusion_tpu_torch.utils.testing import random_module

    g = torch.Generator(device="cuda").manual_seed(6)
    sd35 = random_module(SD3Transformer2DModel, SD35_MEDIUM, torch.device("cuda"),
                         torch.bfloat16, g)
    counts = {}
    for name, tf in (("SD3-medium", model.transformer), ("SD3.5-medium", sd35)):
        cfg = tf.config
        hw = cfg.sample_size
        x = torch.randn(2, cfg.in_channels, hw, hw, device="cuda", generator=g)
        ctx = torch.randn(2, 77 + SD3_MAX_SEQ, cfg.joint_attention_dim, device="cuda",
                          generator=g)
        pooled = torch.randn(2, cfg.pooled_projection_dim, device="cuda", generator=g)
        t = torch.tensor(500.0, device="cuda")
        bf = lambda a: a.to(torch.bfloat16)  # noqa: E731
        c = _sd3_counters()["flash_fwd"]
        before = c.count
        with torch.inference_mode():
            kern = tf(bf(x), t, bf(ctx), bf(pooled)).float()
            counts[name] = c.count - before
            routed = mmdit_module.attention
            mmdit_module.attention = attention_plain
            try:
                plain = tf(bf(x), t, bf(ctx), bf(pooled)).float()
                ref = copy.deepcopy(tf).float()(x, t, ctx, pooled).float()
            finally:
                mmdit_module.attention = routed
        err_kernel, err_plain = _rel_err(kern, ref), _rel_err(plain, ref)
        print(json.dumps({
            "mmdit_bf16": f"full-width {name} MM-DiT, B=2, {hw}x{hw} latents, "
                          f"{77 + SD3_MAX_SEQ} text tokens, t=500",
            "flash_fwd_launches": counts[name], "ref_std": ref.std().item(),
            "kernels_vs_fp32": err_kernel, "plain_vs_fp32": err_plain,
            "kernels_vs_plain": _rel_err(kern, plain),
            "limit": f"kernels_vs_fp32 <= {UNET_SLACK} * plain_vs_fp32"}), flush=True)
        want = cfg.num_layers + len(cfg.dual_attention_layers)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} flash_fwd launches, want {want}")
        if not (torch.isfinite(kern).all() and err_kernel <= UNET_SLACK * err_plain):
            raise AssertionError(f"bf16 {name} through the kernels: {err_kernel} from "
                                 f"fp32, the plain path {err_plain}")
        del ref, plain, kern
        torch.cuda.empty_cache()
    del sd35
    torch.cuda.empty_cache()


def _narrow_sd3(seed):
    """The narrow SD3 model of the reference phase on the CPU, fp32: two
    joint blocks at head dim 64 (2 heads), the first MMDiT-X ``dual`` with
    QK-RMSNorm, CLIP-L and bigG at full width and 2 layers each, a 2-layer
    T5 (d_kv 64) at the joint width, a 16-channel VAE with the SD3 shift
    whose mid-block takes flash_stream."""
    import dataclasses

    import torch

    from stablediffusion_tpu_torch.core.config import (
        SD3_MEDIUM,
        SDXL_TEXT_ENCODER,
        SDXL_TEXT_ENCODER_2,
        VAEConfig,
    )
    from stablediffusion_tpu_torch.models.t5 import T5Config
    from stablediffusion_tpu_torch.utils.testing import (
        bench_t5_tokenizer,
        bench_tokenizer,
        random_sd3_model,
    )

    tf = dataclasses.replace(SD3_MEDIUM, sample_size=16, num_layers=2, num_attention_heads=2,
                             joint_attention_dim=2176, pos_embed_max_size=12,
                             qk_norm="rms_norm", dual_attention_layers=(0,))
    vae = VAEConfig(block_out_channels=(64, 192), layers_per_block=1, latent_channels=16,
                    scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False,
                    use_post_quant_conv=False)
    t1 = dataclasses.replace(SDXL_TEXT_ENCODER, num_hidden_layers=2, with_projection=True)
    t2 = dataclasses.replace(SDXL_TEXT_ENCODER_2, num_hidden_layers=2)
    t5 = T5Config(vocab_size=512, d_model=2176, d_kv=64, d_ff=512, num_layers=2, num_heads=4)
    return random_sd3_model(tf, vae, t1, t2, bench_tokenizer(), bench_tokenizer(pad_token_id=0),
                            t5, bench_t5_tokenizer(), device="cpu", dtype=torch.float32,
                            seed=seed)


def phase_sd3_reference():
    """The narrow SD3 model, card (kernels, the masked route) against CPU
    (plain attention), fp32, TF32 off, the same weights and injected draws:
    txt2img, img2img at 0.6 and inpainting at 0.8, 4 FlowMatchEuler steps,
    CFG 7.0; latents and pixels within REF_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.pipelines.sd3 import StableDiffusion3Pipeline

    cpu = _narrow_sd3(seed=41)
    mods = {c: copy.deepcopy(getattr(cpu, c)).cuda()
            for c in ("transformer", "vae", "text_encoder", "text_encoder_2", "text_encoder_3")}
    gpu = dataclasses.replace(cpu, _scheduler=None, **mods)
    r = np.random.default_rng(42)
    image = r.random((1, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 8:24, 8:24] = 1.0
    draws = {"latents": r.standard_normal((1, 16, 16, 16)).astype(np.float32),
             "encode": r.standard_normal((1, 16, 16, 16)).astype(np.float32)}
    modes = {"txt2img": {}, "img2img": dict(image=image, strength=0.6),
             "inpaint": dict(image=image, mask_image=mask, strength=0.8)}
    counters = _sd3_counters()
    for mode, extra in modes.items():
        outs = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            pipe = StableDiffusion3Pipeline(device=dev, dtype=torch.float32)
            common = dict(prompt="a small red house", prompt_3="by the sea",
                          num_inference_steps=4, guidance_scale=SD3_CFG,
                          max_sequence_length=32, seed=3, draws=draws, **extra)
            before = {n: c.count for n, c in counters.items()}
            latents = pipe(model, output_type="latents", **common).latents
            images = pipe(model, output_type="np", **common).images
            outs[dev] = (latents.float().cpu().numpy(), images)
            got = {n: c.count - before[n] for n, c in counters.items()}
            if dev == "cuda" and min(got.values()) == 0:
                raise AssertionError(f"SD3 reference {mode} on the card: launches {got}")
        lat_ref, img_ref = outs["cpu"]
        lat_err = float(np.abs(lat_ref - outs["cuda"][0]).max())
        img_err = float(np.abs(img_ref - outs["cuda"][1]).max())
        print(json.dumps({"reference": f"narrow SD3 {mode} (MMDiT-X dual block, QK-RMSNorm, "
                          "head dim 64, 173 joint tokens, T5 d_kv 64), card vs CPU, fp32",
                          "latents_max_abs_err": lat_err,
                          "latents_max_abs_ref": float(np.abs(lat_ref).max()),
                          "images_max_abs_err": img_err, "tol": REF_TOL}), flush=True)
        if not (lat_err <= REF_TOL and img_err <= REF_TOL):
            raise AssertionError(f"SD3 {mode}: card disagrees with CPU: {lat_err}, {img_err}")


def phase_serve_sd3(card: str):
    """Serving SD3: the T5-free SD3-medium folder (the documented drop-T5
    configuration) written by ``save_sd3_model`` and loaded by the worker
    with ``--model_type sd3``, every tensor equal, asked over loopback at
    1024², 28 steps, CFG 7.0: txt2img, a payload with SDXL-only keys (dropped
    with a warning), img2img at 0.6, inpainting at 0.8 and a burst of
    SD3_BURST that the batcher merges, each with the launches its plan
    implies."""
    import logging
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.serve.handler import encode_images_b64
    from stablediffusion_tpu_torch.utils.testing import (
        random_full_model,
        synthetic_clip_tokenizer,
    )

    class _Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_sd3_")
    server = thread = None
    warnings = _Warnings()
    handler_log = logging.getLogger("stablediffusion_tpu_torch.serve.handler")
    handler_log.addHandler(warnings)
    try:
        model = random_full_model("sd3", device="cuda", seed=4)
        model.tokenizer = synthetic_clip_tokenizer()
        model.tokenizer_2 = synthetic_clip_tokenizer(pad_token_id=0)
        server = _save_and_serve(
            model, root, "sd3_chip",
            ["--model_type", "sd3", "--model_name", "chip", "--max_batch", str(SD3_BURST),
             "--batch_window_ms", "200"],
            "full-width SD3-medium without T5, random weights (seed 4), synthetic BPE", card)
        loaded = server.handler.model
        if loaded.model_type != "sd3" or loaded.text_encoder_3 is not None:
            raise AssertionError(f"the worker loaded {loaded.model_type}")
        del model
        torch.cuda.empty_cache()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        counters = _sd3_counters()
        for c in counters.values():
            c.reset()
        want = lambda strength=1.0, streams=1: _want_sd3(  # noqa: E731
            loaded, _sd3_evals(SD3_STEPS, strength), streams)
        base = dict(prompt="a photograph of an astronaut riding a horse", height=SD3_RES,
                    width=SD3_RES, num_inference_steps=SD3_STEPS, guidance_scale=SD3_CFG)
        mask = np.zeros((1, SD3_RES, SD3_RES, 3), np.uint8)
        mask[:, 256:768, 256:768] = 255
        walls = []
        first, row = _ask(port, counters, card, "sd3 txt2img", {**base, "seed": 100}, want())
        walls.append(row["wall_s"])
        _, row = _ask(port, counters, card, "sd3 txt2img with SDXL-only keys",
                      {**base, "seed": 101, "prompt_2": "fine detail", "guidance_rescale": 0.7,
                       "denoising_end": 0.8, "negative_prompt_2": "blurry"}, want())
        walls.append(row["wall_s"])
        dropped = [m for m in warnings.messages if m.startswith("sd3: ignoring")]
        print(json.dumps({"sd3_dropped_keys_warning": dropped}), flush=True)
        if not any("guidance_rescale" in m and "denoising_end" in m for m in dropped):
            raise AssertionError(f"sd3: no warning for the dropped keys: {warnings.messages}")
        _ask(port, counters, card, "sd3 img2img strength 0.6",
             {**base, "seed": 7, "image": first["images"][0], "strength": 0.6},
             want(0.6, streams=2))
        _ask(port, counters, card, "sd3 inpaint strength 0.8",
             {**base, "seed": 8, "image": first["images"][0],
              "mask_image": encode_images_b64(mask)[0], "strength": 0.8}, want(0.8, streams=2))
        burst = [{**base, "prompt": p, "seed": 200 + i}
                 for i, p in enumerate(["a bowl of ramen", "a snowy mountain village"])]
        _, burst_row = _burst(server, port, counters, card, burst, want())
        walls.sort()
        launches = {n: c.count for n, c in counters.items()}
        print(json.dumps({"serve_summary": "SD3-medium (T5-free) over HTTP, 1024x1024, "
                          "28 steps, CFG 7.0",
                          "batch1_txt2img_walls_s": walls,
                          "burst_images_per_s": burst_row["images_per_s"],
                          "launches": launches, "card": card}), flush=True)
        return launches, {n: dict(c.by_shape) for n, c in counters.items()}
    finally:
        handler_log.removeHandler(warnings)
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=30)
        shutil.rmtree(root, ignore_errors=True)


def phase_sd3(smi, checked):
    """The SD3 path: the main path with T5-XXL, a profiled request, the
    full-width bf16 MM-DiTs, the kernels at the new shapes, the narrow
    reference, and serving.  Returns the kernel rows and the launches by
    path."""
    import torch

    from stablediffusion_tpu_torch.ops.attention import attention_plain, flash_fwd

    launches, by_shape, model, pipe, _ = phase_sd3_main()
    torch.cuda.reset_peak_memory_stats()
    _profile("one SD3-medium + T5-XXL batch-1 request, 1024x1024, 28 FlowMatchEuler "
             "steps, CFG 7.0",
             lambda: pipe(model, prompt="a photograph of an astronaut riding a horse", seed=0,
                          height=SD3_RES, width=SD3_RES, num_inference_steps=SD3_STEPS,
                          guidance_scale=SD3_CFG))
    print(json.dumps({"sd3_profiled_request_peak_gib":
                      torch.cuda.max_memory_allocated() / 2**30, "card": smi}), flush=True)
    phase_sd3_bf16(model)
    del model, pipe
    torch.cuda.empty_cache()
    kernels = lambda shapes: {n: shapes[n] for n in ("flash_fwd", "flash_stream")}  # noqa: E731
    rows = phase_new_shapes(kernels(by_shape), checked, "sd3")
    for (name, B, Sq, H, D, Skv, causal) in SD3_EXTRA_CASES:
        checked.add((name, B, Sq, H, D, Skv, causal))
        for dtype in (torch.bfloat16, torch.float32):
            row = kernel_case(name, flash_fwd, attention_plain, B, Sq, H, D, Skv, dtype,
                              causal, 0, 0)
            rows.append(dict(row, path="sd3_extra"))
    phase_sd3_reference()
    serve_launches, serve_by_shape = phase_serve_sd3(smi)
    torch.cuda.empty_cache()
    rows += phase_new_shapes(kernels(serve_by_shape), checked, "sd3_serve")
    return rows, {"sd3": launches, "sd3_serve": serve_launches}


# -- the rest of training: SD3 LoRA, full fine-tuning, textual inversion,
# DreamBooth ------------------------------------------------------------------

SD3_TRAIN_STEPS = 4  # a checkpoint at step 2, then a resume for 2 more
# remat against none on the card: the same kernels and GEMMs on the same
# inputs, each gradient relative to its largest element (the CPU tests'
# limit)
REMAT_TOL = 1e-6
# each joint block one remat region: "full" and "offload" hold the blocks'
# inputs and one block's activations, "dots" its 2-D products too; the
# step's peak over what it holds before, as a share of no remat's
REMAT_PEAK_SHARE = 0.5
# the EMA's move from the initial weights against its fp64 recomputation's
# (e d + p (1 - d) from each step's weights), the L2 norm of the gap over
# that of the move, the whole UNet at once (lr 1e-4, decay 0.9, 3 steps:
# moves of ~5e-5 against the in-place fp32 lerp's rounding of an ulp or
# two a step); an EMA left unchanged reads 1, one update short about 0.5.
# Per tensor the reading is larger where a tensor's moves come near the
# fp32 spacing of its weights: reported, not held
EMA_TOL = 1e-2
FULL_BATCH = 8
FULL_STEPS = 3
TI_TOKEN = "<chip-ti>"


def _max_rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def _fwd_counts_are_bf16(probe, label):
    """Every forward with lse a step launched ran in bf16: a trainer that
    fell onto the fp32 kernels at the UNet's shapes is a fault."""
    bad = sorted({key for s in probe.steps for key in s["launches"]["flash_fwd"][1]
                  if key[4] and key[2] != "bfloat16"})
    if bad:
        raise AssertionError(f"{label}: forwards with lse outside bf16: {bad}")


def phase_train_sd3(smi):
    """Phase 31: ``SD3LoRATrainer`` on SD3-medium with T5-XXL at 1024², batch
    1, rank 16 on both streams' attention projections, 4 steps with a
    checkpoint at step 2, then a resume from it for 2 more (equal to the
    straight run), a profiled step, one step's loss and gradients under
    each remat policy against none, and ``cache_latents`` for 2 steps
    (equal to the straight run's checkpoint-2).  Exact launches per step."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from stablediffusion_tpu_torch.ops.attention import ATTENTION_MASKED_LAUNCHES
    from stablediffusion_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
    from stablediffusion_tpu_torch.train import checkpoint as ckpt
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.train.sd3_train import (
        SD3LoRATrainer,
        SD3TrainingArgs,
        SD3TrainStatics,
        make_sd3_encode_fn,
        sd3_lora_loss_fn,
    )
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_train_sd3_")
    model = random_full_model("sd3", device="cuda", seed=21, with_t5=True)
    data = write_image_folder(os.path.join(root, "data"), 4, SD3_RES, seed=5,
                              caption=TRAIN_PROMPT)
    tf = model.transformer_config
    n_joint = tf.num_layers + len(tf.dual_attention_layers)
    clip = (model.text_encoder_config.num_hidden_layers
            + model.text_encoder_2_config.num_hidden_layers)
    t5 = model.text_encoder_3_config.num_layers
    # the towers and T5 encode under no grad; every joint attention is under
    # grad (the LoRA-fused q/k/v) and gets its backward
    want = {"flash_fwd": {"with_lse": n_joint, "causal_no_lse": clip, "other": 0},
            "flash_stream": 1, "flash_bwd_dq": n_joint, "flash_bwd_dkv": n_joint,
            "attention_masked": t5}
    counters = {**_train_counters(), "attention_masked": ATTENTION_MASKED_LAUNCHES}

    def args(out, **kw):
        base = dict(train_batch_size=1, rank=16, learning_rate=1e-4, lr_scheduler="constant",
                    lr_warmup_steps=0, max_train_steps=SD3_TRAIN_STEPS, checkpointing_steps=2,
                    log_every=1, resolution=SD3_RES, output_dir=os.path.join(root, out))
        return SD3TrainingArgs(**{**base, **kw})

    def run(label, a):
        with _TrainProbe("stablediffusion_tpu_torch.train.sd3_train", "make_sd3_encode_fn",
                         None, counters) as probe:
            trainer = SD3LoRATrainer(model, a, data)
            lora = trainer.train()
        _check_steps(label, probe, want)
        _fwd_counts_are_bf16(probe, label)
        return trainer, lora, probe

    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, straight, probe = run("train_sd3_step", args("straight"))
    straight_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    os.makedirs(os.path.join(root, "resumed"))
    shutil.copytree(os.path.join(root, "straight", "checkpoint-2"),
                    os.path.join(root, "resumed", "checkpoint-2"))
    trainer, resumed, _ = run("train_sd3_resumed_step",
                              args("resumed", resume_from_checkpoint="latest"))
    if [s for s, _ in trainer.history] != [3, 4]:
        raise AssertionError(f"resumed history {trainer.history}")
    resume_exact = all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(tree_leaves(straight), tree_leaves(resumed)))
    # every factor moved but the last block's text-query `up`: that block
    # keeps only its image stream, so its add_q_proj feeds nothing (zero
    # gradient, zero start, decay of zero)
    still = sorted(f"{p}.{k}" for p, f in straight["transformer"].items()
                   for k, t in f.items()
                   if torch.equal(t, probe.initial["transformer"][p][k]))
    exempt = [f"transformer_blocks.{tf.num_layers - 1}.attn.add_q_proj.up"]
    walls = [s["wall_s"] for s in probe.steps[1:]]
    summary = {
        "train_sd3": "SD3LoRATrainer SD3-medium + T5-XXL 1024x1024, batch 1, LoRA r16 on both "
                     "streams' attention projections, logit-normal timesteps, AdamW constant "
                     "1e-4, bf16 MM-DiT and towers, fp32 VAE encode, no remat",
        "card": smi, "step_wall_s": [s["wall_s"] for s in probe.steps],
        "timed_steps_images_per_s": len(walls) / sum(walls), "train_call_s": straight_s,
        "peak_memory_gib": peak, "launches_per_step": want, "resumed_equal_bitwise": resume_exact,
        "unmoved_factors": still, "exempt": exempt,
        "lora_params": sum(t.numel() for f in straight["transformer"].values()
                           for t in f.values())}
    print(json.dumps(summary), flush=True)
    if not resume_exact:
        raise AssertionError("the resumed SD3 run differs from the straight run")
    if still != exempt:
        raise AssertionError(f"unmoved factors {still} != the exempt {exempt}")
    step, *call = probe.last_call
    _profile("one SD3-medium + T5-XXL LoRA train step, 1024x1024, batch 1",
             lambda: step(*call)[2]["loss"].item())
    del call, step

    # one step's loss and gradients under each remat policy against no
    # remat, on the same batch and draws, the latents and embeddings
    # encoded apart (cache_latents), so that the peak is the MM-DiT's and
    # not the fp32 1024² encode's
    frozen = probe.last_call[3]
    statics = SD3TrainStatics(
        transformer_config=tf, vae_config=model.vae_config,
        text_config=model.text_encoder_config, text_config_2=model.text_encoder_2_config,
        text_config_3=model.text_encoder_3_config, scheduler_config=model.scheduler_config,
        compute_dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(33)
    h = SD3_RES // model.vae_scale_factor
    shape = (1, model.vae_config.latent_channels, h, h)
    draws = {"latent_eps": torch.randn(shape, generator=g, device="cuda"),
             "noise": torch.randn(shape, generator=g, device="cuda"),
             "density": torch.randn((1,), generator=g, device="cuda")}
    sched = FlowMatchEulerScheduler(model.scheduler_config)
    batch = make_sd3_encode_fn(statics)(frozen, probe.last_call[4], None, draws)
    joint_only = {n: 0 for n in want}
    policies, ref = {}, None
    for policy in ("none", "none", "full", "dots", "offload"):  # the first warms up
        lora = _clone_tree(straight)
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(lora)]
        st = dataclasses.replace(statics, remat_policy=policy)
        snap = {n: (c.count, dict(c.by_shape)) for n, c in counters.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        loss = sd3_lora_loss_fn(lora, frozen, batch, None, st, sched, draws)
        grads = [loss.detach()] + list(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count - snap[n][0] for n, c in counters.items()}
        fwd = counters["flash_fwd"]
        now, prev = _fwd_split(fwd.count, fwd.by_shape), _fwd_split(*snap["flash_fwd"])
        got["flash_fwd"] = {k: now[k] - prev[k] for k in now}
        expect = dict(joint_only, flash_bwd_dq=n_joint, flash_bwd_dkv=n_joint,
                      flash_fwd={"with_lse": n_joint * (1 if policy == "none" else 2),
                                 "causal_no_lse": 0, "other": 0})
        if got != expect:
            raise AssertionError(f"remat {policy}: launches {got} != expected {expect}")
        if ref is None:
            ref = grads
            continue
        worst = max(_max_rel(a, b) for a, b in zip(grads, ref))
        top = torch.cuda.max_memory_allocated()
        policies[policy] = {"wall_s": wall, "peak_memory_gib": top / 2**30,
                            "step_peak_over_held_gib": (top - base) / 2**30,
                            "loss": grads[0].item(), "worst_rel_err_vs_none": worst,
                            "bitwise": all(torch.equal(a, b) for a, b in zip(grads, ref)),
                            "launches": got}
        if policy == "none":
            ref = grads
        elif not worst <= REMAT_TOL:
            raise AssertionError(f"remat {policy}: {worst} from no remat")
        del lora, leaves, loss, grads
    print(json.dumps({"train_sd3_remat": "one step's loss and LoRA gradients per remat "
                      "policy, the same encoded batch and draws (the MM-DiT alone), each "
                      "joint block one region", "card": smi, "tol": REMAT_TOL,
                      "peak_share": REMAT_PEAK_SHARE, "policies": policies}), flush=True)
    none_peak = policies["none"]["step_peak_over_held_gib"]
    for policy in ("full", "offload"):
        if not policies[policy]["step_peak_over_held_gib"] < REMAT_PEAK_SHARE * none_peak:
            raise AssertionError(f"remat {policy} holds {policies[policy]} against none's "
                                 f"{none_peak} GiB")
    del ref

    # cache_latents: the encode apart, under no grad; the same draws in the
    # same order, so its 2 steps give the straight run's checkpoint-2
    _, cached, _ = run("train_sd3_cache_latents_step",
                       args("cached", cache_latents=True, max_train_steps=2,
                            checkpointing_steps=None))
    at2 = ckpt.load_checkpoint(os.path.join(root, "straight", "checkpoint-2"),
                               {"lora": straight})["lora"]
    cache_worst = max(_max_rel(a, b) for (_, a), (_, b) in
                      zip(tree_leaves(cached), tree_leaves(at2)))
    print(json.dumps({"train_sd3_cache_latents": "2 steps with the encode apart against "
                      "the straight run's checkpoint-2", "worst_rel_err": cache_worst,
                      "bitwise": cache_worst == 0.0}), flush=True)
    if not cache_worst == 0.0:
        raise AssertionError(f"cache_latents {cache_worst} from the fused steps")
    del model, straight, resumed, cached, at2, probe, frozen, batch
    # the trained file outlives the phase: phase 37 serves it
    summary["lora_file"] = shutil.copy(
        os.path.join(root, "straight", "pytorch_lora_weights.safetensors"),
        tempfile.mkdtemp(prefix="chip_smoke_sd3_lora_file_"))
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals, by_shape, summary


def phase_full_finetune(smi):
    """Phase 32: full fine-tuning of the full-width SD1.5 UNet at 512², batch
    8, Min-SNR 5, with an EMA (decay 0.9) for 3 steps: the EMA's move
    against its fp64 recomputation's from each step's weights, with two
    controls read through the same check (the EMA left unchanged, and one
    update short); the saved folder reloaded in fp32 through
    ``load_sd_model`` (every UNet tensor equal to the fp32 EMA and apart
    from the initial weights) and rendering one finite image; then 2 steps
    with the 8-bit Adam.  Exact launches per step, every forward with lse
    in bf16, peak memory."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.io.loader import load_sd_model
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_train_full_")
    model = random_full_model("sd15", device="cuda", seed=9)
    model.vae.float()  # as load_sd_model holds it
    data = write_image_folder(os.path.join(root, "data"), FULL_BATCH, 512, seed=6,
                              caption=TRAIN_PROMPT)
    n_tf = _n_tf(model.unet)
    want = {"flash_fwd": {"with_lse": 2 * n_tf,
                          "causal_no_lse": model.text_encoder_config.num_hidden_layers,
                          "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf, "flash_bwd_dkv": 2 * n_tf}
    decay = 0.9

    def args(out, **kw):
        base = dict(train_batch_size=FULL_BATCH, full_finetune=True, train_text_encoder=False,
                    snr_gamma=5.0, learning_rate=1e-4, lr_scheduler="constant",
                    lr_warmup_steps=0, max_train_steps=FULL_STEPS, log_every=1, report_to=None,
                    resolution=512, output_dir=os.path.join(root, out))
        return SDTrainingArgs(**{**base, **kw})

    ref, short = {}, {}

    def fp64_ema(trainable):  # e d + p (1 - d), in fp64, from each step's weights
        if len(probe.steps) == FULL_STEPS:  # the control one update short
            short.update({n: e.float() for n, e in ref.items()})
        for n, p in trainable.items():
            ref[n] = ref[n] * decay + p.double() * (1.0 - decay)

    def move_err(ema, init):
        """(||(ema - init) - (ref - init)|| / ||ref - init|| over the whole
        UNet, the worst tensor's max |gap| / max |move| with its name, max
        move and max |weight|)."""
        gap2 = move2 = 0.0
        worst = (0.0, None, 0.0, 0.0)
        for n, r in ref.items():
            move = r - init[n].double()
            gap = (ema[n].double() - init[n].double()) - move
            gap2 += gap.square().sum().item()
            move2 += move.square().sum().item()
            top, g = move.abs().max().item(), gap.abs().max().item()
            rel = g / top if top > 0 else (0.0 if g == 0 else float("inf"))
            if rel > worst[0]:
                worst = (rel, n, top, r.abs().max().item())
        return (gap2 / move2) ** 0.5, worst

    counters = _train_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    probe = _TrainProbe(after_step=fp64_ema)
    t = time.perf_counter()
    with probe:
        ref.update({n: p.detach().double() for n, p in model.unet.named_parameters()})
        ema = SDLoRATrainer(model, args("ema", use_ema=True, ema_decay=decay), data).train()
    train_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_steps("train_full_step", probe, want)
    _fwd_counts_are_bf16(probe, "full fine-tuning")
    init = probe.initial
    ema_err, ema_worst = move_err(ema, init)
    controls = {"unchanged": move_err(init, init)[0],
                "one_update_short": move_err(short, init)[0]}
    raw = probe.last_call[1]  # the masters after the last step
    still = sorted(n for n in raw if torch.equal(raw[n], init[n]))
    ema_still = sorted(n for n in ema if torch.equal(ema[n], init[n]))
    del ref, short
    out = os.path.join(root, "ema")
    loaded = dict(load_sd_model(out, model_type="sd15", device="cuda",
                                dtype=torch.float32).unet.named_parameters())
    same = sorted(loaded) == sorted(ema) and all(
        loaded[n].dtype == torch.float32 and torch.equal(loaded[n], ema[n]) for n in ema)
    saved_still = sorted(n for n in loaded if torch.equal(loaded[n], init[n]))
    del loaded
    # the render holds the folder as a user loads it (bf16 on the card)
    reloaded = load_sd_model(out, model_type="sd15", device="cuda")
    im = StableDiffusionUnifiedPipeline(device="cuda")(
        reloaded, prompt=TRAIN_PROMPT, seed=0, num_inference_steps=4).images
    summary = {
        "train_full": "SDLoRATrainer full_finetune SD1.5 512x512, batch 8, the whole UNet as "
                      "fp32 masters cast to bf16 at each use, Min-SNR 5, AdamW constant 1e-4, "
                      "EMA 0.9, fp32 VAE encode, no remat",
        "card": smi, "step_wall_s": [s["wall_s"] for s in probe.steps],
        "train_call_s": train_s, "peak_memory_gib": peak, "launches_per_step": want,
        "ema_move_rel_err": ema_err, "ema_tol": EMA_TOL, "ema_controls": controls,
        "ema_worst_tensor": dict(zip(("max_gap_over_max_move", "name", "max_move",
                                      "max_abs_weight"), ema_worst)),
        "unet_tensors": len(ema), "unmoved_masters": still, "unmoved_in_the_ema": ema_still,
        "reloaded_equal_fp32_ema": same, "unmoved_in_the_saved_folder": saved_still,
        "folder_gb": _folder_bytes(out) / 1e9, "image_finite": bool(np.isfinite(im).all()),
        "unet_params": sum(t.numel() for t in ema.values())}
    print(json.dumps(summary), flush=True)
    if not (ema_err <= EMA_TOL < min(controls.values()) and not still and not ema_still
            and same and not saved_still and np.isfinite(im).all()
            and im.shape == (1, 512, 512, 3)):
        raise AssertionError(f"full fine-tuning: {summary}")
    del reloaded, ema, probe, init, raw
    torch.cuda.empty_cache()

    model8 = random_full_model("sd15", device="cuda", seed=9)
    model8.vae.float()
    del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = _TrainProbe()
    with probe:
        trained = SDLoRATrainer(model8, args("adam8", use_8bit_adam=True, max_train_steps=2),
                                data).train()
    _check_steps("train_full_8bit_step", probe, want)
    _fwd_counts_are_bf16(probe, "full fine-tuning, 8-bit Adam")
    still = sorted(n for n in trained if torch.equal(trained[n], probe.initial[n]))
    row = {"train_full_8bit": "the same with the 8-bit Adam, 2 steps", "card": smi,
           "step_wall_s": [s["wall_s"] for s in probe.steps],
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "unmoved_masters": still}
    print(json.dumps(row), flush=True)
    if still:
        raise AssertionError(f"8-bit full fine-tuning left {still} unmoved")
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    del model8, trained, probe
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals, by_shape, summary


def phase_ti_sdxl(smi):
    """Phase 33: textual inversion on the full-width SDXL model at 1024²,
    batch 2, two vectors in both towers (seeded from "x"), 3 steps: every
    other row of both tables unchanged bit for bit, the trained rows in
    the live tables; then ``learned_embeds.safetensors`` loads into a fresh
    model through the handler's model block, and a 4-step request with the
    trigger returns a finite image.  Exact launches per step and for the
    request."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.io.safetensors_io import SafetensorsFile
    from stablediffusion_tpu_torch.serve.handler import Handler, decode_image_b64
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_train_ti_")
    model = random_full_model("sdxl", device="cuda", seed=11)
    data = write_image_folder(os.path.join(root, "data"), 4, SDXL_RES, seed=7,
                              caption=TRAIN_PROMPT)
    towers = ("text_encoder", "text_encoder_2")
    table = lambda m, c: getattr(m, c).text_model.embeddings.token_embedding.weight  # noqa: E731
    orig = {c: table(model, c).detach().clone() for c in towers}
    n_tf = _n_tf(model.unet)
    l1 = model.text_encoder_config.num_hidden_layers
    l2 = model.text_encoder_2_config.num_hidden_layers
    # the spliced tables are under grad, so every tower layer is; the
    # pooled embedding (bigG's) enters the UNet's time embedding, so every
    # UNet attention is too; SDXL reads CLIP-L's penultimate states, so its
    # last layer's attention gets no backward
    want = {"flash_fwd": {"with_lse": 2 * n_tf + l1 + l2, "causal_no_lse": 0, "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf + l1 - 1 + l2,
            "flash_bwd_dkv": 2 * n_tf + l1 - 1 + l2}
    args = SDTrainingArgs(
        train_batch_size=2, textual_inversion=TI_TOKEN, ti_initializer_token="x",
        ti_num_vectors=2, train_text_encoder=False, learning_rate=5e-3,
        lr_scheduler="constant", lr_warmup_steps=0, max_train_steps=3, log_every=1,
        report_to=None, resolution=SDXL_RES, output_dir=os.path.join(root, "out"))
    counters = _train_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with _TrainProbe() as probe:
        rows = SDLoRATrainer(model, args, data).train()
    train_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_steps("train_ti_sdxl_step", probe, want)
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    kept, written = {}, {}
    for c, key in zip(towers, ("embeddings", "embeddings_2")):
        now, n = table(model, c), orig[c].shape[0]
        kept[c] = bool(torch.equal(now[:n], orig[c]))
        written[c] = bool(torch.equal(now[n:], rows[key].to(now.dtype)))
    moved = {k: _max_rel(v, probe.initial[k]) for k, v in rows.items()}
    step_walls = [s["wall_s"] for s in probe.steps]
    path = os.path.join(args.output_dir, "learned_embeds.safetensors")
    with SafetensorsFile(path) as f:
        saved = {k: f.torch_tensor(k).clone() for k in f.keys()}
    rows = {k: v.cpu() for k, v in rows.items()}
    del model, probe, orig
    torch.cuda.empty_cache()

    fresh = random_full_model("sdxl", device="cuda", seed=11)
    handler = Handler(model=fresh)
    for c in counters.values():
        c.reset()
    steps = 4
    t = time.perf_counter()
    resp = handler({"prompt": f"a photo of {TI_TOKEN}", "seed": 0, "height": SDXL_RES,
                    "width": SDXL_RES, "num_inference_steps": steps, "guidance_scale": 7.5,
                    "model": {"textual_inversion": [{"path": path, "token": TI_TOKEN}]}},
                   "ti")
    wall = time.perf_counter() - t
    if "error" in resp:
        raise AssertionError(f"the trained embedding's request failed: {resp}")
    im = decode_image_b64(resp["images"][0])
    got = {n: counters[n].count for n in ("flash_fwd", "flash_stream")}
    want_req = _want(fresh, steps, 1)
    loaded = {c: table(fresh, c)[-2:].detach().cpu() for c in towers}
    row = {
        "train_ti_sdxl": "SDLoRATrainer textual inversion, SDXL 1024x1024, batch 2, 2 vectors "
                         "in both towers, AdamW constant 5e-3, bf16 UNet, fp32 towers and VAE "
                         "encode, no remat",
        "card": smi, "step_wall_s": step_walls, "train_call_s": train_s, "peak_memory_gib": peak,
        "launches_per_step": want, "other_rows_unchanged": kept, "rows_in_tables": written,
        "rows_moved_rel": moved, "file_keys": sorted(saved),
        "request_wall_s": wall, "request_launches": got, "expected_request_launches": want_req,
        "image_shape": list(im.shape)}
    print(json.dumps(row), flush=True)
    file_ok = (sorted(saved) == ["clip_g", "clip_l"]
               and torch.equal(saved["clip_l"], rows["embeddings"])
               and torch.equal(saved["clip_g"], rows["embeddings_2"])
               and torch.equal(loaded["text_encoder"], rows["embeddings"])
               and torch.equal(loaded["text_encoder_2"], rows["embeddings_2"]))
    if not (all(kept.values()) and all(written.values()) and file_ok and got == want_req
            and im.shape == (SDXL_RES, SDXL_RES, 3) and np.isfinite(im).all()
            and moved["embeddings"] > 0):
        raise AssertionError(f"textual inversion on SDXL: {row}, file {file_ok}")
    del fresh, handler
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals, by_shape, row


def phase_dreambooth(smi):
    """Phase 34: DreamBooth with prior preservation on the full-width SD1.5
    model at 512²: the port's pipeline renders the 2 missing class images on
    the card (one 25-step CFG call of 2 images), then 2 LoRA steps on
    [instance | class] batches.  Exact launches for the render and each
    step."""
    import shutil
    import tempfile

    import torch
    from PIL import Image

    import stablediffusion_tpu_torch.train.trainer as trainer_mod
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_train_db_")
    model = random_full_model("sd15", device="cuda", seed=12)
    model.vae.float()
    inst = write_image_folder(os.path.join(root, "instance"), 2, 512, seed=8)
    cls = os.path.join(root, "class")
    n_tf = _n_tf(model.unet)
    want = {"flash_fwd": {"with_lse": 2 * n_tf,
                          "causal_no_lse": model.text_encoder_config.num_hidden_layers,
                          "other": 0},
            "flash_stream": 1, "flash_bwd_dq": 2 * n_tf, "flash_bwd_dkv": 2 * n_tf}
    args = SDTrainingArgs(
        train_batch_size=1, rank=16, train_text_encoder=False, learning_rate=1e-4,
        lr_scheduler="constant", lr_warmup_steps=0, max_train_steps=2, log_every=1,
        report_to=None, resolution=512, instance_prompt="a photo of sks dog",
        with_prior_preservation=True, class_data_dir=cls, class_prompt="a photo of dog",
        num_class_images=2, sample_batch_size=2, output_dir=os.path.join(root, "out"))
    counters = _train_counters()
    for c in counters.values():
        c.reset()
    render = {}
    orig = trainer_mod.SDLoRATrainer._ensure_class_images

    def counted(trainer):
        snap = {n: c.count for n, c in counters.items()}
        t = time.perf_counter()
        orig(trainer)
        torch.cuda.synchronize()
        render.update(wall_s=time.perf_counter() - t,
                      launches={n: c.count - snap[n] for n, c in counters.items()})

    trainer_mod.SDLoRATrainer._ensure_class_images = counted
    try:
        with _TrainProbe() as probe:
            trainer = SDLoRATrainer(model, args, inst)
            trainer.train()
    finally:
        trainer_mod.SDLoRATrainer._ensure_class_images = orig
    _check_steps("train_dreambooth_step", probe, want)
    want_render = dict(_want(model, 25, 1), flash_bwd_dq=0, flash_bwd_dkv=0)
    files = sorted(os.listdir(cls))
    sizes = [Image.open(os.path.join(cls, f)).size for f in files]
    row = {"train_dreambooth": "SD1.5 512x512 DreamBooth, prior preservation: 2 class images "
                               "rendered, then LoRA r16 on [instance | class] batches",
           "card": smi, "render": render, "expected_render_launches": want_render,
           "class_files": files, "step_wall_s": [s["wall_s"] for s in probe.steps],
           "history": trainer.history}
    print(json.dumps(row), flush=True)
    if render.get("launches") != want_render or files != ["class-0.jpg", "class-1.jpg"] \
            or sizes != [(512, 512)] * 2:
        raise AssertionError(f"DreamBooth class render: {row}")
    totals = {n: c.count for n, c in counters.items()}
    by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
    del model, trainer, probe
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals, by_shape, row


# -- the rest of serving: int8 quantization and checkpoints, SD3 LoRA
# adapters, the web UI and the queue entry -----------------------------------

INT8_MODES = ("w8", "w8a8", "w8a8:2048")
# one full-width UNet forward through the int8 modules, card (bf16, the
# kernels) against the CPU (fp32, the plain attention) on the same int8
# modules and inputs, held against the same two paths without quantization:
# "w8" dequantizes its weights to bf16 on the card, as a bf16 UNet holds
# them, so it may lie as far from the CPU as the bf16 UNet does, with
# UNET_SLACK's margin; "w8a8" quantizes bf16 activations on the card and
# fp32 ones on the CPU, and a code that one rounding puts on the other side
# of a midpoint moves by a whole step, so its limit is INT8_A8_SLACK times
# the bf16 UNet's distance
INT8_A8_SLACK = 4.0
# the int8 SDXL folder's UNet against the bf16 UNet, in allocated bytes
INT8_FOLDER_SHARE = 0.55
INT8_SD15_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", seed=0)
# the quantized UNet forward's inputs: 32x32 latents keep the CPU's fp32
# forward of the full-width UNet to seconds
INT8_REF_HW = 32
# denoise steps timed per configuration (one warm-up first)
INT8_TIMING_REPS = 3


def _int8_calls():
    """The int8 products counted so far, by kind and mode."""
    from stablediffusion_tpu_torch.ops.quant import INT8_CONV_CALLS, INT8_LINEAR_CALLS

    return {"int8_linear": dict(INT8_LINEAR_CALLS.by_mode),
            "int8_conv2d": dict(INT8_CONV_CALLS.by_mode)}


def _reset_int8():
    from stablediffusion_tpu_torch.ops.quant import INT8_CONV_CALLS, INT8_LINEAR_CALLS

    INT8_LINEAR_CALLS.reset()
    INT8_CONV_CALLS.reset()


def _int8_plan(tower, n_evals):
    """The int8 products of `n_evals` forwards of `tower`: each int8 layer
    runs once a forward."""
    from stablediffusion_tpu_torch.ops.quant import QUANT_MODES, Int8Conv2d, Int8Linear

    plan = {k: {m: 0 for m in QUANT_MODES} for k in ("int8_linear", "int8_conv2d")}
    for m in tower.modules():
        if isinstance(m, Int8Linear):
            plan["int8_linear"][m.mode] += n_evals
        elif isinstance(m, Int8Conv2d):
            plan["int8_conv2d"][m.mode] += n_evals
    return plan


def _tensor_bytes(module) -> int:
    import itertools

    return sum(t.numel() * t.element_size()
               for t in itertools.chain(module.parameters(), module.buffers()))


def _fp_copy_bytes(model) -> int:
    """Bytes of the floating-point modules a quantized tower keeps for
    re-quantization (``AdapterHolder._fp_modules``)."""
    return sum(_tensor_bytes(m) for m in model._fp_modules.values())


def _psnr(img, ref) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(img, np.float64) - np.asarray(ref, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def _unet_inputs(model, B, hw, device, dtype, seed=5):
    """(x, t, ctx, added) of one UNet call at batch B on hw x hw latents."""
    import torch

    cfg = model.unet.config
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, cfg.in_channels, hw, hw, generator=g)
    ctx = torch.randn(B, 77, cfg.cross_attention_dim, generator=g)
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        res = float(hw * model.vae_scale_factor)
        added = {"text_embeds": torch.randn(B, pooled, generator=g).to(device, dtype),
                 "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * B, device=device)}
    return (x.to(device, dtype), torch.tensor(500, device=device), ctx.to(device, dtype),
            added)


def _unet_card_vs_cpu(model):
    """One forward of the model's UNet at B=1 on INT8_REF_HW latents: the
    card in its dtype against a CPU fp32 copy of the same modules (int8
    codes and scales kept, the rest fp32) on the same inputs.  Returns
    (rel err, the CPU output)."""
    import torch

    dtype = next(model.unet.parameters()).dtype
    with torch.inference_mode():
        card = model.unet(*_unet_inputs(model, 1, INT8_REF_HW, "cuda", dtype)).float().cpu()
        cpu_unet = copy.deepcopy(model.unet).cpu().float()
        ref = cpu_unet(*_unet_inputs(model, 1, INT8_REF_HW, "cpu", torch.float32))
    return _rel_err(card, ref), ref


def _all_kernels_ms(fn, reps):
    """Device time of one call of `fn`: every CUDA kernel event of `reps`
    calls under torch.profiler, summed, over `reps`.  A profiling run that
    kept no kernel time is repeated; after three, the calls are timed with CUDA
    events, and a ``device_ms_fallback`` line says so (as ``_device_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    ms = _time_ms(fn, reps)
    print(json.dumps({"device_ms_fallback": "all kernels", "event_ms": ms,
                      "why": "torch.profiler kept no kernel event in 3 runs"}), flush=True)
    return ms


def _time_step(model, batch, label, card):
    """One denoise step's UNet call at `batch` prompts under CFG (2 x batch
    rows) on the model's native latents: device ms (profiler kernels) and
    event ms; the int8 products of one call; printed and returned."""
    import torch

    hw = model.unet.config.sample_size
    dtype = next(model.unet.parameters()).dtype
    args = _unet_inputs(model, 2 * batch, hw, "cuda", dtype, seed=6)
    with torch.inference_mode():
        fn = lambda: model.unet(*args)  # noqa: E731
        fn()
        _reset_int8()
        fn()
        calls = _int8_calls()
        from stablediffusion_tpu_torch.ops.quant import INT8_LINEAR_CALLS

        padded = INT8_LINEAR_CALLS.padded
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        device_ms = _all_kernels_ms(fn, INT8_TIMING_REPS)
        event_ms = _time_ms(fn, INT8_TIMING_REPS)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    row = {"int8_step": label, "model": model.model_type, "batch": batch,
           "unet_rows": 2 * batch, "latents": hw, "mode": model.quant_mode or "bf16",
           "device_ms": device_ms, "event_ms": event_ms, "int8_calls": calls,
           "padded_rows_calls": padded, "unet_bytes": _tensor_bytes(model.unet),
           "fp_copy_bytes": _fp_copy_bytes(model), "peak_over_held_gib": peak,
           "card": card}
    print(json.dumps(row), flush=True)
    return row


def _int_mm_vs_bf16(card):
    """``torch._int_mm`` against a bf16 ``torch.matmul`` at the main linear
    shapes, and the whole ``int8_linear`` (w8a8, w8) against the bf16
    linear, device ms from the profiler."""
    import torch
    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops.quant import int8_linear, quantized_layer

    rows = []
    for label, M, K, N in (("sdxl ff.net.0.proj", 8192, 1280, 10240),
                           ("sd15 attn 320->320", 8192, 320, 320)):
        g = torch.Generator(device="cuda").manual_seed(0)
        a8 = torch.randint(-127, 128, (M, K), device="cuda", dtype=torch.int8, generator=g)
        b8 = torch.randint(-127, 128, (N, K), device="cuda", dtype=torch.int8, generator=g).t()
        x = torch.randn(M, K, device="cuda", dtype=torch.bfloat16, generator=g)
        lin = torch.nn.Linear(K, N, device="cuda", dtype=torch.bfloat16)
        wt = lin.weight.t()
        q8, qw = quantized_layer(lin, "w8a8"), quantized_layer(lin, "w8")
        ops = 2.0 * M * K * N
        r = {"int_mm_vs_bf16": label, "M": M, "K": K, "N": N,
             "int_mm_ms": _all_kernels_ms(lambda: torch._int_mm(a8, b8), 20),
             "bf16_matmul_ms": _all_kernels_ms(lambda: torch.matmul(x, wt), 20),
             "int8_linear_w8a8_ms": _all_kernels_ms(lambda: int8_linear(q8, x), 20),
             "int8_linear_w8_ms": _all_kernels_ms(lambda: int8_linear(qw, x), 20),
             "bf16_linear_ms": _all_kernels_ms(lambda: F.linear(x, lin.weight, lin.bias), 20),
             "card": card}
        r["int_mm_tops"] = ops / r["int_mm_ms"] / 1e9
        r["bf16_tflops"] = ops / r["bf16_matmul_ms"] / 1e9
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


def phase_int8(smi):
    """Phase 35: int8 serving.  The full-width SD1.5 model quantized as
    "w8", "w8a8" and "w8a8:2048" answers one 512² request each (20 DDIM
    steps, CFG 7.5) with phase 2's launches exactly and the int8 products
    its quantized modules plan; one UNet forward per mode on the card
    against the CPU's fp32 forward of the same int8 modules; each image
    against the bf16 one.  SDXL at 1024² under "w8a8:2048" the same (its
    ``add_embedding`` and GEGLU projections through the int8 dispatch).
    The denoise step timed in each mode and in bf16 at SD1.5 batch 1 and 8
    and SDXL batch 1, ``torch._int_mm`` against bf16 at the main linear
    shapes, the UNet's resident bytes.  Returns (launches by path, rows,
    the SDXL model quantized "w8a8:2048", its 1024² image, the bf16 SDXL
    UNet's bytes, the SD1.5 model unquantized)."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.ops.quant import INT8_LINEAR_CALLS, Int8Linear
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils.testing import random_full_model

    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    pipe = StableDiffusionUnifiedPipeline(device="cuda")
    launches, steps_rows = {}, []

    def request(model, label, res, want, ref_img=None):
        n_evals = 20
        plan = _int8_plan(model.unet, n_evals)
        for c in counters.values():
            c.reset()
        _reset_int8()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pipe(model, height=res, width=res, num_inference_steps=n_evals,
                   guidance_scale=7.5, **INT8_SD15_REQUEST)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count for n, c in counters.items()}
        calls = _int8_calls()
        im = out.images
        row = {"int8_request": label, "mode": model.quant_mode or "bf16", "wall_s": wall,
               "launches": got, "expected_launches": want, "int8_calls": calls,
               "expected_int8_calls": plan, "padded_rows_calls": INT8_LINEAR_CALLS.padded,
               "held_gib": held / 2**30,
               "peak_over_held_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
               "unet_bytes": _tensor_bytes(model.unet), "fp_copy_bytes": _fp_copy_bytes(model),
               "card": smi}
        if ref_img is not None:
            row.update(max_abs_vs_bf16=float(np.abs(im - ref_img).max()),
                       mean_abs_vs_bf16=float(np.abs(im - ref_img).mean()),
                       psnr_vs_bf16_db=_psnr(im, ref_img))
        print(json.dumps(row), flush=True)
        if im.shape != (1, res, res, 3) or not np.isfinite(im).all():
            raise AssertionError(f"{label}: bad output {im.shape}")
        if got != want:
            raise AssertionError(f"{label}: launches {got} != expected {want}")
        if calls != plan:
            raise AssertionError(f"{label}: int8 products {calls} != planned {plan}")
        launches[label] = got
        return im

    t_phase = time.perf_counter()

    def mark(what):
        print(json.dumps({"phase_int8_at_s": time.perf_counter() - t_phase, "done": what}),
              flush=True)

    # SD1.5 512²
    model = random_full_model("sd15", device="cuda", seed=0)
    want = _want(model, 20, 1)
    bf16_img = request(model, "int8_sd15_bf16", 512, want)
    mark("sd15 bf16 request")
    e_fp, ref_fp = _unet_card_vs_cpu(model)
    mark("sd15 bf16 card vs cpu")
    sd15_bf16_bytes = _tensor_bytes(model.unet)
    steps_rows += [_time_step(model, b, "sd15_bf16", smi) for b in (1, 8)]
    for mode in INT8_MODES:
        model.quantize(mode)
        label = f"int8_sd15_{mode}"
        request(model, label, 512, want, bf16_img)
        e_q, ref_q = _unet_card_vs_cpu(model)
        e_quant = _rel_err(ref_q, ref_fp)
        limit = (UNET_SLACK if mode == "w8" else INT8_A8_SLACK) * e_fp
        print(json.dumps({"int8_unet_card_vs_cpu": mode, "model": "sd15",
                          "latents": INT8_REF_HW, "card_int8_vs_cpu_int8": e_q,
                          "card_bf16_vs_cpu_fp32_unquantized": e_fp,
                          "cpu_int8_vs_cpu_fp32 (quantization)": e_quant, "limit": limit,
                          "card": smi}), flush=True)
        if not e_q <= limit:
            raise AssertionError(f"{mode}: the card's int8 UNet lies {e_q} from the CPU's, "
                                 f"limit {limit}")
        steps_rows += [_time_step(model, b, f"sd15_{mode}", smi) for b in (1, 8)]
        mark(f"sd15 {mode}")
    model.quantize(None)
    if _tensor_bytes(model.unet) != sd15_bf16_bytes:
        raise AssertionError("quantize(None) left the UNet's bytes changed")

    # SDXL 1024²
    xl = random_full_model("sdxl", device="cuda", seed=0)
    want_xl = _want(xl, 20, 1)
    xl_bytes = _tensor_bytes(xl.unet)
    xl_bf16_img = request(xl, "int8_sdxl_bf16", SDXL_RES, want_xl)
    steps_rows.append(_time_step(xl, 1, "sdxl_bf16", smi))
    for mode in ("w8", "w8a8", "w8a8:2048"):
        xl.quantize(mode)
        row = _time_step(xl, 1, f"sdxl_{mode}", smi)
        steps_rows.append(row)
        # full w8a8 quantizes add_embedding's two linears, whose rows are
        # the batch's: padded for the int8 GEMM, each call counted
        want_padded = 2 if mode == "w8a8" else 0
        if row["padded_rows_calls"] != want_padded:
            raise AssertionError(f"sdxl {mode}: {row['padded_rows_calls']} padded calls, "
                                 f"expected {want_padded}")
    layers = dict(xl.unet.named_modules())
    geglu = [p for p in layers if p.endswith("ff.net.0.proj")]
    for p in ["add_embedding.linear_1", "add_embedding.linear_2", *geglu]:
        if not isinstance(layers[p], Int8Linear):
            raise AssertionError(f"sdxl w8a8:2048: {p} is not int8")
    if {layers[p].mode for p in geglu} != {"w8a8"}:
        raise AssertionError("sdxl w8a8:2048: a GEGLU projection is not w8a8")
    mark("sdxl timing")
    xl_img = request(xl, "int8_sdxl_w8a8:2048", SDXL_RES, want_xl, xl_bf16_img)
    mark("sdxl w8a8:2048 request")
    mm_rows = _int_mm_vs_bf16(smi)
    print(json.dumps({"int8_resident_bytes": {"sd15_bf16_unet": sd15_bf16_bytes,
                                              "sdxl_bf16_unet": xl_bytes},
                      "card": smi}), flush=True)
    return launches, steps_rows + mm_rows, xl, xl_img, xl_bytes, model


def phase_int8_checkpoints(smi, xl, xl_img, xl_bf16_bytes, sd15):
    """Phase 36: int8 checkpoints.  The SDXL model quantized "w8a8:2048"
    written by ``save_sd_model(quantize=)`` and loaded back: ``quant_frozen``,
    every UNet tensor and a UNet forward equal bit for bit, the 1024²
    request's image equal to the in-memory model's, the UNet's allocated
    bytes at most INT8_FOLDER_SHARE of the bf16 UNet's, LoRA fusion
    refused.  Then the SD1.5 model's fp folder through
    ``python -m stablediffusion_tpu_torch.io.quantize_cli`` (on the CPU):
    its UNet equal to the in-memory "w8a8" quantization on the card.
    Returns (the folder root, the int8 SD1.5 folder's name)."""
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.io.loader import load_sd_model, save_sd_model
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

    root = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    folder = os.path.join(root, "sdxl_int8")
    t = time.perf_counter()
    save_sd_model(xl, folder, quantize="w8a8:2048")
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    loaded = load_sd_model(folder)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    if not (loaded.quant_frozen and loaded.quant_mode == "w8a8:2048"):
        raise AssertionError(f"int8 folder loaded as {loaded.quant_mode} "
                             f"frozen={loaded.quant_frozen}")
    a, b = xl.unet.state_dict(), loaded.unet.state_dict()
    if a.keys() != b.keys() or not all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                       for k in a):
        raise AssertionError("the int8 folder's UNet differs from the quantized model's")
    args = _unet_inputs(xl, 2, xl.unet.config.sample_size, "cuda", torch.bfloat16)
    with torch.inference_mode():
        same_forward = torch.equal(xl.unet(*args), loaded.unet(*args))
    # the synthetic vocabulary's bigG pad (id 0) is not "!", which is what
    # the tokenizer folder records a pad as, so the loaded model takes the
    # in-memory model's tokenizers for the image's comparison
    loaded.tokenizer, loaded.tokenizer_2 = xl.tokenizer, xl.tokenizer_2
    out = StableDiffusionUnifiedPipeline(device="cuda")(
        loaded, height=SDXL_RES, width=SDXL_RES, num_inference_steps=20, guidance_scale=7.5,
        **INT8_SD15_REQUEST).images
    loaded_bytes = _tensor_bytes(loaded.unet)
    share = loaded_bytes / xl_bf16_bytes
    try:
        loaded.load_loras({"style": 1.0}, lora_dir=root)
        refused = None
    except ValueError as e:
        refused = str(e)
    row = {"int8_folder": "sdxl w8a8:2048", "bytes_on_disk": _folder_bytes(folder),
           "unet_bytes_on_disk": _folder_bytes(os.path.join(folder, "unet")),
           "save_s": save_s, "load_s": load_s, "unet_allocated_bytes": loaded_bytes,
           "bf16_unet_bytes": xl_bf16_bytes, "share": share, "limit": INT8_FOLDER_SHARE,
           "forward_bit_equal": same_forward,
           "image_bit_equal": bool(np.array_equal(out, xl_img)),
           "image_max_abs_diff": float(np.abs(out - xl_img).max()),
           "lora_fusion_refused": refused, "card": smi}
    print(json.dumps(row), flush=True)
    if not (same_forward and row["image_bit_equal"]):
        raise AssertionError("the loaded int8 SDXL model renders otherwise than the in-memory one")
    if share > INT8_FOLDER_SHARE:
        raise AssertionError(f"int8 SDXL UNet holds {share:.3f} of the bf16 UNet's bytes")
    if not refused or "requires fp weights" not in refused:
        raise AssertionError(f"LoRA fusion on a frozen int8 model: {refused}")
    del loaded, xl
    torch.cuda.empty_cache()

    # the quantize CLI, on the CPU, over the SD1.5 model's fp folder
    src, dst = os.path.join(root, "sd15_fp"), os.path.join(root, "sd15_int8")
    save_sd_model(sd15, src)
    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "stablediffusion_tpu_torch.io.quantize_cli", src, dst,
         "--mode", "w8a8"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t
    if cli.returncode != 0:
        raise AssertionError(f"quantize_cli exited {cli.returncode}: {cli.stderr[-2000:]}")
    loaded = load_sd_model(dst)
    sd15.quantize("w8a8")
    a, b = sd15.unet.state_dict(), loaded.unet.state_dict()
    equal = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    print(json.dumps({"quantize_cli": "python -m stablediffusion_tpu_torch.io.quantize_cli "
                      "sd15_fp sd15_int8 --mode w8a8 (CPU)", "stdout": cli.stdout.strip(),
                      "wall_s": cli_s, "bytes_src": _folder_bytes(src),
                      "bytes_dst": _folder_bytes(dst), "frozen": loaded.quant_frozen,
                      "unet_equal_to_card_quantization": equal, "card": smi}), flush=True)
    if not (equal and loaded.quant_frozen and loaded.quant_mode == "w8a8"):
        raise AssertionError("the quantize CLI's SD1.5 folder differs from the card's w8a8")
    sd15.quantize(None)
    del loaded
    torch.cuda.empty_cache()
    return root, "int8"


def phase_front_doors(smi, root, name, sd15):
    """Phase 38: the worker over the CLI's int8 SD1.5 folder (its own
    ``--model_name`` load, max_batch 4): GET /ui answers ``index_html()``,
    a ``build_ui_request`` payload POSTed answers a 512² image with phase
    2's launches and the folder's planned int8 products, and
    ``trigger_fn`` answers the same job with the same image.  Returns the
    launches by path."""
    import http.client
    import shutil
    import threading

    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.serve import worker
    from stablediffusion_tpu_torch.serve.webapp import build_ui_request, index_html

    server = worker.build(worker.parse_args([
        "--host", "127.0.0.1", "--port", "0", "--model_dir", root, "--model_type", "sd15",
        "--model_name", name, "--max_batch", "4"]))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    launches = {}
    try:
        port = server.server_address[1]
        model = server.handler.model
        if not (model.quant_frozen and model.quant_mode == "w8a8"):
            raise AssertionError("the worker did not load the int8 folder frozen")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/ui")
        resp = conn.getresponse()
        page = resp.read().decode()
        conn.close()
        ui_ok = resp.status == 200 and page == index_html()
        print(json.dumps({"front_door": "GET /ui", "status": resp.status,
                          "bytes": len(page), "equals_index_html": ui_ok}), flush=True)
        if not ui_ok:
            raise AssertionError(f"GET /ui answered {resp.status}")
        counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
        want = _want(model, 20, 1)
        plan = _int8_plan(model.unet, 20)
        body = build_ui_request("txt2img", INT8_SD15_REQUEST["prompt"], steps=20, cfg=7.5,
                                seed=11, width=512, height=512, scheduler="DDIM")
        _reset_int8()
        reply, _ = _ask(port, counters, smi, "front_door_ui_payload", body, want)
        if _int8_calls() != plan:
            raise AssertionError(f"UI payload: int8 products {_int8_calls()} != {plan}")
        launches["front_door_ui"] = want
        before = {n: c.count for n, c in counters.items()}
        _reset_int8()
        t = time.perf_counter()
        queued = worker.trigger_fn({"id": "queue", "input": body})
        wall = time.perf_counter() - t
        got = {n: c.count - before[n] for n, c in counters.items()}
        same = queued.get("images") == reply["images"] and queued.get("seed") == 11
        print(json.dumps({"front_door": "trigger_fn", "wall_s": wall, "launches": got,
                          "expected_launches": want, "int8_calls": _int8_calls(),
                          "same_images_as_post": same, "card": smi}), flush=True)
        if "error" in queued or got != want or _int8_calls() != plan or not same:
            raise AssertionError(f"trigger_fn: {queued.get('error')} launches {got}")
        launches["front_door_trigger_fn"] = got
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches


def phase_sd3_lora(smi, lora_file):
    """Phase 37: SD3 LoRA serving.  Phase 31's trained file (on the same
    base, seed 21) through the handler's model block ``{"loras":
    {"trained": 1.0}}``: one 1024² request with phase 26's launches; every
    fused weight within one bf16 ulp of the CPU's fp32 base + B·A (and the
    fp32 tolerance of ``tests/test_torch_lora.py``); then a request under ``quantize: "w8a8"`` with exact
    launches and int8 products; then ``quantize: null`` and ``loras: []``
    give every MM-DiT and CLIP weight back bit for bit, T5 never written.
    Returns the launches by path."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.lora.core import delta_w
    from stablediffusion_tpu_torch.serve.handler import Handler, decode_image_b64
    from stablediffusion_tpu_torch.utils.testing import random_full_model

    root = tempfile.mkdtemp(prefix="chip_smoke_sd3_lora_")
    shutil.copy(lora_file, os.path.join(root, "sd3_trained.safetensors"))
    model = random_full_model("sd3", device="cuda", seed=21, with_t5=True)
    comps = ("transformer", "text_encoder", "text_encoder_2")
    before = {c: {k: v.clone() for k, v in getattr(model, c).state_dict().items()}
              for c in comps}
    t5_versions = {k: p._version for k, p in model.text_encoder_3.named_parameters()}
    handler = Handler(model=model, lora_dir=root)
    counters = _sd3_counters()
    want = _want_sd3(model, SD3_STEPS, 1)
    req = dict(SD3_REQUESTS[0], height=SD3_RES, width=SD3_RES, num_inference_steps=SD3_STEPS,
               guidance_scale=SD3_CFG)
    launches = {}

    def ask(label, block, plan=None):
        for c in counters.values():
            c.reset()
        _reset_int8()
        t = time.perf_counter()
        reply = handler({**req, "model": block}, label)
        wall = time.perf_counter() - t
        got = {n: c.count for n, c in counters.items()}
        row = {"sd3_lora_request": label, "block": block, "wall_s": wall, "launches": got,
               "expected_launches": want, "int8_calls": _int8_calls(),
               "expected_int8_calls": plan, "card": smi}
        print(json.dumps(row), flush=True)
        if "error" in reply:
            raise AssertionError(f"{label}: {reply['error']}\n{reply.get('traceback')}")
        px = decode_image_b64(reply["images"][0])
        if px.shape != (SD3_RES, SD3_RES, 3) or not np.isfinite(px).all():
            raise AssertionError(f"{label}: image {px.shape}")
        if got != want:
            raise AssertionError(f"{label}: launches {got} != expected {want}")
        if plan is not None and _int8_calls() != plan:
            raise AssertionError(f"{label}: int8 products {_int8_calls()} != {plan}")
        launches[label] = got

    ask("sd3_lora", {"loras": {"trained": 1.0}})
    if model.get_list_adapters() != {"trained": 1.0}:
        raise AssertionError(f"sd3 adapters {model.get_list_adapters()}")
    adapter = model._adapter_store["trained"]
    worst, n_fused = 0.0, 0
    for comp, tree in adapter.items():
        module = getattr(model, comp)
        for path, f in tree.items():
            key = f"{path}.weight"
            base = model._pristine[comp][key].float().cpu()
            want_w = base + delta_w({k: v.cpu() for k, v in f.items()}).t()
            got_w = module.get_submodule(path).weight.float().cpu()
            # the fp32 sum rounded once to bf16 (the card's B.A may put it on
            # the other side of a midpoint: one bf16 ulp), plus the fp32
            # tolerance of tests/test_torch_lora.py
            lim = torch.finfo(torch.bfloat16).eps * want_w.abs() + 1e-6 * want_w.abs().max()
            worst = max(worst, ((got_w - want_w).abs() / lim.clamp_min(1e-30)).max().item())
            n_fused += 1
    print(json.dumps({"sd3_lora_fused": n_fused, "components": sorted(adapter),
                      "worst_over_limit": worst,
                      "limit": "one bf16 ulp of base + B.A (fp32) + 1e-6 of its max"}),
          flush=True)
    if not (n_fused and worst <= 1.0):
        raise AssertionError(f"sd3 fused weights {worst} over the limit ({n_fused} fused)")
    # quantized over the fused weights; the request naming the same mode
    # again quantizes nothing more
    handler.maybe_reload_model({"quantize": "w8a8"})
    ask("sd3_lora_w8a8", {"quantize": "w8a8"}, _int8_plan(model.transformer, SD3_STEPS))
    handler.maybe_reload_model({"quantize": None, "loras": []})
    restored = all(torch.equal(before[c][k], v)
                   for c in comps for k, v in getattr(model, c).state_dict().items())
    t5_untouched = t5_versions == {k: p._version
                                   for k, p in model.text_encoder_3.named_parameters()}
    print(json.dumps({"sd3_lora_delete": "quantize null + loras []",
                      "weights_bit_equal": restored, "t5_never_written": t5_untouched,
                      "adapters": model.get_list_adapters()}), flush=True)
    if not (restored and t5_untouched and model.get_list_adapters() == {}):
        raise AssertionError("sd3 delete_adapters did not restore the weights")
    del model, handler, before
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# -- the pipeline extensions (phases 39-41) ----------------------------------
EXT_RES = 512
EXT_STEPS = 20
EXT_CFG = 7.5
EXT_PROMPT = "a photograph of an astronaut riding a horse"
EXT_WEIGHTED = "a (photograph:1.3) of an [astronaut:robot:0.5] riding a ((horse))"
# more than 75 tokens of the char-level tokenizer: two chunks
EXT_LONG = "a photograph of an astronaut riding a horse on the moon " * 2
EXT_PAG = 3.0
EXT_CACHE_INTERVAL = 3
EXT_HIRES_STRENGTH = 0.7
EXT_IP2P_IMAGE_CFG = 1.5


def _unet_call_launches(unet, shallow=False, perturb=(), ip=False):
    """``flash_fwd`` launches of one UNet call: for each transformer block
    the call runs, its self-attention unless PAG perturbs the block's group,
    its cross-attention, and IP-Adapter's image attention where the block's
    attn2 holds ``to_k_ip`` and image tokens are given; a shallow (DeepCache)
    call runs the first down block and the last up block alone."""
    from stablediffusion_tpu_torch.models.unet import BasicTransformerBlock

    groups = [("down", b) for b in (unet.down_blocks[:1] if shallow else unet.down_blocks)]
    if not shallow:
        groups.append(("mid", unet.mid_block))
    groups += [("up", b) for b in (unet.up_blocks[-1:] if shallow else unet.up_blocks)]
    n = 0
    for group, block in groups:
        for m in block.modules():
            if isinstance(m, BasicTransformerBlock):
                n += int(group not in perturb) + 1 + int(ip and hasattr(m.attn2, "to_k_ip"))
    return n


def _ext_plan(model, n_full, n_shallow=0, pag=(), ip=False, cn=False, clip_encodes=2,
              vision=0, resampler=0, streams=1):
    """(launches by kernel, flash_fwd by part) of one request: `clip_encodes`
    tower passes of every layer, `n_full` full and `n_shallow` shallow UNet
    calls, a PAG call per full step, the ControlNet's attentions each step,
    `vision` image-encoder passes, `resampler` Resampler passes of its depth,
    and `streams` VAE mid-block attentions."""
    steps = n_full + n_shallow
    parts = {
        "clip": clip_encodes * _clip_layers(model),
        "unet_full": n_full * _unet_call_launches(model.unet, ip=ip),
        "unet_shallow": n_shallow * _unet_call_launches(model.unet, shallow=True, ip=ip),
        "pag": n_full * _unet_call_launches(model.unet, perturb=pag, ip=ip) if pag else 0,
        "controlnet": steps * 2 * _n_tf(model.controlnet) if cn else 0,
        "vision": vision * model.image_encoder_config.num_hidden_layers if vision else 0,
        "resampler": resampler * (model.ip_adapter.config.depth if resampler else 0),
    }
    return {"flash_fwd": sum(parts.values()), "flash_stream": streams}, parts


def _add_plans(*plans):
    want = {k: sum(p[0][k] for p in plans) for k in plans[0][0]}
    parts = {k: sum(p[1][k] for p in plans) for k in plans[0][1]}
    return want, parts


def _seeded_image(res, seed, edges=False):
    """A seeded RGB image in [0, 1], res x res; with `edges`, sparse white
    lines on black, as a canny map."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if edges:
        img = np.zeros((res, res, 3), np.float32)
        for _ in range(24):
            if rng.random() < 0.5:
                img[rng.integers(res), :, :] = 1.0
            else:
                img[:, rng.integers(res), :] = 1.0
        return img
    coarse = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    return np.kron(coarse, np.ones((res // 8, res // 8, 1), np.float32))


class _ExtRequests:
    """Counts, checks and profiles the requests of one extension phase: each
    request runs with the counters at 0 (its launches against its plan,
    finite pixels of its size), then again under torch.profiler (bit for bit
    the first image; its device time by group); the launches by shape
    accumulate for the kernel check."""

    def __init__(self, smi, counters):
        self.smi, self.counters = smi, counters
        self.by_shape = {n: {} for n in counters}
        self.launches, self.device_ms = {}, {}

    def __call__(self, label, pipe, model, kw, plan, plain=None, res=None):
        import numpy as np
        import torch

        want, parts = plan
        for c in self.counters.values():
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        im = pipe(model, **kw).images
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {n: c.count for n, c in self.counters.items()}
        for n, c in self.counters.items():
            for key, v in c.by_shape.items():
                self.by_shape[n][key] = self.by_shape[n].get(key, 0) + v
        again = []
        prof = _profile(label, lambda: again.append(pipe(model, **kw).images))
        res = res or kw.get("height", EXT_RES)
        same = bool(np.array_equal(again[0], im))
        differs = None if plain is None else bool(not np.array_equal(plain, im))
        print(json.dumps({"extension_request": label, "wall_s": wall, "launches": got,
                          "expected_launches": want, "plan_flash_fwd_by_part": parts,
                          "device_kernel_ms": prof["device_kernel_ms"],
                          "device_busy_share": prof["device_busy_share"],
                          "repeat_bit_identical": same, "differs_from_plain": differs,
                          "shape": list(im.shape), "card": self.smi}), flush=True)
        if im.shape[1:] != (res, res, 3) or not np.isfinite(im).all():
            raise AssertionError(f"{label}: image {im.shape}")
        if got != want:
            raise AssertionError(f"{label}: launches {got} != expected {want}")
        if not same:
            raise AssertionError(f"{label}: a repeat gave another image")
        if differs is False:
            raise AssertionError(f"{label}: the image equals the plain request's")
        self.launches[label] = got
        self.device_ms[label] = prof["device_kernel_ms"]
        return im


def _ext_reference(label, cpu, gpu, kw, draws=None):
    """One request on a narrow model, card (kernels) against CPU (plain
    attention), fp32, the same weights and injected draws: latents and
    pixels within REF_TOL."""
    import numpy as np
    import torch

    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

    from stablediffusion_tpu_torch.utils.images import postprocess_image

    outs = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        pipe = StableDiffusionUnifiedPipeline(device=dev, dtype=torch.float32)
        f0 = FLASH_FWD_LAUNCHES.count
        lat = pipe(model, output_type="latents", draws=draws, **kw).latents
        # the pipeline's own decode of those latents (its "np" output)
        img = pipe._vae_decode(model, lat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        outs[dev] = (lat.float().cpu().numpy(),
                     postprocess_image(img.float().cpu().numpy()))
        if dev == "cuda" and FLASH_FWD_LAUNCHES.count == f0:
            raise AssertionError(f"{label}: the card run launched no kernel")
    lat_err = float(np.abs(outs["cpu"][0] - outs["cuda"][0]).max())
    img_err = float(np.abs(outs["cpu"][1] - outs["cuda"][1]).max())
    print(json.dumps({"extension_reference": label, "latents_max_abs_err": lat_err,
                      "images_max_abs_err": img_err, "tol": REF_TOL}), flush=True)
    if not (lat_err <= REF_TOL and img_err <= REF_TOL):
        raise AssertionError(f"{label}: card disagrees with CPU: {lat_err}, {img_err}")


def _card_copy(module):
    return copy.deepcopy(module).cuda()


def phase_extensions_reference(root):
    """Phase 39's narrow check: the narrow SD1.5-layout model of phase 5 with
    each extension, card against CPU in fp32 (FreeU, PAG on every group,
    DeepCache at interval 3 over 4 steps, weighting with an edit, the hires
    fix at 2x with both passes' draws injected, InstructPix2Pix on an
    8-channel copy, a random ControlNet, an IP-Adapter Plus over a 2-layer
    ViT-H/14)."""
    import dataclasses

    import numpy as np
    import torch

    from stablediffusion_tpu_torch.core.config import IP_ADAPTER_IMAGE_ENCODER
    from stablediffusion_tpu_torch.models.clip_vision import CLIPVisionModel
    from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
    from stablediffusion_tpu_torch.utils.testing import (
        random_controlnet,
        random_module,
        write_ip_adapter_file,
    )

    cpu = _narrow_sd15(seed=3)
    gpu = _to_card(cpu)
    lat = np.random.default_rng(7).standard_normal((1, 16, 16, 4)).astype(np.float32)
    common = dict(prompt="a small red house", num_inference_steps=4, guidance_scale=7.5, seed=1)
    for label, kw in (("freeu", dict(freeu=True)),
                      ("pag_all", dict(pag_scale=EXT_PAG, pag_applied_layers=("down", "mid", "up"))),
                      ("deepcache", dict(cache_interval=EXT_CACHE_INTERVAL)),
                      ("weighting_edit", dict(prompt="a (small:1.3) [red:blue:0.5] house",
                                              prompt_weighting=True))):
        _ext_reference(label, cpu, gpu, dict(common, latents=torch.from_numpy(lat), **kw))
    noise = np.random.default_rng(8).standard_normal((1, 32, 32, 4)).astype(np.float32)
    _ext_reference("hires_x2", cpu, gpu, dict(common, hires_scale=2.0, height=64, width=64),
                   draws=[{"latents": lat}, {"latents": noise}])
    # InstructPix2Pix on an 8-channel copy of the narrow UNet
    cfg8 = dataclasses.replace(cpu.unet_config, in_channels=8)
    g = torch.Generator().manual_seed(5)
    cpu8 = dataclasses.replace(cpu, unet_config=cfg8, unet=random_module(
        UNet2DConditionModel, cfg8, torch.device("cpu"), torch.float32, g))
    gpu8 = dataclasses.replace(gpu, unet_config=cfg8, unet=_card_copy(cpu8.unet))
    _ext_reference("ip2p", cpu8, gpu8, dict(common, latents=torch.from_numpy(lat),
                                            image=_seeded_image(32, 2),
                                            image_guidance_scale=EXT_IP2P_IMAGE_CFG))
    # a ControlNet and an IP-Adapter Plus on the narrow model
    cpu.controlnet_config = cpu.unet_config
    cpu.controlnet = random_controlnet(cpu.unet_config, "cpu", torch.float32, seed=4)
    gpu.controlnet_config, gpu.controlnet = cpu.unet_config, _card_copy(cpu.controlnet)
    vcfg = dataclasses.replace(IP_ADAPTER_IMAGE_ENCODER, num_hidden_layers=2)
    enc = random_module(CLIPVisionModel, vcfg, torch.device("cpu"), torch.float32, g)
    ip = write_ip_adapter_file(os.path.join(root, "narrow_ip_plus.safetensors"),
                               cpu.unet_config, vcfg, plus=True, num_tokens=16, depth=1,
                               heads=12, dim=768, dtype=torch.float32, seed=6)
    for m, e in ((cpu, enc), (gpu, _card_copy(enc))):
        m.image_encoder_config, m.image_encoder = vcfg, e
        m.load_ip_adapter(ip)
    _ext_reference("controlnet_ip_plus", cpu, gpu, dict(
        common, latents=torch.from_numpy(lat), control_image=_seeded_image(128, 3, edges=True),
        ip_adapter_image=_seeded_image(64, 4)))
    del cpu, gpu, cpu8, gpu8
    torch.cuda.empty_cache()


def phase_extensions_sd15(smi, checked):
    """Phase 39: the extensions on the full-width SD1.5 model at 512², 20
    DDIM steps, CFG 7.5, batch 1 (phases 39's requests, each with its plan);
    the narrow reference; the kernels at every new shape.  Returns (rows,
    launches by request, device ms by request, the model with its ControlNet
    loaded, the files' folder)."""
    import dataclasses
    import tempfile

    import torch

    from stablediffusion_tpu_torch.core.config import IP_ADAPTER_IMAGE_ENCODER, SD15_UNET
    from stablediffusion_tpu_torch.models.unet import UNet2DConditionModel
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils import prompt_edit as pe
    from stablediffusion_tpu_torch.utils.testing import (
        random_full_model,
        random_module,
        write_controlnet_folder,
        write_image_encoder_folder,
        write_ip_adapter_file,
    )

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ext_")
    model = random_full_model("sd15", device="cuda", seed=0)
    pipe = StableDiffusionUnifiedPipeline(device="cuda")
    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    ask = _ExtRequests(smi, counters)
    N = EXT_STEPS
    base = dict(prompt=EXT_PROMPT, height=EXT_RES, width=EXT_RES, num_inference_steps=N,
                guidance_scale=EXT_CFG, seed=0)
    plain = ask("ext_plain", pipe, model, base, _ext_plan(model, N))

    # prompt weighting: an edit adds one encode a further unique prompt
    variants = pe.unique_variants(pe.schedule_prompts([EXT_WEIGHTED], N)[1])[0]
    ask("ext_weighted_edit", pipe, model, dict(base, prompt=EXT_WEIGHTED, prompt_weighting=True),
        _ext_plan(model, N, clip_encodes=2 + len(variants) - 1), plain)
    # over 75 tokens: two chunks, which each tower pass runs as two rows
    FLASH_FWD_LAUNCHES.reset()
    ask("ext_long_prompt", pipe, model, dict(base, prompt=EXT_LONG, prompt_weighting=True),
        _ext_plan(model, N))
    clip_rows = {k[0][0] for k in FLASH_FWD_LAUNCHES.by_shape if k[3]}
    print(json.dumps({"ext_long_prompt_clip_rows": sorted(clip_rows),
                      "chunks": -(-len(model.tokenizer.tokenize(EXT_LONG)) // 75)}), flush=True)
    if clip_rows != {2}:
        raise AssertionError(f"the long prompt's tower ran on {clip_rows} rows, not 2")
    ask("ext_freeu", pipe, model, dict(base, freeu=True), _ext_plan(model, N), plain)
    ask("ext_pag_mid", pipe, model, dict(base, pag_scale=EXT_PAG),
        _ext_plan(model, N, pag=("mid",)), plain)
    ask("ext_pag_all", pipe, model,
        dict(base, pag_scale=EXT_PAG, pag_applied_layers=("down", "mid", "up")),
        _ext_plan(model, N, pag=("down", "mid", "up")), plain)
    k = EXT_CACHE_INTERVAL
    outer = N // k
    ask("ext_deepcache", pipe, model, dict(base, cache_interval=k),
        _ext_plan(model, outer + N - outer * k, n_shallow=outer * (k - 1)), plain)
    # the hires fix: txt2img at 512², then img2img at 1024² from the
    # upscaled latents at the hires strength (no encode; one decode)
    hi_steps = pipe.get_timesteps(model.scheduler, N, EXT_HIRES_STRENGTH, None)[0].num_steps
    ask("ext_hires_x2", pipe, model,
        dict(base, height=2 * EXT_RES, width=2 * EXT_RES, hires_scale=2.0,
             hires_strength=EXT_HIRES_STRENGTH),
        _add_plans(_ext_plan(model, N, streams=0), _ext_plan(model, hi_steps)))

    # InstructPix2Pix: an 8-channel UNet at timbrooks/instruct-pix2pix's
    # config over the same towers and VAE; one encode (the mode), one decode
    cfg8 = dataclasses.replace(SD15_UNET, in_channels=8)
    g = torch.Generator(device="cuda").manual_seed(8)
    ip2p = dataclasses.replace(model, unet_config=cfg8, unet=random_module(
        UNet2DConditionModel, cfg8, torch.device("cuda"), torch.bfloat16, g))
    ask("ext_ip2p", pipe, ip2p, dict(base, image=_seeded_image(EXT_RES, 9),
                                     image_guidance_scale=EXT_IP2P_IMAGE_CFG),
        _ext_plan(ip2p, N, streams=2))
    del ip2p

    # ControlNet at lllyasviel/control_v11p_sd15_canny's config (the SD1.5
    # UNet's encoder), written as a folder and loaded
    t = time.perf_counter()
    write_controlnet_folder(os.path.join(root, "controlnet"), SD15_UNET, device="cuda", seed=10)
    model.load_controlnet(root)
    print(f"controlnet folder written and loaded in {time.perf_counter() - t:.3f} s", flush=True)
    control = _seeded_image(EXT_RES, 11, edges=True)
    ask("ext_controlnet", pipe, model, dict(base, control_image=control),
        _ext_plan(model, N, cn=True), plain)

    # IP-Adapter, standard (ip-adapter_sd15) and Plus (ip-adapter-plus_sd15),
    # over the ViT-H/14 image encoder
    t = time.perf_counter()
    write_image_encoder_folder(os.path.join(root, "image_encoder"), IP_ADAPTER_IMAGE_ENCODER,
                               device="cuda", seed=12)
    std = write_ip_adapter_file(os.path.join(root, "ip-adapter_sd15.safetensors"), SD15_UNET,
                                IP_ADAPTER_IMAGE_ENCODER, seed=13)
    plus = write_ip_adapter_file(os.path.join(root, "ip-adapter-plus_sd15.safetensors"),
                                 SD15_UNET, IP_ADAPTER_IMAGE_ENCODER, plus=True, num_tokens=16,
                                 depth=4, heads=12, dim=768, seed=14)
    model.load_ip_adapter(std, image_encoder_path=root)
    print(f"image encoder and IP-Adapter files written and loaded in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    ip_image = _seeded_image(EXT_RES, 15)
    ask("ext_ip_adapter", pipe, model, dict(base, ip_adapter_image=ip_image),
        _ext_plan(model, N, ip=True, vision=1), plain)
    model.load_ip_adapter(plus)
    ask("ext_ip_adapter_plus", pipe, model, dict(base, ip_adapter_image=ip_image),
        _ext_plan(model, N, ip=True, vision=2, resampler=2), plain)
    model.unload_ip_adapter()
    torch.cuda.empty_cache()
    t_requests = time.perf_counter() - t0

    t = time.perf_counter()
    phase_extensions_reference(root)
    t_reference = time.perf_counter() - t
    t = time.perf_counter()
    rows = phase_new_shapes(ask.by_shape, checked, "extensions_sd15")
    print(json.dumps({"phase39_s": {"requests": t_requests, "reference": t_reference,
                                    "kernels": time.perf_counter() - t,
                                    "kernel_cases": len(rows)}}), flush=True)
    return rows, ask.launches, ask.device_ms, model, root


def phase_extensions_sdxl(smi, checked, root):
    """Phase 40: SDXL at 1024², 20 steps, one request with a ControlNet at
    diffusers/controlnet-canny-sdxl-1.0's config (the text_time embedding),
    an IP-Adapter at ip-adapter_sdxl's over the ViT-bigG/14 image encoder,
    and FreeU at the SDXL defaults; the narrow SDXL model with all three,
    card against CPU; the kernels at every new shape; the peak memory."""
    import dataclasses

    import torch

    from stablediffusion_tpu_torch.core.config import IP_ADAPTER_SDXL_IMAGE_ENCODER, SDXL_UNET
    from stablediffusion_tpu_torch.models.clip_vision import CLIPVisionModel
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.utils.testing import (
        random_controlnet,
        random_full_model,
        random_module,
        write_controlnet_folder,
        write_image_encoder_folder,
        write_ip_adapter_file,
    )

    model = random_full_model("sdxl", device="cuda", seed=0)
    xl_root = os.path.join(root, "sdxl")
    t = time.perf_counter()
    write_controlnet_folder(os.path.join(xl_root, "controlnet"), SDXL_UNET, device="cuda",
                            seed=20)
    model.load_controlnet(xl_root)
    write_image_encoder_folder(os.path.join(xl_root, "image_encoder"),
                               IP_ADAPTER_SDXL_IMAGE_ENCODER, device="cuda", seed=21)
    ip = write_ip_adapter_file(os.path.join(xl_root, "ip-adapter_sdxl.safetensors"), SDXL_UNET,
                               IP_ADAPTER_SDXL_IMAGE_ENCODER, seed=22)
    model.load_ip_adapter(ip, image_encoder_path=xl_root)
    print(f"SDXL ControlNet, ViT-bigG/14 and IP-Adapter files written and loaded in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    pipe = StableDiffusionUnifiedPipeline(device="cuda")
    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    ask = _ExtRequests(smi, counters)
    torch.cuda.reset_peak_memory_stats()
    ask("ext_sdxl_controlnet_ip_freeu", pipe, model,
        dict(prompt=EXT_PROMPT, height=SDXL_RES, width=SDXL_RES, num_inference_steps=SDXL_STEPS,
             guidance_scale=EXT_CFG, seed=0, freeu=True,
             control_image=_seeded_image(SDXL_RES, 23, edges=True),
             ip_adapter_image=_seeded_image(SDXL_RES, 24)),
        _ext_plan(model, SDXL_STEPS, ip=True, cn=True, vision=1))
    print(json.dumps({"ext_sdxl_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "card": smi}), flush=True)
    del model, pipe
    torch.cuda.empty_cache()

    # the narrow SDXL model of phase 18 with all three, card against CPU
    cpu = _narrow_sdxl(seed=5)
    gpu = _to_card(cpu)
    cpu.controlnet_config = cpu.unet_config
    cpu.controlnet = random_controlnet(cpu.unet_config, "cpu", torch.float32, seed=25)
    gpu.controlnet_config, gpu.controlnet = cpu.unet_config, _card_copy(cpu.controlnet)
    vcfg = dataclasses.replace(IP_ADAPTER_SDXL_IMAGE_ENCODER, num_hidden_layers=2)
    g = torch.Generator().manual_seed(26)
    enc = random_module(CLIPVisionModel, vcfg, torch.device("cpu"), torch.float32, g)
    ip_small = write_ip_adapter_file(os.path.join(xl_root, "narrow_ip.safetensors"),
                                     cpu.unet_config, vcfg, dtype=torch.float32, seed=27)
    for m, e in ((cpu, enc), (gpu, _card_copy(enc))):
        m.image_encoder_config, m.image_encoder = vcfg, e
        m.load_ip_adapter(ip_small)
    lat = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(28))
    _ext_reference("sdxl_controlnet_ip_freeu", cpu, gpu, dict(
        prompt="a small red house", num_inference_steps=4, guidance_scale=7.5, seed=1,
        latents=lat, freeu=True, control_image=_seeded_image(128, 29, edges=True),
        ip_adapter_image=_seeded_image(64, 30)))
    del cpu, gpu
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rows = phase_new_shapes(ask.by_shape, checked, "extensions_sdxl")
    print(json.dumps({"phase40_kernels_s": time.perf_counter() - t,
                      "kernel_cases": len(rows)}), flush=True)
    return rows, ask.launches, ask.device_ms


def phase_extension_serving(smi, model, root):
    """Phase 41: serving and the adapter lifecycle on phase 39's SD1.5
    model (its ControlNet loaded in the program, as JAX has no request key
    for it), over HTTP to the worker's server on 127.0.0.1: a model block
    naming an IP-Adapter file with a base64 ``ip_adapter_image`` (first
    without an image encoder, answered on the error channel as JAX's
    handler does, then with one loaded in the program), a base64
    ``control_image``, and phase 38's UI payload with FreeU, PAG and the
    hires fix; then ``load_ip_adapter``, ``load_loras`` + ``set_adapters``,
    ``quantize("w8")`` (the IP linears int8 exactly where JAX's plan puts
    them), ``quantize(None)``, ``delete_adapters``, ``unload_ip_adapter``:
    every UNet tensor bit for bit as before.  Returns the launches by
    request."""
    import base64
    import io
    import shutil
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from stablediffusion_tpu_torch.lora.formats import save_lora_file
    from stablediffusion_tpu_torch.models.ip_adapter import cross_attn_paths
    from stablediffusion_tpu_torch.ops.attention import FLASH_FWD_LAUNCHES
    from stablediffusion_tpu_torch.ops.flash_attention import FLASH_STREAM_LAUNCHES
    from stablediffusion_tpu_torch.ops.quant import DEFAULT_SKIP_KEYS, Int8Linear
    from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline
    from stablediffusion_tpu_torch.serve.handler import Handler
    from stablediffusion_tpu_torch.serve.webapp import build_ui_request
    from stablediffusion_tpu_torch.serve.worker import make_server
    from stablediffusion_tpu_torch.utils.testing import random_lora

    def b64(img01):
        buf = io.BytesIO()
        Image.fromarray((img01 * 255).round().astype(np.uint8)).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    counters = {"flash_fwd": FLASH_FWD_LAUNCHES, "flash_stream": FLASH_STREAM_LAUNCHES}
    N = EXT_STEPS
    req = dict(prompt=EXT_PROMPT, height=EXT_RES, width=EXT_RES, num_inference_steps=N,
               guidance_scale=EXT_CFG, seed=31)
    encoder = (model.image_encoder_config, model.image_encoder)
    model.image_encoder_config = model.image_encoder = None
    server = make_server(Handler(model=model, model_dir=root), "127.0.0.1", 0, max_batch=1)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    launches = {}
    try:
        port = server.server_address[1]
        ip_req = dict(req, model={"ip_adapter": "ip-adapter_sd15.safetensors"},
                      ip_adapter_image=b64(_seeded_image(EXT_RES, 15)))
        reply, _ = _ask(port, counters, smi, "ext_serve_ip_adapter_no_encoder", ip_req, None)
        print(json.dumps({"ext_serve_no_encoder_error": reply.get("error"),
                          "as_jax": "handler.py:240 loads no image encoder; "
                                    "unified.py:726-729 raises"}), flush=True)
        if "no image encoder loaded" not in str(reply.get("error")):
            raise AssertionError(f"without an image encoder: {reply}")
        model.image_encoder_config, model.image_encoder = encoder
        want, _ = _ext_plan(model, N, ip=True, vision=1)
        _, row = _ask(port, counters, smi, "ext_serve_ip_adapter", ip_req, want)
        launches["ext_serve_ip_adapter"] = row["launches"]
        cn_req = dict(req, control_image=b64(_seeded_image(EXT_RES, 11, edges=True)))
        want, _ = _ext_plan(model, N, cn=True)
        _, row = _ask(port, counters, smi, "ext_serve_controlnet", cn_req, want)
        launches["ext_serve_controlnet"] = row["launches"]
        ui = build_ui_request("txt2img", EXT_PROMPT, steps=N, cfg=EXT_CFG, seed=32,
                              width=2 * EXT_RES, height=2 * EXT_RES, scheduler="DDIM",
                              freeu=True, pag_scale=EXT_PAG, hires_scale=2.0)
        hi = StableDiffusionUnifiedPipeline(device="cuda").get_timesteps(
            model.scheduler, N, ui["hires_strength"], None)[0].num_steps
        want, _ = _add_plans(_ext_plan(model, N, pag=("mid",), streams=0),
                             _ext_plan(model, hi, pag=("mid",)))
        _, row = _ask(port, counters, smi, "ext_serve_ui_freeu_pag_hires", ui, want)
        launches["ext_serve_ui_freeu_pag_hires"] = row["launches"]
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)

    # the lifecycle
    model.unload_ip_adapter()
    before = {k: v.clone() for k, v in model.unet.state_dict().items()}
    model.load_ip_adapter(os.path.join(root, "ip-adapter_sd15.safetensors"))
    factors = random_lora(model.unet, ("to_q", "to_k", "to_v", "to_out.0"), rank=8, seed=33)
    save_lora_file({"unet": factors}, os.path.join(root, "sd15_ext.safetensors"))
    model.load_loras({"ext": 0.8}, lora_dir=root)
    model.quantize("w8")
    # JAX's plan (ops/quant.quantize_params over the IP-fused base): a linear
    # of at least quant_min_size elements whose path holds no skip key
    ip_paths = [f"{'.'.join(p)}.{n}" for p in cross_attn_paths(model.unet_config)
                for n in ("to_k_ip", "to_v_ip")]
    jax_int8 = {p for p in ip_paths if not any(s in p for s in DEFAULT_SKIP_KEYS)
                and model._fp_modules[p].weight.numel() >= model.quant_min_size}
    got_int8 = {p for p in ip_paths if isinstance(model.unet.get_submodule(p), Int8Linear)}
    model.quantize(None)
    model.delete_adapters()
    model.unload_ip_adapter()
    after = model.unet.state_dict()
    restored = sorted(after) == sorted(before) and all(torch.equal(after[k], v)
                                                       for k, v in before.items())
    print(json.dumps({"ext_lifecycle": "load_ip_adapter, load_loras, quantize w8, "
                      "quantize None, delete_adapters, unload_ip_adapter",
                      "ip_linears": len(ip_paths), "int8_under_w8": len(got_int8),
                      "int8_where_jax_plans": got_int8 == jax_int8,
                      "unet_bit_for_bit": restored, "card": smi}), flush=True)
    if got_int8 != jax_int8 or not jax_int8:
        raise AssertionError(f"IP linears int8 {len(got_int8)}, JAX's plan {len(jax_int8)}")
    if not restored:
        raise AssertionError("the lifecycle did not give the UNet back bit for bit")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# -- the last slice: ControlNet training, parallelism, tooling -----------------

CN_TRAIN_BATCH = 4  # train_controlnet.py's default
CN_TRAIN_STEPS = 3  # a checkpoint at step 2, then a resume of step 3
CN_TRAIN_LR = 5e-6


def _unet_tf_split(unet):
    """(transformer blocks in the down and mid blocks, in the up blocks)."""
    return (_n_tf(unet.down_blocks) + _n_tf(unet.mid_block), _n_tf(unet.up_blocks))


def phase_train_controlnet(smi):
    """Phase 42: ``ControlNetTrainer`` on the full-width SD1.5 model at 512²,
    batch 4, lr 5e-6, a ControlNet at control_v11p_sd15_canny's config (the
    UNet's encoder) initialized from the UNet, a folder pair of seeded
    images and edge maps: 3 steps with a checkpoint at step 2, then a run
    resumed from it whose step 3 equals the straight run's (cuDNN
    deterministic for the phase); every zero convolution moved (a fresh
    ControlNet's zero convolutions scale every other weight's gradient, so
    at lr 5e-6 many other masters move by less than their fp32 ulp in 3
    steps: counted, not required); the saved folder reloaded equal to the
    fp32 masters and one ControlNet request served with it.  The launch
    plan from the modules: the ControlNet's attentions and the UNet's
    up-block attentions run under grad (forward with lse, both backward
    kernels); the UNet's down and mid blocks do not (the residuals join
    after them), nor CLIP-L (causal, no lse); one flash_stream for the VAE
    encode."""
    import base64
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from stablediffusion_tpu_torch.io.loader import load_controlnet
    from stablediffusion_tpu_torch.serve.handler import Handler, decode_image_b64
    from stablediffusion_tpu_torch.train.controlnet_trainer import (
        ControlNetTrainer,
        ControlNetTrainingArgs,
    )
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    root = tempfile.mkdtemp(prefix="chip_smoke_cn_train_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = random_full_model("sd15", device="cuda", seed=42)
        model.vae.float()  # as load_sd_model holds it
        data = write_image_folder(os.path.join(root, "img"), CN_TRAIN_BATCH * 2, 512, seed=7,
                                  caption=TRAIN_PROMPT)
        cond = os.path.join(root, "cond")
        os.makedirs(cond)
        for i, f in enumerate(sorted(x for x in os.listdir(data) if x.endswith(".jpg"))):
            edges = (_seeded_image(512, 100 + i, edges=True) * 255).astype(np.uint8)
            Image.fromarray(edges).save(os.path.join(cond, f.replace(".jpg", ".png")))
        down_mid, up = _unet_tf_split(model.unet)
        n_cn = down_mid  # the ControlNet is the UNet's encoder: its down and mid blocks
        grad = 2 * (up + n_cn)
        want = {"flash_fwd": {"with_lse": grad,
                              "causal_no_lse": model.text_encoder_config.num_hidden_layers,
                              "other": 2 * down_mid},
                "flash_stream": 1, "flash_bwd_dq": grad, "flash_bwd_dkv": grad}
        plan = {"unet_transformer_blocks_down_mid": down_mid, "unet_up": up,
                "controlnet_transformer_blocks": n_cn,
                "forwards_a_step": grad + 2 * down_mid}

        def args(out, **kw):
            base = dict(train_batch_size=CN_TRAIN_BATCH, learning_rate=CN_TRAIN_LR,
                        resolution=512, max_train_steps=CN_TRAIN_STEPS, checkpointing_steps=2,
                        log_every=1, report_to=None, output_dir=os.path.join(root, out))
            return ControlNetTrainingArgs(**{**base, **kw})

        counters = _train_counters()
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        probe = _TrainProbe(module="stablediffusion_tpu_torch.train.controlnet_trainer",
                            encode=None, trainer=None)
        t = time.perf_counter()
        with probe:
            straight = ControlNetTrainer(model, args("straight"), data, cond).train()
        train_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check_steps("train_controlnet_step", probe, want)
        _fwd_counts_are_bf16(probe, "ControlNet training")
        walls = [s["wall_s"] for s in probe.steps]
        init = probe.initial
        straight = {n: t.clone() for n, t in straight.items()}  # the profiled step moves it
        still = sorted(n for n in straight if torch.equal(straight[n], init[n]))
        # a fresh ControlNet's zero convolutions scale every other weight's
        # gradient: at lr 5e-6 the first steps move them by less than an fp32
        # ulp of many weights (norm scales near 1), but never the zero
        # convolutions themselves
        zero_convs = [n for n in straight
                      if n.startswith(("controlnet_down_blocks", "controlnet_mid_block"))]
        zero_still = [n for n in zero_convs if n in still]
        totals = {n: c.count for n, c in counters.items()}
        by_shape = {n: dict(c.by_shape) for n, c in counters.items()}
        last = probe.last_call
        prof = _profile("train_controlnet_step", lambda: last[0](*last[1:]))
        del last, probe
        # the resume: step 3 from checkpoint-2 equals the straight run's
        resumed = ControlNetTrainer(model, args("resumed", resume_from_checkpoint=os.path.join(
            root, "straight", "checkpoint-2")), data, cond).train()
        exact = all(torch.equal(resumed[n], straight[n]) for n in straight)
        worst = max(((resumed[n] - straight[n]).abs().max()
                     / straight[n].abs().max().clamp_min(1e-30)).item() for n in straight)
        # the saved folder: the fp32 masters, reloaded equal; then served
        _, reloaded = load_controlnet(os.path.join(root, "straight"), torch.device("cuda"),
                                      torch.float32)
        same = all(torch.equal(p, straight[n]) for n, p in reloaded.named_parameters())
        del reloaded
        model.load_controlnet(os.path.join(root, "straight"))
        control = (_seeded_image(512, 100, edges=True) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(control).save(buf, format="PNG")
        handler = Handler(model=model)
        for c in counters.values():
            c.reset()
        resp = handler({"prompt": TRAIN_PROMPT, "seed": 3, "num_inference_steps": 20,
                        "guidance_scale": 7.5, "height": 512, "width": 512,
                        "control_image": base64.b64encode(buf.getvalue()).decode()}, "cn")
        if "error" in resp:
            raise AssertionError(f"ControlNet request: {resp['traceback']}")
        served = {n: c.count for n, c in counters.items()}
        # each of 20 steps one UNet and one ControlNet call on the CFG pair,
        # and the prompt's and negative's CLIP-L encodes
        want_served = (20 * (2 * _n_tf(model.unet) + 2 * n_cn)
                       + 2 * model.text_encoder_config.num_hidden_layers)
        im = decode_image_b64(resp["images"][0])
        summary = {
            "train_controlnet": "ControlNetTrainer SD1.5 512x512, batch 4, AdamW constant 5e-6, "
                                "ControlNet at control_v11p_sd15_canny's config from the UNet, "
                                "fp32 masters cast to bf16 at each use, fp32 VAE encode",
            "card": smi, "step_wall_s": walls,
            "train_call_s": train_s, "peak_memory_gib": peak, "launches_per_step": want,
            "plan": plan, "profiled_step": {k: prof[k] for k in (
                "wall_ms_profiled", "device_kernel_ms", "device_busy_share", "groups_ms")},
            "controlnet_params": sum(t.numel() for t in straight.values()),
            "masters": len(straight), "unmoved_masters": len(still),
            "unmoved_sample": still[:4], "zero_convs": len(zero_convs),
            "unmoved_zero_convs": zero_still, "resumed_equal_bitwise": exact,
            "resumed_worst_rel_err": worst, "reloaded_equal_fp32_masters": same,
            "served_launches": served, "served_flash_fwd_want": want_served,
            "served_image_shape": list(im.shape)}
        print(json.dumps(summary), flush=True)
        if zero_still or not exact or not same or served["flash_fwd"] != want_served \
                or served["flash_stream"] != 1 or im.shape != (512, 512, 3):
            raise AssertionError(f"ControlNet training: {summary}")
        del model, handler, straight, resumed, init
        return totals, by_shape, summary
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


PAR_BATCH = 2  # phase 43's SD1.5 LoRA step at 512²


def phase_parallel_world1(smi):
    """Phase 43: the parallel paths over a 1-rank NCCL process group
    (``parallel/mesh.maybe_initialize_distributed`` from torchrun's variables,
    set here; a 1 x 1 ``DeviceMesh``): one ``SDLoRATrainer`` step of the
    full-width SD1.5 model at 512² (batch 2, UNet and CLIP LoRA) meshless,
    then under DP, ZeRO-1 and FSDP, each from the same seed: the factors,
    loss and grad norm bit for bit the meshless run's (every collective runs
    and returns its input; ZeRO's norm sums the leaves in ``global_norm``'s
    order), the launches the same.  FSDP runs the UNet's blocks as
    checkpoint regions (each gathers its weights whole there, and again in
    the backward), so it is held against the meshless step under
    ``remat_policy="full"``, and its whole copies (``zero.gather_stats``) and
    the card's peak against that step's: at most the text tower, the VAE,
    the LoRA factors, the UNet outside its blocks and one block over it.  Each meshed path runs
    twice: the first run holds the set-up (NCCL's communicator at the first
    collective), the second is the step whose wall, beside the meshless one,
    is the path's overhead.  Then one SD1.5 request through a
    ``Handler(mesh=...)``, bit for bit and with the meshless launches."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from stablediffusion_tpu_torch.parallel import make_mesh, zero
    from stablediffusion_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from stablediffusion_tpu_torch.serve.handler import Handler
    from stablediffusion_tpu_torch.train.optim import tree_leaves
    from stablediffusion_tpu_torch.train.train_step import REMAT_UNITS
    from stablediffusion_tpu_torch.train.trainer import SDLoRATrainer, SDTrainingArgs
    from stablediffusion_tpu_torch.utils.testing import random_full_model, write_image_folder

    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        if not maybe_initialize_distributed("cuda") or dist.get_backend() != "nccl":
            raise AssertionError("no NCCL process group")
        mesh = make_mesh(data=1, tensor=1)
        model = random_full_model("sd15", device="cuda", seed=43)
        model.vae.float()
        data = write_image_folder(os.path.join(root, "img"), PAR_BATCH, 512, seed=8,
                                  caption=TRAIN_PROMPT)
        size = lambda m: sum(p.numel() * p.element_size() for p in m.parameters())  # noqa: E731
        units = [size(m) for m in model.unet.modules() if isinstance(m, REMAT_UNITS)]
        bound = {"span": size(model.vae) + size(model.text_encoder),
                 "unet_root": size(model.unet) - sum(units), "unit_max": max(units)}
        counters = _train_counters()
        runs = {}
        # a first meshless step warms cuDNN's choices and the allocator; each
        # meshed path's first run ("<path>_first") holds its set-up
        plan = [("warm", None, {}), ("meshless", None, {}),
                ("meshless_full", None, dict(remat_policy="full"))]
        for name, kw in (("dp", {}), ("zero1", dict(shard_opt_state=True)),
                         ("fsdp", dict(shard_params=True))):
            plan += [(f"{name}_first", mesh, kw), (name, mesh, kw)]
        for name, m, kw in plan:
            for c in counters.values():
                c.reset()
            args = SDTrainingArgs(train_batch_size=PAR_BATCH, resolution=512, max_train_steps=1,
                                  lr_scheduler="constant", lr_warmup_steps=0, log_every=1,
                                  report_to=None, output_dir=os.path.join(root, name), **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero.reset_gather_stats()
            held_before = zero.gather_stats()["live"]  # an earlier run's returned factors
            t = time.perf_counter()
            trainer = SDLoRATrainer(model, args, data, mesh=m)
            lora = trainer.train()
            torch.cuda.synchronize()
            runs[name] = {"wall_s": time.perf_counter() - t, "loss": trainer.history[0][1],
                          "lora": dict(tree_leaves(lora)),
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "gathered_peak_bytes": zero.gather_stats()["peak"] - held_before,
                          "launches": {n: c.count for n, c in counters.items()},
                          "by_shape": {n: dict(c.by_shape) for n, c in counters.items()}}
            del trainer, lora
        rows = {}
        for name in ("dp", "zero1", "fsdp"):
            r, ref = runs[name], runs["meshless_full" if name == "fsdp" else "meshless"]
            equal = sorted(r["lora"]) == sorted(ref["lora"]) and all(
                torch.equal(r["lora"][p], ref["lora"][p]) for p in ref["lora"])
            rows[name] = {"against": "meshless_full" if name == "fsdp" else "meshless",
                          "equal_bitwise": equal, "loss": r["loss"], "wall_s": r["wall_s"],
                          "overhead_s": r["wall_s"] - ref["wall_s"],
                          "first_wall_s": runs[f"{name}_first"]["wall_s"],
                          "setup_s": runs[f"{name}_first"]["wall_s"] - r["wall_s"],
                          "peak_gib": r["peak_gib"], "launches": r["launches"],
                          "launches_equal": r["by_shape"] == ref["by_shape"]}
        fsdp, full = runs["fsdp"], runs["meshless_full"]
        # the factors are made whole for the step (loss_fn's zero.whole_tree)
        bound["factors"] = sum(t.numel() * t.element_size() for t in fsdp["lora"].values())
        held = sum(bound.values())
        memory = {"bound_bytes": bound, "fsdp_gathered_peak_bytes": fsdp["gathered_peak_bytes"],
                  "fsdp_peak_gib": fsdp["peak_gib"], "meshless_full_peak_gib": full["peak_gib"],
                  "meshless_peak_gib": runs["meshless"]["peak_gib"],
                  "fsdp_over_full_bytes": (fsdp["peak_gib"] - full["peak_gib"]) * 2**30,
                  "unet_bytes": size(model.unet)}
        memory_ok = (fsdp["gathered_peak_bytes"] <= held
                     and (fsdp["peak_gib"] - full["peak_gib"]) * 2**30 <= held)
        # one request through a data = 1 handler against the meshless one
        req = dict(prompt=TRAIN_PROMPT, seed=5, num_inference_steps=20, guidance_scale=7.5,
                   height=512, width=512)
        images, serve = {}, {}
        for name, m in (("meshless", None), ("mesh_dp1", mesh)):
            for c in counters.values():
                c.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = Handler(model=model, mesh=m)._generate(dict(req), output_type="uint8")
            torch.cuda.synchronize()
            images[name] = np.asarray(out.images)
            serve[name] = {"wall_s": time.perf_counter() - t,
                           "launches": {n: c.count for n, c in counters.items()}}
        serve_equal = np.array_equal(images["meshless"], images["mesh_dp1"])
        summary = {"parallel_world1": "1-rank NCCL group, SD1.5 512² LoRA trainer step "
                                      "(batch 2, UNet + CLIP LoRA) and one 20-step request",
                   "card": smi, "backend": dist.get_backend(), "world": dist.get_world_size(),
                   "meshless_step_wall_s": runs["meshless"]["wall_s"],
                   "meshless_full_step_wall_s": full["wall_s"],
                   "meshless_launches": runs["meshless"]["launches"],
                   "meshless_full_launches": full["launches"],
                   "paths": rows, "fsdp_memory": memory, "fsdp_memory_within_bound": memory_ok,
                   "serve": serve, "serve_equal_bitwise": serve_equal}
        print(json.dumps(summary), flush=True)
        if not (all(r["equal_bitwise"] and r["launches_equal"] for r in rows.values())
                and memory_ok and serve_equal
                and serve["meshless"]["launches"] == serve["mesh_dp1"]["launches"]):
            raise AssertionError(f"parallel paths at world size 1: {summary}")
        launches = {f"parallel_{n}": r["launches"] for n, r in rows.items()}
        launches["parallel_serve_dp1"] = serve["mesh_dp1"]["launches"]
        del model
        return launches, summary
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


TOOL_STEPS = 20


def _sdpa_attention():
    """A context in which the port's attention routes call
    ``F.scaled_dot_product_attention`` (for FlopCounterMode's count of the
    same request)."""
    import contextlib

    import torch.nn.functional as F

    from stablediffusion_tpu_torch.ops import attention as att

    def sdpa(q, k, v, scale=None, causal=False):
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), is_causal=causal, scale=scale)
        return o.transpose(1, 2)

    @contextlib.contextmanager
    def ctx():
        orig = att.flash_fwd, att.flash_stream
        att.flash_fwd = sdpa
        att.flash_stream = lambda q, k, v, scale=None: sdpa(q, k, v, scale)
        try:
            yield
        finally:
            att.flash_fwd, att.flash_stream = orig

    return ctx()


def phase_tooling(smi, cold_build_s):
    """Phase 44: the tooling on the card.  The convert CLI turns a seeded
    full-width SD1.5 A1111 file into a folder, which loads and renders the
    image the handler renders from the file itself, bit for bit; the build
    cache: phase 1 built the kernels cold into a cache directory
    (``core/compile_cache``), and a fresh process pointed at it loads them
    warm; the native BPE loop tokenizes every word of the requests
    (``clip_bpe.TOKENIZE_PATHS``); one request's "generate" span in a
    ``profile_to`` trace; one ``inference_wandb`` request (wandb absent: the
    config inline); ``bench_utils``' FLOPs of one 512² request (FlopCounterMode
    plus the kernels' launch records) equal to FlopCounterMode's count of the
    same request through SDPA, and its MFU."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from stablediffusion_tpu_torch.core import compile_cache
    from stablediffusion_tpu_torch.io import convert_cli
    from stablediffusion_tpu_torch.io.loader import load_sd_model
    from stablediffusion_tpu_torch.serve.handler import Handler
    from stablediffusion_tpu_torch.tokenizer import clip_bpe
    from stablediffusion_tpu_torch.utils import bench_utils
    from stablediffusion_tpu_torch.utils.observability import profile_to
    from stablediffusion_tpu_torch.utils.testing import (
        random_full_model,
        save_ldm_single_file,
        synthetic_clip_tokenizer,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    os.environ.setdefault("WANDB_MODE", "disabled")  # never a network call
    try:
        src = random_full_model("sd15", device="cuda", seed=44)
        src.tokenizer = synthetic_clip_tokenizer()
        path = os.path.join(root, "chip.safetensors")
        save_ldm_single_file(src, path)
        src.tokenizer.save_pretrained(os.path.join(root, "tokenizer"))
        del src
        t = time.perf_counter()
        mtype = convert_cli.convert(path, os.path.join(root, "sd15_conv"))
        convert_s = time.perf_counter() - t
        src_tok = os.path.join(root, "tokenizer")
        shutil.copytree(src_tok, os.path.join(root, "sd15_conv", "tokenizer"))
        folder = load_sd_model(os.path.join(root, "sd15_conv"), model_type="sd15",
                               device="cuda")
        req = dict(prompt="a photograph of an astronaut riding a horse", seed=44,
                   num_inference_steps=TOOL_STEPS, guidance_scale=7.5, height=512, width=512)
        before = dict(clip_bpe.TOKENIZE_PATHS)
        img_folder = np.asarray(Handler(model=folder)._generate(dict(req), "uint8").images)
        by_file = Handler(model_dir=root, device="cuda")
        by_file.maybe_reload_model({"type": "sd15", "name": "chip.safetensors"})
        img_file = np.asarray(by_file._generate(dict(req), "uint8").images)
        bpe = {k: clip_bpe.TOKENIZE_PATHS[k] - before[k] for k in before}
        del by_file
        convert_equal = np.array_equal(img_folder, img_file)

        # the warm build in a fresh process over phase 1's cache
        code = ("import time; "
                "from stablediffusion_tpu_torch.core.compile_cache import "
                "enable_compilation_cache; from stablediffusion_tpu_torch.ops import _build; "
                "t = time.perf_counter(); "
                "assert enable_compilation_cache(); _build.build(); "
                "[_build.load(s) for s in _build.SOURCES]; "
                "print(time.perf_counter() - t, _build.BUILD_LOGS == {})")
        from stablediffusion_tpu_torch.ops import _build

        if _build.BUILD_DIR != compile_cache.cache_dir():
            raise AssertionError(f"the build directory moved: {_build.BUILD_DIR}")
        env = dict(os.environ)  # SDTPU_COMPILE_CACHE: phase 1's cache
        t = time.perf_counter()
        warm = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                              check=True).stdout.split()
        warm_proc_s = time.perf_counter() - t
        warm_build_s, nothing_built = float(warm[0]), warm[1] == "True"

        # one request's spans
        handler = Handler(model=folder)
        with profile_to(os.path.join(root, "trace")) as prof:
            handler._generate(dict(req, num_inference_steps=2), "uint8")
        # the span's host range (the profiler also shows its device range)
        spans = [e for e in prof.key_averages() if e.key == "generate"
                 and e.device_type == DeviceType.CPU]
        with open(os.path.join(root, "trace", "trace.json")) as f:
            in_trace = sum(e.get("name") == "generate" for e in _json.load(f)["traceEvents"])
        wandb = handler({"mode": "inference_wandb", **req}, "wandb")
        if "error" in wandb:
            raise AssertionError(f"inference_wandb: {wandb['traceback']}")

        # FLOPs and MFU of one request
        pipe_args = dict(req)

        def request():
            return handler._generate(dict(pipe_args), "uint8")

        bench_utils.warmup(request)
        torch.cuda.synchronize()
        t = time.perf_counter()
        request()
        torch.cuda.synchronize()
        req_s = time.perf_counter() - t
        _, flops, parts = bench_utils.flops(request)
        with _sdpa_attention():
            _, sdpa_flops, sdpa_parts = bench_utils.flops(request)
        summary = {
            "tooling": "convert CLI, build cache, native BPE, spans, inference_wandb, FLOPs",
            "card": smi, "convert_type": mtype, "convert_s": convert_s,
            "converted_image_equal_single_file": convert_equal,
            "build_cold_s": cold_build_s, "build_warm_s_after_imports": warm_build_s,
            "build_warm_process_s": warm_proc_s, "warm_built_nothing": nothing_built,
            "bpe_words": bpe, "generate_spans": len(spans), "generate_in_trace": in_trace,
            "wandb": {"url": wandb["wandb_url"], "config": wandb["config"]},
            "request_s": req_s, "request_flops": flops, "request_flops_parts": parts,
            "sdpa_flops": sdpa_flops, "sdpa_parts": sdpa_parts,
            "flops_equal_sdpa": flops == sdpa_flops,
            "mfu": bench_utils.mfu(flops, req_s),
            "peak_flops_per_sec": bench_utils.peak_flops_per_sec(),
            "hbm": bench_utils.hbm_stats()}
        print(json.dumps(summary), flush=True)
        if not (mtype == "sd15" and convert_equal and nothing_built and bpe["native"] > 0
                and bpe["python"] == 0 and len(spans) == 1 and in_trace >= 1
                and wandb["wandb_url"] is None and wandb["config"]["seed"] == 44
                and flops == sdpa_flops and parts["flash_fwd"] > 0):
            raise AssertionError(f"tooling: {summary}")
        del handler, folder
        return summary
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# the flash_fwd kernels' symbols, bf16 and fp32; _device_ms and the profile
# phases find every flash_fwd kernel by "flash_fwd" in its name
FWD_BF16_KERNEL = "flash_fwd_wgmma_kernel"
FWD_TF32_KERNEL = "flash_fwd_tf32_kernel"
# the fp32 (3xTF32) flash_stream kernel's symbol
STREAM_TF32_KERNEL = "flash_stream_tf32_kernel"
# the Hopper kernels of each source whose PTX and SASS phase 1 reads, and
# the products each must hold: the words of one PTX line and of one SASS
# line.  The bf16 kernels: bf16 wgmma, HGMMA with BF16; the fp32 ones: TF32
# wgmma, HGMMA with TF32.
_BF16_PRODUCTS = dict(ptx=("wgmma.mma_async", ".bf16"), sass=("HGMMA", "BF16"))
_TF32_PRODUCTS = dict(ptx=("wgmma.mma_async", ".tf32"), sass=("HGMMA", "TF32"))
HOPPER_KERNELS = {
    "flash_fwd": {FWD_BF16_KERNEL: _BF16_PRODUCTS, FWD_TF32_KERNEL: _TF32_PRODUCTS},
    "flash_bwd": {"flash_bwd_dq_wgmma_kernel": _BF16_PRODUCTS,
                  "flash_bwd_dkv_wgmma_kernel": _BF16_PRODUCTS,
                  "flash_bwd_dq_tf32_kernel": _TF32_PRODUCTS,
                  "flash_bwd_dkv_tf32_kernel": _TF32_PRODUCTS},
    "flash_stream": {STREAM_TF32_KERNEL: _TF32_PRODUCTS},
}


def _start_ptx(_build, out_dir):
    """nvcc -ptx of each source of HOPPER_KERNELS with the build's flags,
    started in the background: {source: (process, ptx path)}."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                        "-Xptxas", "-v")]
    jobs = {}
    for source in HOPPER_KERNELS:
        ptx = os.path.join(out_dir, f"{source}.ptx")
        cmd = [_build._nvcc(), *flags, "-ptx", "-o", ptx, str(_build.CSRC / f"{source}.cu")]
        jobs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), ptx)
    return jobs


def _check_hopper_isa(_build, ptx_jobs):
    """The Hopper kernels are Hopper's: in the PTX of each instantiation of
    each kernel of HOPPER_KERNELS, the products its spec names (lines that
    hold all the words it names) and TMA tensor copies
    (cp.async.bulk.tensor); where the toolkit has cuobjdump, the same in the
    built library's SASS (UTMALDG).  Raises when an instantiation lacks either, or when a kernel
    has no instantiation."""
    import re

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for source, (proc, ptx) in ptx_jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc -ptx of {source}.cu failed:\n{log}")
        specs = HOPPER_KERNELS[source]

        def spec_of(name):
            return next(((kn, sp) for kn, sp in specs.items() if kn in name), (None, None))

        rows = []
        for entry in re.split(r"\.entry ", open(ptx).read())[1:]:
            name = entry.split("(", 1)[0]
            kernel, spec = spec_of(name)
            if kernel is not None:
                lines = entry.splitlines()
                rows.append({
                    "kernel": name, "ptx_products": "".join(spec["ptx"]),
                    "ptx_count": sum(all(w in ln for w in spec["ptx"]) for ln in lines),
                    "cp.async.bulk.tensor": entry.count("cp.async.bulk.tensor")})
        sass = {}
        if os.path.exists(cuobjdump):
            dump = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(source))],
                                  capture_output=True, text=True, check=True).stdout
            for fn in re.split(r"\n\s*Function : ", dump)[1:]:
                name = fn.split("\n", 1)[0].strip()
                kernel, spec = spec_of(name)
                if kernel is not None:
                    sass[name] = {"sass_products": ".".join(spec["sass"]),
                                  "sass_count": sum(all(w in ln for w in spec["sass"])
                                                    for ln in fn.splitlines()),
                                  "UTMALDG": fn.count("UTMALDG")}
        for r in rows:
            r.update(sass.get(r["kernel"], {}))
        print(json.dumps({f"{source}_isa": rows, "sass_read": bool(sass)}), flush=True)
        missing = [kn for kn in specs if not any(kn in r["kernel"] for r in rows)]
        if missing or any(r["ptx_count"] == 0 or r["cp.async.bulk.tensor"] == 0 for r in rows):
            raise AssertionError(f"{source}'s Hopper kernels lack their products or TMA copies "
                                 f"in PTX (no instantiation of {missing}): {rows}")
        if sass and any(r.get("sass_count", 0) == 0 or r.get("UTMALDG", 0) == 0 for r in rows):
            raise AssertionError(f"{source}'s SASS lacks its products or UTMALDG: {rows}")


def main() -> int:
    import torch

    from stablediffusion_tpu_torch.ops import _build

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    # phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"max SM clock {_sm_clock_hz() / 1e6:.0f} MHz (the bound's exponential rate)",
          flush=True)
    # the kernels build cold into a cache directory inside the checkout
    # (core/compile_cache), which phase 44 loads warm from a fresh process
    from stablediffusion_tpu_torch.core.compile_cache import enable_compilation_cache

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "stablediffusion_tpu_torch", "_kernels_build", "smoke_cache")
    shutil.rmtree(cache, ignore_errors=True)
    # the workers and CLIs the phases start enable the cache from the
    # environment: they keep to this one, inside the checkout
    os.environ["SDTPU_COMPILE_CACHE"] = cache
    if not enable_compilation_cache():
        raise AssertionError(f"the kernel build cache at {cache} is unavailable")
    ptx_dir = os.path.join(cache, "ptx")
    os.makedirs(ptx_dir, exist_ok=True)
    ptx_jobs = _start_ptx(_build, ptx_dir)  # beside the build, not part of it
    t = time.perf_counter()
    _build.build()
    cold_build_s = time.perf_counter() - t
    print(f"built {sorted(_build.SOURCES)} in {cold_build_s:.3f} s into {_build.BUILD_DIR}",
          flush=True)
    for source, log in sorted(_build.BUILD_LOGS.items()):
        usage = _build.ptxas_usage(log)
        print(json.dumps({"ptxas": source, "kernels": usage}), flush=True)
        spilled = [u for u in usage if u["spill_bytes"]]
        if source in ("flash_bwd", "flash_fwd") and spilled:
            raise AssertionError(f"{source} kernels spill registers: {spilled}")
        # the fp32 flash_stream instantiations every path runs (3xTF32, D <= 512)
        spilled_tf32 = [u for u in spilled if u["kernel"].startswith(STREAM_TF32_KERNEL)]
        if source == "flash_stream" and spilled_tf32:
            raise AssertionError(f"flash_stream's fp32 kernels spill registers: {spilled_tf32}")
        serialized = [ln for ln in log.splitlines()
                      if "wgmma.mma_async instructions are serialized" in ln]
        print(json.dumps({"wgmma_serialized": source, "notices": len(serialized)}), flush=True)
        if serialized:
            raise AssertionError(f"ptxas serialized {source}'s wgmma: {serialized}")
    _check_hopper_isa(_build, ptx_jobs)
    if set(_build.SOURCES) - set(_build.BUILD_LOGS):
        print("ptxas: the libraries were built by an earlier run; no report", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    launches, by_shape, batch1, model, pipe, _ = phase_main_path()
    rows = phase_kernels(by_shape, batch1)
    phase_unet_bf16(model)
    phase_reference()
    phase_profile(model, pipe)
    del model, pipe
    torch.cuda.empty_cache()

    train_launches, train_by_shape, _ = phase_train()
    torch.cuda.empty_cache()
    rows += phase_train_kernels(train_by_shape)
    phase_train_reference()
    torch.cuda.empty_cache()

    # the trainer slice: SDXL 1024² with text-encoder LoRA, then the SD1.5
    # variants; their kernels at every shape no earlier phase held
    held = {(r["kernel"], *r["shape"], r["skv"], r["causal"], r["dtype"]) for r in rows}
    train_sdxl_launches, train_sdxl_by_shape, _ = phase_train_sdxl(smi)
    rows += phase_train_kernels_at(train_sdxl_by_shape, "train_sdxl", held)
    variants_launches, variants_by_shape, _ = phase_train_variants(smi)
    rows += phase_train_kernels_at(variants_by_shape, "train_variants", held)
    torch.cuda.empty_cache()

    serve_launches, serve_by_shape = phase_serve(smi)
    torch.cuda.empty_cache()
    # the inference paths hold their own shapes, the trainer's apart
    checked = {(r["kernel"], *r["shape"], r["skv"], r["causal"]) for r in rows
               if r.get("path") not in ("train_sdxl", "train_variants")}
    rows += phase_new_shapes(serve_by_shape, checked, "serve")
    phase_inpaint_reference()
    torch.cuda.empty_cache()

    sdxl_rows, sdxl_launches = phase_sdxl(smi, checked)
    rows += sdxl_rows
    torch.cuda.empty_cache()

    single_launches, single_by_shape = phase_single_file(smi)
    rows += phase_new_shapes(single_by_shape, checked, "single_file")
    phase_adapter_reference()
    torch.cuda.empty_cache()

    sd3_rows, sd3_launches = phase_sd3(smi, checked)
    rows += sd3_rows

    # the rest of training; the kernels at every shape these paths launched
    # that no earlier phase held
    held = {(r["kernel"], *r["shape"], r["skv"], r["causal"], r["dtype"]) for r in rows}
    more_training, summaries = {}, {}
    for path, phase in (("train_sd3", phase_train_sd3), ("train_full", phase_full_finetune),
                        ("train_ti_sdxl", phase_ti_sdxl),
                        ("train_dreambooth", phase_dreambooth)):
        path_launches, path_by_shape, summaries[path] = phase(smi)
        more_training[path] = path_launches
        rows += phase_train_kernels_at(path_by_shape, path, held)
        torch.cuda.empty_cache()

    # the rest of serving: int8 modes, int8 folders and the quantize CLI,
    # SD3 LoRA adapters, the web UI and the queue entry
    int8_launches, _, xl, xl_img, xl_bytes, sd15 = phase_int8(smi)
    int8_root, int8_name = phase_int8_checkpoints(smi, xl, xl_img, xl_bytes, sd15)
    del xl
    torch.cuda.empty_cache()
    serving_rest = {**int8_launches,
                    **phase_sd3_lora(smi, summaries["train_sd3"]["lora_file"]),
                    **phase_front_doors(smi, int8_root, int8_name, sd15)}
    del sd15
    torch.cuda.empty_cache()

    # the pipeline extensions: SD1.5 (39), SDXL (40), serving and the
    # adapter lifecycle (41)
    t_ext = time.perf_counter()
    ext_rows, ext_launches, ext_ms, ext_model, ext_root = phase_extensions_sd15(smi, checked)
    rows += ext_rows
    xl_rows, xl_launches, xl_ms = phase_extensions_sdxl(smi, checked, ext_root)
    rows += xl_rows
    ext_launches.update(xl_launches)
    ext_launches.update(phase_extension_serving(smi, ext_model, ext_root))
    del ext_model
    torch.cuda.empty_cache()
    ms = {**ext_ms, **xl_ms}
    print(json.dumps({"extension_device_ms": ms,
                      "against_plain": {k: v - ms["ext_plain"] for k, v in ms.items()
                                        if not k.startswith("ext_sdxl")},
                      "phases_39_41_s": time.perf_counter() - t_ext, "card": smi}), flush=True)
    serving_rest.update(ext_launches)
    # the last slice: ControlNet training (42), the parallel paths on a
    # 1-rank NCCL group (43), the tooling (44)
    t_last = time.perf_counter()
    held = {(r["kernel"], *r["shape"], r["skv"], r["causal"], r["dtype"]) for r in rows}
    cn_launches, cn_by_shape, _ = phase_train_controlnet(smi)
    more_training["train_controlnet"] = cn_launches
    rows += phase_train_kernels_at(cn_by_shape, "train_controlnet", held)
    t42 = time.perf_counter() - t_last
    par_launches, _ = phase_parallel_world1(smi)
    serving_rest.update(par_launches)
    t43 = time.perf_counter() - t_last - t42
    phase_tooling(smi, cold_build_s)
    print(json.dumps({"phases_42_44_s": time.perf_counter() - t_last, "phase_42_s": t42,
                      "phase_43_s": t43}), flush=True)
    # the masked route (T5's position bias) is no kernel: its count by path
    print(json.dumps({"attention_masked_launches_by_path": {
        p: n.get("attention_masked", 0) for p, n in sd3_launches.items()},
        "route": "ops/attention.attention_plain on the card, by design"}), flush=True)

    # one line per kernel, at its heaviest main-path shape; launches from the
    # path that needs the kernel (txt2img for the forwards, training for the
    # backward), with every path's counts beside
    main_case = {
        "flash_fwd": dict(shape=[2, 4096, 8, 40], skv=4096, dtype="bfloat16"),
        "flash_stream": dict(shape=[1, 4096, 1, 512], skv=4096, dtype="float32"),
        "flash_bwd_dkv": dict(shape=[TRAIN_BATCH, 4096, 8, 40], skv=4096, dtype="bfloat16"),
        "flash_bwd_dq": dict(shape=[TRAIN_BATCH, 4096, 8, 40], skv=4096, dtype="bfloat16"),
    }
    # the SDXL path's heaviest shape of each forward kernel
    sdxl_case = {
        "flash_fwd": dict(shape=[2, 4096, 10, 64], skv=4096, dtype="bfloat16"),
        "flash_stream": dict(shape=[1, 16384, 1, 512], skv=16384, dtype="float32"),
    }
    # the SD3 path's heaviest shape of each forward kernel (the decode's
    # stream is held at that shape by the SDXL phase)
    sd3_case = {
        "flash_fwd": dict(path="sd3", shape=[2, 4429, 24, 64], skv=4429, dtype="bfloat16"),
        "flash_stream": dict(path="sdxl", shape=[1, 16384, 1, 512], skv=16384,
                             dtype="float32"),
    }
    train_sdxl_case = {
        "flash_fwd": dict(shape=[2, 4096, 10, 64], skv=4096, dtype="bfloat16"),
        "flash_stream": dict(shape=[2, 16384, 1, 512], skv=16384, dtype="float32"),
        "flash_bwd_dkv": dict(shape=[2, 4096, 10, 64], skv=4096, dtype="bfloat16"),
        "flash_bwd_dq": dict(shape=[2, 4096, 10, 64], skv=4096, dtype="bfloat16"),
    }
    # the ControlNet trainer's heaviest shape: batch 4 over 4096 tokens
    # (held by this phase or, where an earlier path launched the same shape,
    # by that one)
    cn = dict(shape=[CN_TRAIN_BATCH, 4096, 8, 40], skv=4096, dtype="bfloat16")
    train_cn_case = {"flash_fwd": cn, "flash_bwd_dkv": cn, "flash_bwd_dq": cn,
                     "flash_stream": dict(shape=[CN_TRAIN_BATCH, 4096, 1, 512], skv=4096,
                                          dtype="float32")}
    joint = dict(path="train_sd3", shape=[1, 4250, 24, 64], skv=4250, dtype="bfloat16")
    train_sd3_case = {
        "flash_fwd": joint, "flash_bwd_dkv": joint, "flash_bwd_dq": joint,
        "flash_stream": dict(path="sdxl", shape=[1, 16384, 1, 512], skv=16384,
                             dtype="float32"),
    }
    lib_flash = "stablediffusion_tpu/ops/attention.py:165"
    meta = {
        "flash_fwd": ("stablediffusion_tpu_torch/csrc/flash_fwd.cu", lib_flash),
        "flash_stream": ("stablediffusion_tpu_torch/csrc/flash_stream.cu",
                         "stablediffusion_tpu/ops/flash_attention.py:145"),
        "flash_bwd_dkv": ("stablediffusion_tpu_torch/csrc/flash_bwd.cu", lib_flash),
        "flash_bwd_dq": ("stablediffusion_tpu_torch/csrc/flash_bwd.cu", lib_flash),
    }
    # the library Pallas kernels behind _lib_flash (jax 0.9.0)
    library_kernel = {
        "flash_fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:589",
        "flash_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "flash_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
    }
    kernels = []
    for name, want in main_case.items():
        row = next(r for r in rows if r["kernel"] == name and not r["causal"]
                   and r.get("path") != "train"
                   and all(r[k] == v for k, v in want.items()))
        mine = [r for r in rows if r["kernel"] == name]
        by_path = {"txt2img": launches.get(name, 0), "serve": serve_launches.get(name, 0),
                   "train": train_launches[name],
                   "train_sdxl": train_sdxl_launches[name],
                   "train_variants": variants_launches[name],
                   **{p: n.get(name, 0) for p, n in sdxl_launches.items()},
                   "single_file_constructor": single_launches.get(name, 0),
                   **{p: n.get(name, 0) for p, n in sd3_launches.items()},
                   **{p: n[name] for p, n in more_training.items()},
                   **{p: n.get(name, 0) for p, n in serving_rest.items()}}
        sdxl = None
        if name in sdxl_case:
            r = next(r for r in rows if r["kernel"] == name and r.get("path") == "sdxl"
                     and all(r[k] == v for k, v in sdxl_case[name].items()))
            sdxl = {k: r[k] for k in ("shape", "skv", "dtype", "launches", "max_abs_err",
                                      "worst_over_limit", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
        sd3 = None
        if name in sd3_case:
            r = next(r for r in rows if r["kernel"] == name
                     and all(r.get(k) == v for k, v in sd3_case[name].items()))
            sd3 = {k: r[k] for k in ("shape", "skv", "dtype", "max_abs_err",
                                     "worst_over_limit", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}
            sd3["launches"] = sd3_launches["sd3"][name]
        # the SDXL trainer's heaviest shape (D=64 over 4096 tokens; the
        # stream: the batch-2 1024² encode)
        tr = next(r for r in rows if r["kernel"] == name and r.get("path") == "train_sdxl"
                  and all(r[k] == v for k, v in train_sdxl_case[name].items()))
        train_sdxl = {k: tr[k] for k in ("shape", "skv", "dtype", "launches", "max_abs_err",
                                         "worst_over_limit", "kernel_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")}
        # the SD3 trainer's joint stream (the stream: its 1024² encode,
        # held at that shape by the SDXL phase)
        r = next(r for r in rows if r["kernel"] == name
                 and all(r.get(k) == v for k, v in train_sd3_case[name].items()))
        train_sd3 = {k: r[k] for k in ("shape", "skv", "dtype", "max_abs_err",
                                       "worst_over_limit", "kernel_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}
        train_sd3["launches"] = more_training["train_sd3"][name]
        r = sorted((r for r in rows if r["kernel"] == name and not r["causal"]
                    and all(r.get(k) == v for k, v in train_cn_case[name].items())),
                   key=lambda r: r.get("path") != "train_controlnet")[0]
        train_cn = {k: r[k] for k in ("shape", "skv", "dtype", "max_abs_err",
                                      "worst_over_limit", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
        train_cn["launches"] = more_training["train_controlnet"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "replaces_library_kernel": library_kernel.get(name),
            "launches": by_path["train" if name.startswith("flash_bwd") else "txt2img"],
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "event_ms": row.get("event_ms"),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound_terms_ms": row["bound_terms_ms"],
            "library_ms": row["library_ms"],
            "shape": row["shape"], "skv": row["skv"], "dtype": row["dtype"],
            "cases": len(mine),
            "worst_over_limit": max(r["worst_over_limit"] for r in mine),
            "sdxl_case": sdxl,
            "train_sdxl_case": train_sdxl,
            "sd3_case": sd3,
            "train_sd3_case": train_sd3,
            "train_controlnet_case": train_cn,
        })
    print(f"chip_smoke total command time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
