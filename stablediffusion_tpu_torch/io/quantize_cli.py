"""Offline int8 checkpoint quantizer: fp diffusers-layout folder -> int8 folder.

    python -m stablediffusion_tpu_torch.io.quantize_cli SRC DST --mode w8

Port of ``stablediffusion_tpu/io/quantize_cli.py``, with its flags.  The
denoise tower (UNet or MM-DiT) is written int8 in JAX's canonical layout
with per-output-channel fp32 scales (``ops/quant.py``); the VAE, the text
encoders, the tokenizers and the scheduler stay floating point.  The folder
loads through ``io/loader.load_sd_model`` / ``load_sd3_model`` of either
package (model_index.json records ``_sdtpu_quant``) as a ``quant_frozen``
model: LoRA fusion needs the fp original.  By default the quantization runs
on the CPU, which needs no card; ``--no-cpu`` loads the model onto the card.
"""

from __future__ import annotations

import argparse
import os
import shutil


def _copy_tokenizer_dirs(src: str, dst: str) -> None:
    for name in os.listdir(src):
        if name.startswith("tokenizer"):
            s, d = os.path.join(src, name), os.path.join(dst, name)
            if os.path.isdir(s) and not os.path.isdir(d):
                shutil.copytree(s, d)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="fp diffusers-layout checkpoint folder")
    p.add_argument("dst", help="output folder")
    p.add_argument("--mode", default="w8",
                   help="w8: int8 weights, bf16 products (halves the weights' bytes); "
                        "w8a8: int8 GEMMs for every quantized layer; w8a8:N (mixed): int8 "
                        "GEMMs only for layers with >= N output channels, w8 for the rest; "
                        "auto: the mode ops/quant.resolve_quant_mode picks for "
                        "--expected_batch from the H100's measured denoise steps")
    p.add_argument("--expected_batch", type=int, default=1,
                   help="serving batch the checkpoint is destined for; only used to "
                        "resolve --mode auto (ops/quant.AUTO_QUANT_*). The resolved "
                        "concrete mode is what lands in the checkpoint metadata.")
    p.add_argument("--model_type", default=None, choices=(None, "sd15", "sdxl", "sd3"),
                   help="default: auto-detect (transformer/ folder => sd3)")
    p.add_argument("--min_size", type=int, default=None,
                   help="skip params with fewer elements (default 65536)")
    p.add_argument("--variant", default="fp16",
                   help="weights variant to read (falls back to unsuffixed)")
    p.add_argument("--cpu", action="store_true", default=True,
                   help="run on the CPU (default: offline quantization needs no card; "
                        "pass --no-cpu to load the model onto the card)")
    p.add_argument("--no-cpu", dest="cpu", action="store_false")
    args = p.parse_args(argv)

    from stablediffusion_tpu_torch.ops.quant import resolve_quant_mode, validate_quant_mode

    validate_quant_mode(args.mode)
    args.mode = resolve_quant_mode(args.mode, args.expected_batch)
    device = "cpu" if args.cpu else None

    model_type = args.model_type
    if model_type is None:
        model_type = "sd3" if os.path.isdir(os.path.join(args.src, "transformer")) else None

    if model_type == "sd3":
        from stablediffusion_tpu_torch.io.loader import load_sd3_model, save_sd3_model

        model = load_sd3_model(args.src, device=device, variant=args.variant)
        if args.min_size is not None:
            model.quant_min_size = int(args.min_size)
        save_sd3_model(model, args.dst, quantize=args.mode)
    else:
        from stablediffusion_tpu_torch.io.loader import load_sd_model, save_sd_model

        model = load_sd_model(args.src, model_type=model_type, device=device,
                              variant=args.variant)
        if args.min_size is not None:
            model.quant_min_size = int(args.min_size)
        save_sd_model(model, args.dst, quantize=args.mode)
    _copy_tokenizer_dirs(args.src, args.dst)

    def _du(d):
        total = 0
        for root, _, files in os.walk(d):
            total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
        return total / 2**30

    print(f"quantized ({args.mode}) {args.src} ({_du(args.src):.2f} GB) "
          f"-> {args.dst} ({_du(args.dst):.2f} GB)")


if __name__ == "__main__":
    main()
