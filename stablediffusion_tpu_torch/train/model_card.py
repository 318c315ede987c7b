"""Model card and optional hub upload of a training run.

Port of ``stablediffusion_tpu/train/model_card.py``: ``save_model_card``
writes ``README.md`` (the front matter, sample images saved beside it, the
usage snippet, the training block) into the output folder, as the
reference's scripts do (train_text_to_image_lora.py:64-102), with the usage
written for the port's modules.  ``push_to_hub`` creates the repository
and uploads the folder when ``huggingface_hub`` and a network are there;
on any failure it logs "hub upload skipped" and returns None, so an
air-gapped run carries on.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

_TEMPLATE = """---
license: creativeml-openrail-m
base_model: {base_model}
tags:
- stable-diffusion
- text-to-image
- lora
- cuda
- stablediffusion-tpu
inference: true
---

# LoRA fine-tune — {repo_name}

LoRA adapter trained with **stablediffusion-tpu** (PyTorch/CUDA port) on `{base_model}`.

{img_block}

## Usage

```python
from stablediffusion_tpu_torch.io.loader import load_sd_model
from stablediffusion_tpu_torch.lora.formats import load_lora_file
from stablediffusion_tpu_torch.pipelines.unified import StableDiffusionUnifiedPipeline

model = load_sd_model("{base_model}")
model.load_lora_weights("style", load_lora_file("pytorch_lora_weights.safetensors"))
model.set_adapters({{"style": 1.0}})
pipe = StableDiffusionUnifiedPipeline()
images = pipe(model, prompt={prompt!r}).images
```

## Training

{train_block}
"""


def save_model_card(
    output_dir: str,
    base_model: str,
    prompt: Optional[str] = None,
    images=None,
    train_info: Optional[dict] = None,
    repo_name: Optional[str] = None,
) -> str:
    """Write ``{output_dir}/README.md`` (and ``image_{i}.png`` for each of
    `images`, floats in [0, 1] or uint8 HWC); returns the card's path."""
    import numpy as np

    os.makedirs(output_dir, exist_ok=True)
    img_lines = []
    for i, im in enumerate(images if images is not None else []):
        from PIL import Image

        arr = np.asarray(im)
        if arr.dtype.kind == "f":
            arr = (arr * 255).astype("uint8")
        fname = f"image_{i}.png"
        Image.fromarray(arr).save(os.path.join(output_dir, fname))
        img_lines.append(f"![img_{i}](./{fname})")
    train_block = "\n".join(
        f"- **{k}**: {v}" for k, v in (train_info or {}).items()
    ) or "_no training metadata recorded_"
    card = _TEMPLATE.format(
        base_model=base_model,
        repo_name=repo_name or os.path.basename(os.path.abspath(output_dir)),
        img_block="\n".join(img_lines),
        prompt=prompt or "a photo",
        train_block=train_block,
    )
    path = os.path.join(output_dir, "README.md")
    with open(path, "w", encoding="utf-8") as f:
        f.write(card)
    return path


def push_to_hub(output_dir: str, repo_id: str, token: Optional[str] = None) -> Optional[str]:
    """create_repo + upload_folder (checkpoints and logs left out); the
    repository's URL, or None where the upload could not be made."""
    try:
        from huggingface_hub import create_repo, upload_folder

        repo = create_repo(repo_id, exist_ok=True, token=token).repo_id
        upload_folder(
            repo_id=repo,
            folder_path=output_dir,
            commit_message="LoRA trained with stablediffusion-tpu",
            ignore_patterns=["checkpoint-*", "logs*"],
            token=token,
        )
        return f"https://huggingface.co/{repo}"
    except Exception as e:
        logger.warning("hub upload skipped: %s", e)
        return None
