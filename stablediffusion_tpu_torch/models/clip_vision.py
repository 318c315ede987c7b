"""CLIP vision tower (ViT) as a torch module: the IP-Adapter image encoder.

Port of ``stablediffusion_tpu/models/clip_vision.py`` (``apply`` :52), with
transformers' CLIPVisionTransformer semantics: the patch convolution
(stride = patch, no bias), flattened, the class token prepended, learned
position embeddings added, ``pre_layrnorm`` (the checkpoint's spelling),
then the text tower's encoder layers without the causal mask.
``last_hidden_state`` is not post-layer-normed; ``pooled_output`` is
``post_layernorm`` of the class token and ``image_embeds`` its
``visual_projection``.  Module names follow transformers'
CLIPVisionModelWithProjection, so ``state_dict()`` keys are the keys of an
``image_encoder`` folder.  Pixels are NCHW, CLIP-normalised
(``utils/images.clip_image_preprocess`` gives NHWC).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import CLIPVisionConfig
from stablediffusion_tpu_torch.models.clip import CLIPEncoderLayer
from stablediffusion_tpu_torch.models.layers import conv, lin, ln


@dataclass
class CLIPVisionOutput:
    last_hidden_state: torch.Tensor  # [B, S, H], no post_layernorm
    hidden_states: List[torch.Tensor]  # the embeddings, then each layer's output
    pooled_output: torch.Tensor  # [B, H]: post_layernorm(class token)
    image_embeds: Optional[torch.Tensor]  # [B, P] with a projection

    def penultimate(self) -> torch.Tensor:
        """hidden_states[-2]: IP-Adapter Plus's conditioning."""
        return self.hidden_states[-2]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(H))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, H, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, H)


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal=False)
                                    for _ in range(cfg.num_hidden_layers))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPVisionEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """pixel_values [B, 3, S, S] -> :class:`CLIPVisionOutput`."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        if config.with_projection:
            self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                               bias=False)

    def forward(self, pixel_values: torch.Tensor) -> CLIPVisionOutput:
        vm = self.vision_model
        emb = vm.embeddings
        x = conv(emb.patch_embedding, pixel_values.to(emb.patch_embedding.weight.dtype))
        B, H = x.shape[:2]
        x = x.reshape(B, H, -1).transpose(1, 2)  # [B, patches, H], row-major
        cls = emb.class_embedding.reshape(1, 1, H).expand(B, 1, H)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding.weight[None, : x.shape[1]]
        x = ln(vm.pre_layrnorm, x)
        hidden_states = [x]
        for layer in vm.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        pooled = ln(vm.post_layernorm, x[:, 0])
        embeds = lin(self.visual_projection, pooled) if self.config.with_projection else None
        return CLIPVisionOutput(x, hidden_states, pooled, embeds)
