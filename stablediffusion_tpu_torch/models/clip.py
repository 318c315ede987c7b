"""CLIP text tower as a torch module.

Port of ``stablediffusion_tpu/models/clip.py:40-108`` (``apply`` and
``final_layer_norm``).  Module names follow transformers' CLIPTextModel, so
``state_dict()`` keys equal the diffusers checkpoint keys that the JAX
package's param tree uses (``text_model.encoder.layers.N.self_attn.q_proj
.weight`` ...).  Self-attention is causal through
``attention(..., causal=True)`` in place of the JAX version's additive -inf
mask; pad tokens take part causally, as in the SD pipelines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from stablediffusion_tpu_torch.core.config import CLIPTextConfig
from stablediffusion_tpu_torch.models.layers import lin, ln
from stablediffusion_tpu_torch.ops.attention import attention
from stablediffusion_tpu_torch.ops.basic import ACTIVATIONS


@dataclass
class CLIPTextOutput:
    last_hidden_state: torch.Tensor  # [B, S, H] (final_layer_norm applied)
    hidden_states: List[torch.Tensor]  # L+1 entries: embeddings + each layer
    pooled_output: torch.Tensor  # [B, H] hidden state at the first EOS
    projected_pooled: Optional[torch.Tensor]  # [B, P] if with_projection


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        H = cfg.hidden_size
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        shape = (B, S, self.heads, self.head_dim)
        q = lin(self.q_proj, x).reshape(shape)
        k = lin(self.k_proj, x).reshape(shape)
        v = lin(self.v_proj, x).reshape(shape)
        out = attention(q, k, v, causal=True)
        return lin(self.out_proj, out.reshape(B, S, H))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lin(self.fc2, self.act(lin(self.fc1, x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(ln(self.layer_norm1, x))
        return x + self.mlp(ln(self.layer_norm2, x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """input_ids [B, S] -> :class:`CLIPTextOutput` (``clip.apply``)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        if config.with_projection:
            self.text_projection = nn.Linear(
                config.hidden_size, config.projection_dim, bias=False
            )

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        tm = self.text_model
        emb = tm.embeddings
        S = input_ids.shape[1]
        x = emb.token_embedding.weight[input_ids]
        x = x + emb.position_embedding.weight[:S]
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        last = ln(tm.final_layer_norm, x)
        # pooled = hidden state at the first EOS position
        eos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        projected = None
        if self.config.with_projection:
            projected = lin(self.text_projection, pooled)
        return CLIPTextOutput(last, hidden_states, pooled, projected)

    def final_layer_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Re-apply final_layer_norm (the SD1.5 clip-skip convention)."""
        return ln(self.text_model.final_layer_norm, x)
