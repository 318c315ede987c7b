"""T5 v1.1 encoder stack (T5EncoderModel): SD3's third text tower.

Port of ``stablediffusion_tpu/models/t5.py:25-157`` (``T5Config``,
``T5_XXL``, ``tiny_t5_config``, ``_relative_position_bucket``,
``compute_position_bias``, ``apply``).  Module names follow transformers'
T5EncoderModel, so ``state_dict()`` keys equal the checkpoint keys that the
JAX param tree mirrors (``shared.weight``,
``encoder.block.N.layer.0.SelfAttention.q.weight``,
``encoder.block.N.layer.1.DenseReluDense.wi_0.weight``,
``encoder.final_layer_norm.weight``).  T5's quirks carry over: no 1/sqrt(d)
in the attention (``scale=1.0``), an additive relative-position bias computed
once from block 0's table and shared by every layer, RMSNorm without a mean
or a bias (statistics in fp32), the gated tanh-GELU feed-forward of v1.1 and
the single-``wi`` relu one of v1.0.  The bias rides the attention's mask
slot, which ``ops/attention.py`` sends to the plain version on the card (its
``ATTENTION_MASKED_LAUNCHES`` counts those calls), as the JAX package sends
every masked call to XLA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stablediffusion_tpu_torch.ops.attention import attention
from stablediffusion_tpu_torch.ops.basic import linear


@dataclass(frozen=True)
class T5Config:
    """t5-v1_1 family; defaults are the tiny test config, SD3 uses
    T5_XXL below."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "gelu_new"  # gated-gelu (v1.1) | "relu" (v1.0)

    @property
    def gated(self) -> bool:
        return self.dense_act_fn in ("gelu_new", "gelu")

    @classmethod
    def from_diffusers_dict(cls, d: dict) -> "T5Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


T5_XXL = T5Config(
    vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240,
    num_layers=24, num_heads=64,
)


def tiny_t5_config() -> T5Config:
    return T5Config(
        vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4
    )


def _relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int, max_distance: int
) -> np.ndarray:
    """Bidirectional bucket mapping (transformers T5Attention semantics):
    half the buckets for each sign, exact below num_buckets / 4, then
    logarithmic up to `max_distance`."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def compute_position_bias(table: torch.Tensor, seq_len: int,
                          config: T5Config) -> torch.Tensor:
    """[num_buckets, heads] embedding table -> the additive logits bias
    [1, heads, S, S] in the table's dtype."""
    pos = np.arange(seq_len, dtype=np.int64)
    rel = pos[None, :] - pos[:, None]  # memory - query
    buckets = _relative_position_bucket(
        rel, config.relative_attention_num_buckets,
        config.relative_attention_max_distance)
    idx = torch.from_numpy(buckets).to(table.device)
    return table[idx].permute(2, 0, 1)[None]


class T5RMSNorm(nn.Module):
    """weight * x / rms(x), statistics in fp32, back in x's dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        h = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * h).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias_table:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        shape = (B, S, self.heads, self.d_kv)
        q = linear(x, self.q.weight).reshape(shape)
        k = linear(x, self.k.weight).reshape(shape)
        v = linear(x, self.v.weight).reshape(shape)
        # T5: no 1/sqrt(d); the position bias rides the additive mask slot
        o = attention(q, k, v, mask=bias, scale=1.0)
        return linear(o.reshape(B, S, -1), self.o.weight)


class T5DenseReluDense(nn.Module):
    """Gated tanh-GELU (v1.1: wi_0, wi_1) or relu (v1.0: wi), then wo."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.gated
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = (F.gelu(linear(x, self.wi_0.weight), approximate="tanh")
                 * linear(x, self.wi_1.weight))
        else:
            h = F.relu(linear(x, self.wi.weight))
        return linear(h, self.wo.weight)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias_table)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, first: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, first), _FFLayer(cfg)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        sa, ff = self.layer
        x = x + sa.SelfAttention(sa.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """input_ids [B, S] (and an optional [B, S] attention mask, 1 = keep)
    -> the last hidden state [B, S, d_model] after the final norm
    (``t5.apply``)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared.weight[input_ids]
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = compute_position_bias(table, input_ids.shape[1], self.config).float()
        if attention_mask is not None:
            keep = attention_mask[:, None, None, :].bool()
            bias = bias + torch.where(keep, 0.0, -1e9)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
