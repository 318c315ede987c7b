"""Parameter names and shapes of each component under the diffusers and
transformers key names, from its published ``config.json``: the state dicts
that ``harness/weights.py`` fills from the seed and both the program and the
reference receive."""

from __future__ import annotations

from typing import Dict, Tuple

Shapes = Dict[str, Tuple[int, ...]]


def _lin(out: Shapes, name: str, i: int, o: int, bias: bool = True) -> None:
    out[name + ".weight"] = (o, i)
    if bias:
        out[name + ".bias"] = (o,)


def _conv(out: Shapes, name: str, i: int, o: int, k: int = 3) -> None:
    out[name + ".weight"] = (o, i, k, k)
    out[name + ".bias"] = (o,)


def _norm(out: Shapes, name: str, c: int) -> None:
    out[name + ".weight"] = (c,)
    out[name + ".bias"] = (c,)


def clip_text(cfg: dict) -> Shapes:
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    out: Shapes = {
        "text_model.embeddings.token_embedding.weight": (cfg["vocab_size"], H),
        "text_model.embeddings.position_embedding.weight": (cfg["max_position_embeddings"], H),
    }
    for i in range(cfg["num_hidden_layers"]):
        pre = f"text_model.encoder.layers.{i}"
        for n in "qkv":
            _lin(out, f"{pre}.self_attn.{n}_proj", H, H)
        _lin(out, pre + ".self_attn.out_proj", H, H)
        _norm(out, pre + ".layer_norm1", H)
        _lin(out, pre + ".mlp.fc1", H, I)
        _lin(out, pre + ".mlp.fc2", I, H)
        _norm(out, pre + ".layer_norm2", H)
    _norm(out, "text_model.final_layer_norm", H)
    if "CLIPTextModelWithProjection" in cfg.get("architectures", []):
        _lin(out, "text_projection", H, cfg["projection_dim"], bias=False)
    return out


def _resnet(out: Shapes, pre: str, ci: int, co: int, temb) -> None:
    _norm(out, pre + ".norm1", ci)
    _conv(out, pre + ".conv1", ci, co)
    if temb is not None:
        _lin(out, pre + ".time_emb_proj", temb, co)
    _norm(out, pre + ".norm2", co)
    _conv(out, pre + ".conv2", co, co)
    if ci != co:
        _conv(out, pre + ".conv_shortcut", ci, co, 1)


def _transformer(out: Shapes, pre: str, c: int, ctx: int, depth: int, linear: bool) -> None:
    _norm(out, pre + ".norm", c)
    for n in ("proj_in", "proj_out"):
        if linear:
            _lin(out, f"{pre}.{n}", c, c)
        else:
            _conv(out, f"{pre}.{n}", c, c, 1)
    for d in range(depth):
        blk = f"{pre}.transformer_blocks.{d}"
        for a, kv in (("attn1", c), ("attn2", ctx)):
            _lin(out, f"{blk}.{a}.to_q", c, c, bias=False)
            _lin(out, f"{blk}.{a}.to_k", kv, c, bias=False)
            _lin(out, f"{blk}.{a}.to_v", kv, c, bias=False)
            _lin(out, f"{blk}.{a}.to_out.0", c, c)
        for k in (1, 2, 3):
            _norm(out, f"{blk}.norm{k}", c)
        _lin(out, blk + ".ff.net.0.proj", c, 8 * c)
        _lin(out, blk + ".ff.net.2", 4 * c, c)


def unet(cfg: dict) -> Shapes:
    ch = list(cfg["block_out_channels"])
    n, L = len(ch), cfg.get("layers_per_block", 2)
    depth = cfg.get("transformer_layers_per_block", 1)
    depth = list(depth) if isinstance(depth, (list, tuple)) else [depth] * n
    ctx, lin = cfg["cross_attention_dim"], bool(cfg.get("use_linear_projection", False))
    temb = 4 * ch[0]
    out: Shapes = {}
    _conv(out, "conv_in", cfg.get("in_channels", 4), ch[0])
    _lin(out, "time_embedding.linear_1", ch[0], temb)
    _lin(out, "time_embedding.linear_2", temb, temb)
    if cfg.get("addition_embed_type") == "text_time":
        _lin(out, "add_embedding.linear_1", cfg["projection_class_embeddings_input_dim"], temb)
        _lin(out, "add_embedding.linear_2", temb, temb)
    skip, c_in = [ch[0]], ch[0]
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(L):
            _resnet(out, f"down_blocks.{i}.resnets.{j}", c_in if j == 0 else ch[i], ch[i], temb)
            if kind == "CrossAttnDownBlock2D":
                _transformer(out, f"down_blocks.{i}.attentions.{j}", ch[i], ctx, depth[i], lin)
            skip.append(ch[i])
        if i < n - 1:
            _conv(out, f"down_blocks.{i}.downsamplers.0.conv", ch[i], ch[i])
            skip.append(ch[i])
        c_in = ch[i]
    for k in (0, 1):
        _resnet(out, f"mid_block.resnets.{k}", ch[-1], ch[-1], temb)
    _transformer(out, "mid_block.attentions.0", ch[-1], ctx, depth[-1], lin)
    prev = ch[-1]
    for i, kind in enumerate(cfg["up_block_types"]):
        c = ch[n - 1 - i]
        for j in range(L + 1):
            _resnet(out, f"up_blocks.{i}.resnets.{j}", prev + skip.pop(), c, temb)
            if kind == "CrossAttnUpBlock2D":
                _transformer(out, f"up_blocks.{i}.attentions.{j}", c, ctx, depth[n - 1 - i], lin)
            prev = c
        if i < n - 1:
            _conv(out, f"up_blocks.{i}.upsamplers.0.conv", c, c)
    _norm(out, "conv_norm_out", ch[0])
    _conv(out, "conv_out", ch[0], cfg.get("out_channels", 4))
    return out


def _vae_mid(out: Shapes, pre: str, c: int) -> None:
    for k in (0, 1):
        _resnet(out, f"{pre}.resnets.{k}", c, c, None)
    _norm(out, pre + ".attentions.0.group_norm", c)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        _lin(out, f"{pre}.attentions.0.{n}", c, c)


def vae(cfg: dict) -> Shapes:
    ch, L = list(cfg["block_out_channels"]), cfg.get("layers_per_block", 2)
    lc = cfg.get("latent_channels", 4)
    out: Shapes = {}
    _conv(out, "encoder.conv_in", cfg.get("in_channels", 3), ch[0])
    c_in = ch[0]
    for i, c in enumerate(ch):
        for j in range(L):
            _resnet(out, f"encoder.down_blocks.{i}.resnets.{j}", c_in if j == 0 else c, c, None)
        if i < len(ch) - 1:
            _conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
        c_in = c
    _vae_mid(out, "encoder.mid_block", ch[-1])
    _norm(out, "encoder.conv_norm_out", ch[-1])
    _conv(out, "encoder.conv_out", ch[-1], 2 * lc)
    rev = list(reversed(ch))
    _conv(out, "decoder.conv_in", lc, rev[0])
    _vae_mid(out, "decoder.mid_block", rev[0])
    c_in = rev[0]
    for i, c in enumerate(rev):
        for j in range(L + 1):
            _resnet(out, f"decoder.up_blocks.{i}.resnets.{j}", c_in if j == 0 else c, c, None)
        if i < len(rev) - 1:
            _conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
        c_in = c
    _norm(out, "decoder.conv_norm_out", rev[-1])
    _conv(out, "decoder.conv_out", rev[-1], cfg.get("out_channels", 3))
    if cfg.get("use_quant_conv", True):
        _conv(out, "quant_conv", 2 * lc, 2 * lc, 1)
    if cfg.get("use_post_quant_conv", True):
        _conv(out, "post_quant_conv", lc, lc, 1)
    return out
