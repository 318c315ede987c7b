"""A1111/LDM single-file checkpoint -> diffusers-layout conversion.

The port's own copy of ``stablediffusion_tpu/io/a1111.py``, which imports
nothing of JAX: LDM ("model.diffusion_model...", "first_stage_model...",
"cond_stage_model..." / "conditioner.embedders...") keys to diffusers-named
flat numpy tensors in torch layouts, plus config synthesis from the LDM yaml
fields.  The port's modules carry those names and layouts, so the output
loads by a strict copy into their state dicts (``io/loader.
load_sd_single_file``).

Covered: SD1.x / SD2.x / SDXL UNets (incl. EMA extraction and the 9-channel
inpaint variant), the KL VAE (incl. attention conv->linear squeeze), CLIP-L
text encoders, and OpenCLIP (bigG) towers with fused in_proj qkv splitting.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# K2: UNet config synthesis from LDM yaml params
# ---------------------------------------------------------------------------

LDM_DEFAULTS = dict(
    model_channels=320,
    channel_mult=(1, 2, 4, 4),
    num_res_blocks=2,
    attention_resolutions=(4, 2, 1),
    context_dim=768,
    num_heads=8,
    num_head_channels=None,
    transformer_depth=1,
    use_linear_in_transformer=False,
    adm_in_channels=None,
    in_channels=4,
    out_channels=4,
    image_size=64,
)


def create_unet_config(ldm: Mapping) -> dict:
    """LDM unet_config.params -> diffusers UNet config dict
    (create_unet_diffusers_config analog, convert_from_A1111.py:97-203)."""
    p = {**LDM_DEFAULTS, **dict(ldm)}
    ch = p["model_channels"]
    mult = tuple(p["channel_mult"])
    block_out = tuple(ch * m for m in mult)
    n_blocks = len(mult)

    # attention placement: attention_resolutions are downsample factors
    attn_res = set(p["attention_resolutions"])
    down_types, up_types = [], []
    ds = 1
    for i in range(n_blocks):
        down_types.append(
            "CrossAttnDownBlock2D" if ds in attn_res else "DownBlock2D"
        )
        if i < n_blocks - 1:
            ds *= 2
    for i in range(n_blocks):
        up_types.append(
            "CrossAttnUpBlock2D" if ds in attn_res else "UpBlock2D"
        )
        if i < n_blocks - 1:
            ds //= 2

    # heads: per-resolution when num_head_channels is set
    if p.get("num_head_channels"):
        heads = tuple(c // p["num_head_channels"] for c in block_out)
    else:
        heads = p["num_heads"]

    depth = p.get("transformer_depth", 1)
    if isinstance(depth, (list, tuple)):
        depth = tuple(depth)

    cfg = dict(
        sample_size=p["image_size"],
        in_channels=p["in_channels"],
        out_channels=p["out_channels"],
        down_block_types=down_types,
        up_block_types=up_types,
        block_out_channels=list(block_out),
        layers_per_block=p["num_res_blocks"],
        cross_attention_dim=p["context_dim"],
        use_linear_projection=bool(p.get("use_linear_in_transformer")),
        transformer_layers_per_block=depth,
        num_attention_heads=heads,
    )
    # SDXL micro-conditioning (ref detects context_dim in {2048,1280} ->
    # addition_embed_type text_time, convert_from_A1111.py:164-173)
    if p.get("adm_in_channels"):
        cfg.update(
            addition_embed_type="text_time",
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=p["adm_in_channels"],
        )
    return cfg


def create_vae_config(ldm: Mapping, scaling_factor: float = 0.18215) -> dict:
    p = dict(ldm)
    ch = p.get("ch", 128)
    mult = tuple(p.get("ch_mult", (1, 2, 4, 4)))
    return dict(
        in_channels=p.get("in_channels", 3),
        out_channels=p.get("out_ch", 3),
        block_out_channels=[ch * m for m in mult],
        layers_per_block=p.get("num_res_blocks", 2),
        latent_channels=p.get("z_channels", 4),
        sample_size=p.get("resolution", 512),
        scaling_factor=scaling_factor,
    )


# ---------------------------------------------------------------------------
# K3: UNet weights
# ---------------------------------------------------------------------------

_RESNET_MAP = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}


def _rename_resnet(rest: str) -> str:
    for old, new in _RESNET_MAP.items():
        if rest.startswith(old):
            return new + rest[len(old):]
    return rest


def extract_ema(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Swap in model_ema weights (K3 EMA extraction,
    convert_from_A1111.py:259-279).  LDM stores EMA under
    model_ema.<param name with dots stripped>."""
    out = dict(state)
    ema = {k[len("model_ema."):]: v for k, v in state.items()
           if k.startswith("model_ema.") and k not in (
               "model_ema.decay", "model_ema.num_updates")}
    if not ema:
        return out
    for key in list(out):
        if not key.startswith("model.diffusion_model."):
            continue
        flat = key[len("model."):].replace(".", "")
        if flat in ema:
            out[key] = ema[flat]
    return out


def convert_ldm_unet(
    state: Mapping[str, np.ndarray],
    config: Mapping,
    prefix: str = "model.diffusion_model.",
) -> Dict[str, np.ndarray]:
    """LDM UNet keys -> diffusers keys (convert_ldm_unet_checkpoint analog,
    convert_from_A1111.py:240-485)."""
    src = {
        k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)
    }
    if not src:
        raise ValueError(f"no keys under {prefix!r}")
    out: Dict[str, np.ndarray] = {}
    n_blocks = len(config["block_out_channels"])
    layers = config["layers_per_block"]
    down_types = list(config["down_block_types"])
    up_types = list(config["up_block_types"])

    simple = {
        "time_embed.0": "time_embedding.linear_1",
        "time_embed.2": "time_embedding.linear_2",
        "label_emb.0.0": "add_embedding.linear_1",
        "label_emb.0.2": "add_embedding.linear_2",
        "input_blocks.0.0": "conv_in",
        "out.0": "conv_norm_out",
        "out.2": "conv_out",
    }

    for key, val in src.items():
        mapped = None
        for old, new in simple.items():
            if key.startswith(old + "."):
                mapped = new + key[len(old):]
                break
        if mapped:
            out[mapped] = val
            continue

        m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", key)
        if m:
            idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            block_i = (idx - 1) // (layers + 1)
            layer_j = (idx - 1) % (layers + 1)
            if layer_j == layers:  # downsampler slot
                assert rest.startswith("op."), key
                out[
                    f"down_blocks.{block_i}.downsamplers.0.conv.{rest[3:]}"
                ] = val
            elif sub == 0:
                out[
                    f"down_blocks.{block_i}.resnets.{layer_j}.{_rename_resnet(rest)}"
                ] = val
            else:
                out[f"down_blocks.{block_i}.attentions.{layer_j}.{rest}"] = val
            continue

        m = re.match(r"middle_block\.(\d+)\.(.*)", key)
        if m:
            sub, rest = int(m.group(1)), m.group(2)
            if sub == 0:
                out[f"mid_block.resnets.0.{_rename_resnet(rest)}"] = val
            elif sub == 1:
                out[f"mid_block.attentions.0.{rest}"] = val
            else:
                out[f"mid_block.resnets.1.{_rename_resnet(rest)}"] = val
            continue

        m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", key)
        if m:
            idx, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            block_i = idx // (layers + 1)
            layer_j = idx % (layers + 1)
            has_attn = up_types[block_i] == "CrossAttnUpBlock2D"
            if rest.startswith("conv.") and (
                sub == 2 or (sub == 1 and not has_attn)
            ):
                # upsampler: slot 2 in cross-attn blocks, slot 1 otherwise
                out[f"up_blocks.{block_i}.upsamplers.0.conv.{rest[5:]}"] = val
            elif sub == 0:
                out[
                    f"up_blocks.{block_i}.resnets.{layer_j}.{_rename_resnet(rest)}"
                ] = val
            else:
                out[f"up_blocks.{block_i}.attentions.{layer_j}.{rest}"] = val
            continue

        raise ValueError(f"unmapped LDM UNet key {prefix}{key}")
    return out


# ---------------------------------------------------------------------------
# K4: VAE weights
# ---------------------------------------------------------------------------

_VAE_ATTN_MAP = {
    "norm": "group_norm",
    "q": "to_q",
    "k": "to_k",
    "v": "to_v",
    "proj_out": "to_out.0",
}


def _conv_attn_to_linear(key: str, val: np.ndarray) -> np.ndarray:
    """1x1 conv attention projections -> linear (conv_attn_to_linear analog,
    convert_from_A1111.py:75-83)."""
    if key.endswith(".weight") and val.ndim == 4:
        return val[:, :, 0, 0]
    return val


def convert_ldm_vae(
    state: Mapping[str, np.ndarray], prefix: str = "first_stage_model."
) -> Dict[str, np.ndarray]:
    """LDM VAE keys -> diffusers keys (convert_ldm_vae_checkpoint analog,
    convert_from_A1111.py:490-677)."""
    src = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if not src:
        raise ValueError(f"no keys under {prefix!r}")
    # infer up-block count for decoder order reversal
    up_ids = {
        int(m.group(1))
        for k in src
        if (m := re.match(r"decoder\.up\.(\d+)\.", k))
    }
    n_up = (max(up_ids) + 1) if up_ids else 0

    out: Dict[str, np.ndarray] = {}
    for key, val in src.items():
        if key.startswith(("quant_conv.", "post_quant_conv.")):
            out[key] = val
            continue
        side = "encoder" if key.startswith("encoder.") else "decoder"
        rest = key[len(side) + 1:]

        if rest.startswith(("conv_in.", "conv_out.")):
            out[f"{side}.{rest}"] = val
            continue
        if rest.startswith("norm_out."):
            out[f"{side}.conv_norm_out.{rest[len('norm_out.'):]}"] = val
            continue

        m = re.match(r"down\.(\d+)\.block\.(\d+)\.(.*)", rest)
        if m:
            i, j, r = int(m.group(1)), int(m.group(2)), m.group(3)
            r = r.replace("nin_shortcut", "conv_shortcut")
            out[f"encoder.down_blocks.{i}.resnets.{j}.{r}"] = val
            continue
        m = re.match(r"down\.(\d+)\.downsample\.conv\.(.*)", rest)
        if m:
            out[
                f"encoder.down_blocks.{m.group(1)}.downsamplers.0.conv.{m.group(2)}"
            ] = val
            continue
        m = re.match(r"up\.(\d+)\.block\.(\d+)\.(.*)", rest)
        if m:
            i, j, r = int(m.group(1)), int(m.group(2)), m.group(3)
            r = r.replace("nin_shortcut", "conv_shortcut")
            # LDM decoder up blocks are low-res-last; diffusers reverses
            out[f"decoder.up_blocks.{n_up - 1 - i}.resnets.{j}.{r}"] = val
            continue
        m = re.match(r"up\.(\d+)\.upsample\.conv\.(.*)", rest)
        if m:
            i = int(m.group(1))
            out[
                f"decoder.up_blocks.{n_up - 1 - i}.upsamplers.0.conv.{m.group(2)}"
            ] = val
            continue
        m = re.match(r"mid\.block_(\d)\.(.*)", rest)
        if m:
            r = m.group(2).replace("nin_shortcut", "conv_shortcut")
            out[f"{side}.mid_block.resnets.{int(m.group(1)) - 1}.{r}"] = val
            continue
        m = re.match(r"mid\.attn_1\.(\w+)\.(.*)", rest)
        if m:
            part, r = m.group(1), m.group(2)
            new = _VAE_ATTN_MAP.get(part)
            if new is None:
                raise ValueError(f"unmapped VAE attn key {key}")
            val2 = val if new == "group_norm" else _conv_attn_to_linear(key, val)
            out[f"{side}.mid_block.attentions.0.{new}.{r}"] = val2
            continue
        raise ValueError(f"unmapped LDM VAE key {prefix}{key}")
    return out


# ---------------------------------------------------------------------------
# K6: ControlNet
# ---------------------------------------------------------------------------


def convert_controlnet(
    state: Mapping[str, np.ndarray],
    config: Mapping,
    prefix: str = "control_model.",
) -> Dict[str, np.ndarray]:
    """ControlNet single-file -> diffusers keys (convert_controlnet_checkpoint
    analog, convert_from_A1111.py:714-755).  The trunk reuses the UNet
    mapping; extras are the conditioning embedder (input_hint_block), the
    per-block zero convs and the mid zero conv."""
    src = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if not src:
        raise ValueError(f"no keys under {prefix!r}")
    trunk = {
        k: v
        for k, v in src.items()
        if k.startswith(("time_embed", "label_emb", "input_blocks",
                         "middle_block.0", "middle_block.1", "middle_block.2"))
    }
    out = convert_ldm_unet(
        {f"model.diffusion_model.{k}": v for k, v in trunk.items()}, config
    )
    # conv_norm_out/conv_out don't exist in controlnets
    for key, val in src.items():
        if key.startswith("input_hint_block."):
            # hint block: convs at even indices 0,2,...,14
            idx = int(key.split(".")[1])
            rest = key.split(".", 2)[2]
            n = idx // 2
            if n == 0:
                new = f"controlnet_cond_embedding.conv_in.{rest}"
            elif n == 7:
                new = f"controlnet_cond_embedding.conv_out.{rest}"
            else:
                new = f"controlnet_cond_embedding.blocks.{n - 1}.{rest}"
            out[new] = val
        elif key.startswith("zero_convs."):
            i = int(key.split(".")[1])
            rest = key.split(".", 3)[3]  # zero_convs.N.0.<rest>
            out[f"controlnet_down_blocks.{i}.{rest}"] = val
        elif key.startswith("middle_block_out.0."):
            out[f"controlnet_mid_block.{key[len('middle_block_out.0.'):]}"] = val
    return out


# ---------------------------------------------------------------------------
# K5: text encoders
# ---------------------------------------------------------------------------


def convert_ldm_clip(
    state: Mapping[str, np.ndarray],
    prefix: str = "cond_stage_model.transformer.",
) -> Dict[str, np.ndarray]:
    """CLIP-L: strip the LDM prefix (keys already use HF naming;
    convert_ldm_clip_checkpoint analog, convert_from_A1111.py:682-709)."""
    out = {}
    for k, v in state.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        if rest.endswith("position_ids"):
            continue
        if not rest.startswith("text_model."):
            rest = "text_model." + rest
        out[rest] = v
    if not out:
        raise ValueError(f"no keys under {prefix!r}")
    return out


def convert_open_clip(
    state: Mapping[str, np.ndarray],
    prefix: str = "conditioner.embedders.1.model.",
) -> Dict[str, np.ndarray]:
    """OpenCLIP (SDXL bigG) -> HF CLIPTextModelWithProjection keys: resblocks
    -> encoder.layers, fused attn in_proj split into q/k/v."""
    src = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if not src:
        raise ValueError(f"no keys under {prefix!r}")
    out: Dict[str, np.ndarray] = {}
    tm = "text_model."
    for key, val in src.items():
        if key in ("logit_scale", "text_projection"):
            if key == "text_projection":
                # open_clip stores [hidden, proj] as a parameter used as
                # x @ W; HF stores Linear weight [proj, hidden]
                out["text_projection.weight"] = np.ascontiguousarray(val.T)
            continue
        if key == "token_embedding.weight":
            out[tm + "embeddings.token_embedding.weight"] = val
            continue
        if key == "positional_embedding":
            out[tm + "embeddings.position_embedding.weight"] = val
            continue
        if key.startswith("ln_final."):
            out[tm + "final_layer_norm." + key[len("ln_final."):]] = val
            continue
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)", key)
        if m:
            i, rest = m.group(1), m.group(2)
            base = f"{tm}encoder.layers.{i}."
            if rest.startswith("attn.in_proj_"):
                kind = rest[len("attn.in_proj_"):]  # weight | bias
                q, k_, v_ = np.split(val, 3, axis=0)
                out[base + f"self_attn.q_proj.{kind}"] = q
                out[base + f"self_attn.k_proj.{kind}"] = k_
                out[base + f"self_attn.v_proj.{kind}"] = v_
            elif rest.startswith("attn.out_proj."):
                out[base + "self_attn.out_proj." + rest[len("attn.out_proj."):]] = val
            elif rest.startswith("ln_1."):
                out[base + "layer_norm1." + rest[len("ln_1."):]] = val
            elif rest.startswith("ln_2."):
                out[base + "layer_norm2." + rest[len("ln_2."):]] = val
            elif rest.startswith("mlp.c_fc."):
                out[base + "mlp.fc1." + rest[len("mlp.c_fc."):]] = val
            elif rest.startswith("mlp.c_proj."):
                out[base + "mlp.fc2." + rest[len("mlp.c_proj."):]] = val
            else:
                raise ValueError(f"unmapped OpenCLIP key {prefix}{key}")
            continue
        raise ValueError(f"unmapped OpenCLIP key {prefix}{key}")
    return out


# ---------------------------------------------------------------------------
# K7: master converter
# ---------------------------------------------------------------------------


def detect_model_type(state: Mapping[str, np.ndarray]) -> str:
    if any(k.startswith("conditioner.embedders.1.") for k in state):
        return "sdxl"
    if any(k.startswith("cond_stage_model.model.") for k in state):
        return "sd2"
    return "sd15"


def infer_unet_params_from_state(state: Mapping[str, np.ndarray]) -> dict:
    """Derive LDM unet yaml params from tensor shapes when no yaml is given
    (replaces the reference's network yaml fetch, convert_from_A1111.py:
    822-872 — this environment is air-gapped)."""
    p = "model.diffusion_model."
    conv_in = state[p + "input_blocks.0.0.weight"]
    model_channels = conv_in.shape[0]
    in_channels = conv_in.shape[1]
    # channel_mult from resnet conv1 output widths at each down block
    mults = []
    layers = 0
    idx = 1
    while p + f"input_blocks.{idx}.0.in_layers.2.weight" in state:
        idx += 1
    # count resnets before first downsample: keys input_blocks.N.0.op
    # simpler: num_res_blocks = count of consecutive resnet blocks
    n = 1
    while p + f"input_blocks.{n}.0.in_layers.2.weight" in state:
        n += 1
    # find first downsample index
    ds_idx = None
    i = 1
    while p + f"input_blocks.{i}.0.in_layers.2.weight" in state or \
            p + f"input_blocks.{i}.0.op.weight" in state:
        if p + f"input_blocks.{i}.0.op.weight" in state:
            ds_idx = i
            break
        i += 1
    num_res_blocks = (ds_idx - 1) if ds_idx else (i - 1)
    # walk blocks for widths
    widths = [model_channels]
    i = 1
    while True:
        key = p + f"input_blocks.{i}.0.in_layers.2.weight"
        opkey = p + f"input_blocks.{i}.0.op.weight"
        if key in state:
            widths.append(state[key].shape[0])
        elif opkey not in state:
            break
        i += 1
    block_widths = widths[1::num_res_blocks] if num_res_blocks else widths
    channel_mult = tuple(w // model_channels for w in block_widths)

    # attention resolutions + transformer depth per level
    attn_res = []
    depth = []
    ds = 1
    for lvl in range(len(channel_mult)):
        first_block = 1 + lvl * (num_res_blocks + 1)
        akey = p + f"input_blocks.{first_block}.1.transformer_blocks.0.attn1.to_q.weight"
        if akey in state:
            attn_res.append(ds)
            d = 0
            while (
                p
                + f"input_blocks.{first_block}.1.transformer_blocks.{d}.attn1.to_q.weight"
                in state
            ):
                d += 1
            depth.append(d)
        else:
            depth.append(0)
        ds *= 2

    ctx_key = next(
        (k for k in state if k.endswith("attn2.to_k.weight") and k.startswith(p)),
        None,
    )
    context_dim = state[ctx_key].shape[1] if ctx_key else 768
    proj_key = next(
        (k for k in state if ".1.proj_in.weight" in k and k.startswith(p)), None
    )
    use_linear = proj_key is not None and state[proj_key].ndim == 2
    adm = None
    if p + "label_emb.0.0.weight" in state:
        adm = state[p + "label_emb.0.0.weight"].shape[1]

    nonzero_depth = [d for d in depth if d > 0]
    tdepth = (
        nonzero_depth[0]
        if len(set(nonzero_depth)) <= 1
        else [d for d in depth]
    )
    # head count: SD1.x uses 8 heads; SD2/SDXL use 64-channel heads
    num_head_channels = 64 if (use_linear or context_dim >= 1024) else None
    return dict(
        model_channels=model_channels,
        in_channels=in_channels,
        channel_mult=channel_mult,
        num_res_blocks=num_res_blocks,
        attention_resolutions=attn_res,
        transformer_depth=tdepth,
        context_dim=context_dim,
        use_linear_in_transformer=use_linear,
        adm_in_channels=adm,
        num_heads=8,
        num_head_channels=num_head_channels,
    )


def infer_vae_params_from_state(
    state: Mapping[str, np.ndarray], prefix: str = "first_stage_model."
) -> dict:
    """Derive LDM VAE yaml params from tensor shapes (air-gapped analog of
    the yaml fetch)."""
    ch = state[prefix + "encoder.conv_in.weight"].shape[0]
    in_ch = state[prefix + "encoder.conv_in.weight"].shape[1]
    z2 = state[prefix + "quant_conv.weight"].shape[0]
    out_ch = state[prefix + "decoder.conv_out.weight"].shape[0]
    # blocks / widths
    n_blocks = 1 + max(
        int(m.group(1))
        for k in state
        if (m := re.match(re.escape(prefix) + r"encoder\.down\.(\d+)\.", k))
    )
    n_res = 1 + max(
        int(m.group(1))
        for k in state
        if (m := re.match(re.escape(prefix) + r"encoder\.down\.0\.block\.(\d+)\.", k))
    )
    mult = []
    for i in range(n_blocks):
        w = state[prefix + f"encoder.down.{i}.block.{n_res - 1}.conv2.weight"]
        mult.append(w.shape[0] // ch)
    return dict(
        ch=ch,
        ch_mult=tuple(mult),
        num_res_blocks=n_res,
        z_channels=z2 // 2,
        in_channels=in_ch,
        out_ch=out_ch,
    )


def infer_clip_config(flat: Mapping[str, np.ndarray], with_projection=False) -> dict:
    """Derive a CLIPTextConfig dict from converted HF-named weights.  Head
    count follows the canonical towers (hidden 768 -> 12, 1024 -> 16,
    1280 -> 20); activation is quick_gelu for ViT-L, gelu otherwise."""
    tok = flat["text_model.embeddings.token_embedding.weight"]
    vocab, hidden = tok.shape
    pos = flat["text_model.embeddings.position_embedding.weight"].shape[0]
    layers = 1 + max(
        int(m.group(1))
        for k in flat
        if (m := re.match(r"text_model\.encoder\.layers\.(\d+)\.", k))
    )
    inter = flat["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0]
    heads = {768: 12, 1024: 16, 1280: 20}.get(hidden, max(hidden // 64, 1))
    cfg = dict(
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=inter,
        num_hidden_layers=layers,
        num_attention_heads=heads,
        max_position_embeddings=pos,
        hidden_act="quick_gelu" if hidden == 768 else "gelu",
        architectures=[
            "CLIPTextModelWithProjection" if with_projection else "CLIPTextModel"
        ],
    )
    if with_projection and "text_projection.weight" in flat:
        cfg["projection_dim"] = flat["text_projection.weight"].shape[0]
    return cfg


def convert_a1111_checkpoint(
    state: Mapping[str, np.ndarray],
    extract_ema_weights: bool = False,
    scaling_factor: Optional[float] = None,
) -> Tuple[dict, dict]:
    """Single-file LDM state dict ->
    ({component: flat diffusers-named tensors}, {component: config dict})."""
    # unwrap nested state_dict (ref: convert_from_A1111.py:812-819)
    if "state_dict" in state:
        state = state["state_dict"]  # type: ignore[index]
    model_type = detect_model_type(state)
    if extract_ema_weights:
        state = extract_ema(state)

    unet_params = infer_unet_params_from_state(state)
    unet_cfg = create_unet_config(unet_params)
    weights = {
        "unet": convert_ldm_unet(state, unet_cfg),
        "vae": convert_ldm_vae(state),
    }
    vae_params = infer_vae_params_from_state(state)
    configs = {
        "unet": unet_cfg,
        "vae": create_vae_config(
            vae_params,
            scaling_factor or (0.13025 if model_type == "sdxl" else 0.18215),
        ),
    }

    if model_type == "sdxl":
        weights["text_encoder"] = convert_ldm_clip(
            state, "conditioner.embedders.0.transformer."
        )
        weights["text_encoder_2"] = convert_open_clip(state)
        configs["text_encoder_2"] = infer_clip_config(
            weights["text_encoder_2"], with_projection=True
        )
    elif model_type == "sd2":
        # SD2.x: OpenCLIP-H tower under cond_stage_model.model.
        weights["text_encoder"] = convert_open_clip(
            state, "cond_stage_model.model."
        )
        weights["text_encoder"].pop("text_projection.weight", None)
    else:
        weights["text_encoder"] = convert_ldm_clip(state)
    configs["text_encoder"] = infer_clip_config(weights["text_encoder"])
    configs["model_type"] = model_type
    return weights, configs
