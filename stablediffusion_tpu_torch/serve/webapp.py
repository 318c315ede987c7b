"""Web UI: a self-contained HTML page the worker serves at GET /ui.

The port's copy of the jax-free parts of ``stablediffusion_tpu/serve/
webapp.py``: ``INDEX_HTML`` / ``index_html`` (:175), which posts the job
schema to POST /, the functions that build requests, shared with a Gradio
front end (``parse_lora_spec`` :179, ``parse_ti_spec`` :192,
``build_ui_request`` :208, ``build_train_request`` :298) and
``launch_gradio`` (:315), which
imports gradio inside the call (it is optional).  The scheduler choices come
from the port's own registry.

Controls mirror the reference's surface: model type/checkpoint/LoRAs with
per-LoRA weights, task radio (txt2img/img2img/inpaint), steps/cfg/clip-skip/
seed/size/images-per-prompt, strength + image upload for non-txt2img,
scheduler selector, int8 quantization, and a LoRA train form.
"""

from __future__ import annotations

from stablediffusion_tpu_torch.schedulers import SCHEDULER_NAMES

_SCHED_OPTIONS = "".join(
    f'<option value="{n}">{n}</option>' for n in SCHEDULER_NAMES if n != "DDPM"
)

INDEX_HTML = """<!DOCTYPE html>
<html><head><title>stablediffusion-tpu</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; background: #101418; color: #e8e8e8; }}
 fieldset {{ border: 1px solid #333; margin-bottom: 1em; }}
 label {{ display: inline-block; min-width: 11em; margin: 0.2em 0; }}
 input, select, textarea {{ background: #1c2228; color: #e8e8e8; border: 1px solid #444; }}
 textarea {{ width: 40em; }}
 #gallery img {{ max-width: 320px; margin: 4px; border: 1px solid #333; }}
 button {{ padding: 0.5em 2em; font-size: 1.1em; }}
 #status {{ color: #8fc7ff; margin-left: 1em; }}
</style></head>
<body>
<h2>stablediffusion-tpu</h2>
<fieldset><legend>Model</legend>
 <label>Type</label>
 <select id="model_type"><option>sd15</option><option selected>sdxl</option><option>sd3</option></select><br>
 <label>Checkpoint</label><input id="model_name" placeholder="(loaded model)"><br>
 <label>LoRAs (name:weight,..)</label><input id="loras" placeholder="style:0.7,detail:0.5"><br>
 <label>Textual inversions (path[:token],..)</label><input id="ti" placeholder="embeds/thing.pt:mytoken"><br>
 <label>Scheduler</label><select id="scheduler">{sched_options}</select><br>
 <label>Quantize (int8, approximate)</label>
 <select id="quantize"><option value="">off</option><option>auto</option><option>w8</option><option>w8a8</option><option>w8a8:2048</option></select>
</fieldset>
<fieldset><legend>Task</legend>
 <label><input type="radio" name="task" value="txt2img" checked> Text-To-Image</label>
 <label><input type="radio" name="task" value="img2img"> Image-To-Image</label>
 <label><input type="radio" name="task" value="inpaint"> Inpainting</label><br>
 <label>Init image</label><input type="file" id="image"><br>
 <label>Mask image</label><input type="file" id="mask_image"><br>
 <label>Strength</label><input type="range" id="strength" min="0" max="1" step="0.05" value="0.7"><br>
 <label>Image CFG (InstructPix2Pix, 0=off)</label><input type="number" id="image_cfg" value="0" min="0" max="10" step="0.5">
</fieldset>
<fieldset><legend>Parameters</legend>
 <label>Prompt</label><textarea id="prompt" rows="2"></textarea><br>
 <label>Negative prompt</label><textarea id="negative_prompt" rows="1"></textarea><br>
 <label>Steps</label><input type="number" id="steps" value="30" min="1" max="100">
 <label>CFG</label><input type="number" id="cfg" value="7" min="0" max="15" step="0.5"><br>
 <label>Clip skip</label><input type="number" id="clip_skip" value="0" min="0" max="4">
 <label>Seed (-1 random)</label><input type="number" id="seed" value="-1"><br>
 <label>Width</label><input type="number" id="width" value="1024" step="64" min="256" max="2048">
 <label>Height</label><input type="number" id="height" value="1024" step="64" min="256" max="2048"><br>
 <label>Images per prompt</label><input type="number" id="nimg" value="1" min="1" max="16">
 <label><input type="checkbox" id="vae_tiling"> Tiled VAE (2048²+)</label>
 <label><input type="checkbox" id="prompt_weighting"> (word:1.2) weighting</label>
 <label><input type="checkbox" id="freeu"> FreeU</label>
 <label>PAG scale (0=off)</label><input type="number" id="pag_scale" value="0" min="0" max="10" step="0.5"><br>
 <label>Hires fix scale (0=off)</label><input type="number" id="hires_scale" value="0" min="0" max="4" step="0.25">
 <label>Hires strength</label><input type="range" id="hires_strength" min="0" max="1" step="0.05" value="0.7">
</fieldset>
<button onclick="generate()">Generate</button><span id="status"></span>
<div id="gallery"></div>
<fieldset><legend>Train LoRA</legend>
 <label>Data dir (on server)</label><input id="train_data_dir" placeholder="/data/my-style"><br>
 <label>Rank</label><input type="number" id="train_rank" value="16" min="1" max="128">
 <label>Steps</label><input type="number" id="train_steps" value="500" min="1"><br>
 <label>Resolution</label><input type="number" id="train_res" value="512" step="64">
 <label>Output dir</label><input id="train_out" value="lora-out"><br>
 <button onclick="train()">Train</button><span id="train_status"></span>
</fieldset>
<script>
async function fileToB64(input) {{
  const f = input.files[0];
  if (!f) return null;
  const buf = await f.arrayBuffer();
  let s = ""; new Uint8Array(buf).forEach(b => s += String.fromCharCode(b));
  return btoa(s);
}}
async function generate() {{
  const g = id => document.getElementById(id);
  const task = document.querySelector('input[name=task]:checked').value;
  const input = {{
    prompt: g('prompt').value,
    negative_prompt: g('negative_prompt').value || null,
    num_inference_steps: +g('steps').value,
    guidance_scale: +g('cfg').value,
    clip_skip: +g('clip_skip').value || null,
    height: +g('height').value, width: +g('width').value,
    num_images_per_prompt: +g('nimg').value,
  }};
  if (+g('seed').value >= 0) input.seed = +g('seed').value;
  if (g('vae_tiling').checked) input.vae_tiling = true;
  if (g('prompt_weighting').checked) input.prompt_weighting = true;
  if (g('freeu').checked) input.freeu = true;
  if (+g('pag_scale').value > 0) input.pag_scale = +g('pag_scale').value;
  if (task === 'img2img' && +g('image_cfg').value > 0)
    input.image_guidance_scale = +g('image_cfg').value;
  if (+g('hires_scale').value > 1) {{
    input.hires_scale = +g('hires_scale').value;
    input.hires_strength = +g('hires_strength').value;
  }}
  const model = {{}};
  if (g('model_name').value) {{
    model.type = g('model_type').value; model.name = g('model_name').value;
  }}
  if (g('scheduler').value) model.scheduler = g('scheduler').value;
  if (g('quantize').value) model.quantize = g('quantize').value;
  if (g('loras').value) {{
    model.loras = {{}};
    g('loras').value.split(',').forEach(p => {{
      const [n, w] = p.split(':'); model.loras[n.trim()] = +(w || 1);
    }});
  }}
  if (g('ti').value) {{
    model.textual_inversion = g('ti').value.split(',').map(p => {{
      const i = p.lastIndexOf(':');
      return i > 1 ? {{path: p.slice(0, i).trim(), token: p.slice(i + 1).trim()}}
                   : {{path: p.trim()}};
    }});
  }}
  if (Object.keys(model).length) input.model = model;
  if (task !== 'txt2img') {{
    input.image = await fileToB64(g('image'));
    input.strength = +g('strength').value;
  }}
  if (task === 'inpaint') input.mask_image = await fileToB64(g('mask_image'));
  g('status').textContent = 'generating...';
  const t0 = Date.now();
  const resp = await fetch('/', {{method: 'POST',
    body: JSON.stringify({{id: 'ui', input}})}});
  const data = await resp.json();
  if (data.error) {{ g('status').textContent = 'error: ' + data.error; return; }}
  g('status').textContent =
    `seed ${{data.seed}} · ${{((Date.now()-t0)/1000).toFixed(1)}}s`;
  const gal = document.getElementById('gallery'); gal.innerHTML = '';
  data.images.forEach(b64 => {{
    const img = document.createElement('img');
    img.src = 'data:image/jpeg;base64,' + b64; gal.appendChild(img);
  }});
}}
async function train() {{
  const g = id => document.getElementById(id);
  if (!g('train_data_dir').value) {{ g('train_status').textContent = 'data dir required'; return; }}
  g('train_status').textContent = 'training...';
  const resp = await fetch('/', {{method: 'POST', body: JSON.stringify({{id: 'ui-train',
    input: {{mode: 'train', train: {{
      data_dir: g('train_data_dir').value,
      rank: +g('train_rank').value,
      max_train_steps: +g('train_steps').value,
      resolution: +g('train_res').value,
      output_dir: g('train_out').value,
    }}}}}})}});
  const data = await resp.json();
  g('train_status').textContent = data.error ? ('error: ' + data.error)
    : ('done: ' + data.lora_path);
}}
</script>
</body></html>
"""


def index_html() -> str:
    return INDEX_HTML.format(sched_options=_SCHED_OPTIONS)


def parse_lora_spec(text: str) -> dict:
    """"name:weight,name2" -> {name: weight} (weight defaults to 1.0); the
    same grammar as the HTML UI's LoRA field."""
    out = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        out[name.strip()] = float(w) if w.strip() else 1.0
    return out


def parse_ti_spec(text: str) -> list:
    """"path[:token],..." -> [{"path":..., "token":...}] (token optional);
    splits on the LAST ':' so Windows-style / nested paths survive."""
    out = []
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        i = part.rfind(":")
        if i > 1:
            out.append({"path": part[:i].strip(), "token": part[i + 1:].strip()})
        else:
            out.append({"path": part})
    return out


def build_ui_request(
    task: str,
    prompt: str,
    negative_prompt: str = "",
    steps: int = 30,
    cfg: float = 7.0,
    seed: int = -1,
    width: int = 1024,
    height: int = 1024,
    num_images: int = 1,
    clip_skip: int = 0,
    strength: float = 0.7,
    scheduler: str = "",
    model_type: str = "",
    checkpoint: str = "",
    loras: str = "",
    textual_inversions: str = "",
    lora_te_scale: float | None = None,
    image=None,
    mask_image=None,
    prompt_weighting: bool = False,
    vae_tiling: bool = False,
    hires_scale: float = 0.0,
    hires_strength: float = 0.7,
    quantize: str = "",
    freeu: bool = False,
    pag_scale: float = 0.0,
    image_guidance_scale: float = 0.0,
) -> dict:
    """Pure UI-state -> handler-request mapping shared by the Gradio
    front end and tests (the JSON job schema the HTML UI posts; images may
    be numpy arrays, which the in-process handler accepts directly)."""
    req = {
        "prompt": prompt,
        "negative_prompt": negative_prompt or None,
        "num_inference_steps": int(steps),
        "guidance_scale": float(cfg),
        "clip_skip": int(clip_skip) or None,
        "height": int(height),
        "width": int(width),
        "num_images_per_prompt": int(num_images),
    }
    if seed is not None and int(seed) >= 0:
        req["seed"] = int(seed)
    if prompt_weighting:
        req["prompt_weighting"] = True
    if vae_tiling:
        req["vae_tiling"] = True
    if freeu:
        req["freeu"] = True
    if pag_scale and float(pag_scale) > 0:
        req["pag_scale"] = float(pag_scale)
    if hires_scale and float(hires_scale) > 1:
        req["hires_scale"] = float(hires_scale)
        req["hires_strength"] = float(hires_strength)
    if lora_te_scale is not None:
        req["cross_attention_kwargs"] = {"scale": float(lora_te_scale)}
    model = {}
    if checkpoint:
        model["type"] = model_type or "sd15"
        model["name"] = checkpoint
    if scheduler:
        model["scheduler"] = scheduler
    lora_map = parse_lora_spec(loras)
    if lora_map:
        model["loras"] = lora_map
    tis = parse_ti_spec(textual_inversions)
    if tis:
        model["textual_inversion"] = tis
    if quantize:
        model["quantize"] = quantize
    if model:
        req["model"] = model
    if task != "txt2img":
        if image is None:
            raise ValueError(f"{task} needs an init image")
        req["image"] = image
        req["strength"] = float(strength)
        if task == "img2img" and image_guidance_scale and (
            float(image_guidance_scale) > 0
        ):
            req["image_guidance_scale"] = float(image_guidance_scale)
            del req["strength"]  # ip2p runs the full schedule
    if task == "inpaint":
        if mask_image is None:
            raise ValueError("inpaint needs a mask image")
        req["mask_image"] = mask_image
    return req


def build_train_request(
    data_dir: str, rank: int, steps: int, resolution: int, output_dir: str
) -> dict:
    if not data_dir:
        raise ValueError("data dir required")
    return {
        "mode": "train",
        "train": {
            "data_dir": data_dir,
            "rank": int(rank),
            "max_train_steps": int(steps),
            "resolution": int(resolution),
            "output_dir": output_dir,
        },
    }


def launch_gradio(handler, port: int = 7860):  # pragma: no cover - optional dep
    """Native Gradio front end with the HTML UI's controls: model type,
    checkpoint, LoRA weights, scheduler and quantization, the task with
    image/mask upload and strength, the parameter sliders, Generate, and a
    train tab.  All request construction lives in `build_ui_request`
    (tested without gradio)."""
    import gradio as gr

    sched_names = [n for n in SCHEDULER_NAMES if n != "DDPM"]

    def generate(task, prompt, negative, steps, cfg, lora_te_scale,
                 clip_skip, seed, width, height, num_images, strength,
                 model_type, checkpoint, loras, tis, scheduler, quantize,
                 prompt_weighting, vae_tiling, freeu, pag_scale,
                 image_cfg, hires_scale, image, mask):
        try:
            req = build_ui_request(
                task, prompt, negative_prompt=negative, steps=steps, cfg=cfg,
                seed=seed, width=width, height=height, num_images=num_images,
                clip_skip=clip_skip, strength=strength, scheduler=scheduler,
                model_type=model_type, checkpoint=checkpoint, loras=loras,
                textual_inversions=tis,
                lora_te_scale=lora_te_scale if lora_te_scale else None,
                image=image, mask_image=mask,
                prompt_weighting=prompt_weighting, vae_tiling=vae_tiling,
                freeu=freeu, pag_scale=pag_scale,
                image_guidance_scale=image_cfg, hires_scale=hires_scale,
                quantize=quantize,
            )
        except ValueError as e:
            raise gr.Error(str(e))
        resp = handler(req)
        if "error" in resp:
            raise gr.Error(resp["error"])
        import base64
        import io

        from PIL import Image

        return (
            [Image.open(io.BytesIO(base64.b64decode(b)))
             for b in resp["images"]],
            f"seed {resp.get('seed')}",
        )

    def train(data_dir, rank, steps, resolution, output_dir):
        try:
            req = build_train_request(data_dir, rank, steps, resolution,
                                      output_dir)
        except ValueError as e:
            raise gr.Error(str(e))
        resp = handler(req)
        if "error" in resp:
            raise gr.Error(resp["error"])
        return f"done: {resp.get('lora_path')}"

    with gr.Blocks(title="stablediffusion-tpu") as demo:
        with gr.Tab("Inference"):
            with gr.Group():
                model_type = gr.Radio(["sd15", "sdxl", "sd3"], value="sdxl",
                                      label="Stable Diffusion model type")
                checkpoint = gr.Textbox(label="Checkpoint",
                                        placeholder="(loaded model)")
                loras = gr.Textbox(label="LoRAs (name:weight,...)",
                                   placeholder="style:0.7,detail:0.5")
                tis = gr.Textbox(label="Textual inversions (path[:token],...)")
                scheduler = gr.Dropdown(sched_names, value="DPM++ 2M Karras",
                                        label="Scheduler")
                quantize = gr.Dropdown(
                    ["", "auto", "w8", "w8a8", "w8a8:2048"], value="",
                    label="Quantize (int8, approximate)")
            with gr.Group():
                task = gr.Radio(["txt2img", "img2img", "inpaint"],
                                value="txt2img", label="Generation task")
                image = gr.Image(label="Init image", type="numpy",
                                 visible=False)
                mask = gr.Image(label="Mask image", type="numpy",
                                visible=False)
                strength = gr.Slider(0, 1, 0.7, step=0.01, label="Strength",
                                     visible=False)
                image_cfg = gr.Slider(
                    0, 10, 0, step=0.5, visible=False,
                    label="Image CFG (InstructPix2Pix, 0 = off)")

                def _task_vis(t):
                    non_txt = t != "txt2img"
                    return (
                        gr.update(visible=non_txt),
                        gr.update(visible=t == "inpaint"),
                        gr.update(visible=non_txt),
                        gr.update(visible=t == "img2img"),
                    )

                task.change(_task_vis, inputs=task,
                            outputs=[image, mask, strength, image_cfg])
            prompt = gr.Textbox(label="Prompt", lines=2)
            negative = gr.Textbox(label="Negative prompt")
            with gr.Row():
                steps = gr.Slider(1, 100, 30, step=1, label="Steps")
                cfg = gr.Slider(0, 15, 7, step=0.1, label="Guidance scale")
                lora_te_scale = gr.Slider(
                    0, 1, 0, step=0.01,
                    label="LoRA text-encoder strength (0 = default)")
                clip_skip = gr.Slider(0, 4, 0, step=1, label="Clip skip")
            with gr.Row():
                seed = gr.Slider(-1, 1_000_000_000, -1, step=1, label="Seed")
                width = gr.Slider(256, 2048, 1024, step=64, label="Width")
                height = gr.Slider(256, 2048, 1024, step=64, label="Height")
                num_images = gr.Slider(1, 16, 1, step=1,
                                       label="Images per prompt")
            with gr.Row():
                prompt_weighting = gr.Checkbox(label="(word:1.2) weighting")
                vae_tiling = gr.Checkbox(label="Tiled VAE (2048²+)")
                freeu = gr.Checkbox(label="FreeU")
                pag_scale = gr.Slider(0, 10, 0, step=0.5,
                                      label="PAG scale (0 = off)")
                hires_scale = gr.Slider(0, 4, 0, step=0.25,
                                        label="Hires fix scale (0 = off)")
            go = gr.Button("Generate")
            gallery = gr.Gallery(label="Generated images",
                                 object_fit="contain")
            status = gr.Markdown()
            go.click(
                generate,
                inputs=[task, prompt, negative, steps, cfg, lora_te_scale,
                        clip_skip, seed, width, height, num_images, strength,
                        model_type, checkpoint, loras, tis, scheduler,
                        quantize, prompt_weighting, vae_tiling, freeu,
                        pag_scale, image_cfg, hires_scale, image, mask],
                outputs=[gallery, status],
            )
        with gr.Tab("Train"):
            data_dir = gr.Textbox(label="Data dir (on server)")
            with gr.Row():
                rank = gr.Slider(1, 128, 16, step=1, label="LoRA rank")
                tsteps = gr.Slider(1, 10_000, 500, step=1, label="Steps")
                res = gr.Slider(256, 1024, 512, step=64, label="Resolution")
            out_dir = gr.Textbox(label="Output dir", value="lora-out")
            tgo = gr.Button("Train")
            tstatus = gr.Markdown()
            tgo.click(train, inputs=[data_dir, rank, tsteps, res, out_dir],
                      outputs=tstatus)
    demo.launch(server_port=port)
