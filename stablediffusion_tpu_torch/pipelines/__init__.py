"""The unified txt2img / img2img / inpaint pipeline."""
