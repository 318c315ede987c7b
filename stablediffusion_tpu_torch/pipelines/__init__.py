"""The txt2img pipeline."""
