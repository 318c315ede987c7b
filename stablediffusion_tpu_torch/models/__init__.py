"""CLIP text encoder, UNet and VAE decoder as torch modules."""
