"""CLIP text encoder, UNet and VAE as torch modules."""
