"""Checkpoint IO: diffusers folders, safetensors, and weight exchange with the JAX package's param trees."""
