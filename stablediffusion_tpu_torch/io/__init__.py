"""Weight exchange with the JAX package's param trees."""
