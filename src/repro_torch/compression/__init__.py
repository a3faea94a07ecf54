"""Latent codec and rate-distortion ladder (copies of the JAX package's
JAX-free modules, import paths rewritten)."""
