"""The port's copies of the experiment configs (``configs/`` of the repo
imports the JAX package)."""
