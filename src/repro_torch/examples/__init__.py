"""Counterparts of the JAX package's examples (`examples/` at the root of
the repo), run as ``python -m repro_torch.examples.<name>``."""
