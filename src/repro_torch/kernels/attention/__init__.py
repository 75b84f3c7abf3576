"""Flash-attention forward (ports `repro.kernels.attention`)."""
