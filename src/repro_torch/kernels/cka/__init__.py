"""CKA Gram terms (ports `repro.kernels.cka`)."""
