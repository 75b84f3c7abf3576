"""Hand-written CUDA kernels for Hopper, one wrapper module each, with the
plain PyTorch version of the same function beside every kernel."""
