"""repro_torch — the PyTorch/CUDA port of the EdgeOL reproduction.

It sits beside the JAX package `repro` and keeps its module names, so each
module here has a counterpart there (`repro_torch.models.vit` ports
`repro.models.vit`, and so on). It imports torch and numpy only: never
jax and nothing of `repro`; what it needs of the jax-free modules there,
it keeps as its own copy.

The two TPU kernels on the serving and probe path are hand-written CUDA
kernels for Hopper (`csrc/`), each beside a plain PyTorch version of the
same function in its wrapper module (`kernels/attention/ops.py`,
`kernels/cka/ops.py`).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit request they raise (`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, else CUDA.

    With no explicit device and no GPU this raises instead of carrying on
    quietly on the CPU. For CUDA it also turns TF32 off for matmuls and
    convolutions: the port computes in full fp32, as the JAX reference
    does, and its parity tolerances depend on that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def tree_map(fn, tree):
    """`fn` applied to every leaf of a params tree of nested dicts and
    lists (the counterpart of `jax.tree.map` for the port's params)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
