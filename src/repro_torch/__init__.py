"""repro_torch — the PyTorch/CUDA port of the EdgeOL reproduction.

It sits beside the JAX package `repro` and keeps its module names, so each
module here has a counterpart there (`repro_torch.models.vit` ports
`repro.models.vit`, and so on). It imports torch and numpy only: never
jax and nothing of `repro`; what it needs of the jax-free modules there,
it keeps as its own copy.

The repo's three TPU kernels are hand-written CUDA kernels for Hopper
(`csrc/`), each beside a plain PyTorch version of the same function in
its wrapper module: flash attention (`kernels/attention/ops.py`) and the
CKA Gram terms (`kernels/cka/ops.py`) on DeiT-tiny and bert-base serving
and the SimFreeze probe, flash attention also on the decoder LMs'
prefill (`models/attention.py`), and the WKV6 recurrence
(`kernels/rwkv/ops.py`) on rwkv6-3b serving (`models/rwkv6.py`,
`runtime/serve.py`).

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
    does, and its parity tolerances depend on that. And it keeps cuDNN
    to deterministic algorithms, chosen by its heuristics rather than by
    timing: a default backward-weight algorithm may sum in any order, and
    two runs of the same CNN loop must train to the same bits."""
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
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return device


def tree_leaves(tree) -> list:
    """The leaves of a params tree of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> object:
    """A tree of `tree`'s structure holding `leaves`, in `tree_leaves`
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map(fn, tree, *rest):
    """`fn` applied to every leaf of a params tree of nested dicts and
    lists, and to the matching leaves of `rest`, trees of the same
    structure (the counterpart of `jax.tree.map` for the port's params).
    Leaves pair by dict key, whatever order each dict holds its keys in,
    and the result keeps `tree`'s order. Trees whose key sets or lengths
    differ raise `ValueError`, as JAX does on a structure mismatch."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or r.keys() != tree.keys():
                raise ValueError(
                    f"tree structure mismatch: keys {sorted(tree)} against "
                    f"{sorted(r) if isinstance(r, dict) else type(r).__name__}")
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest, strict=True)]
    return fn(tree, *rest)


def tree_zip(*trees) -> list:
    """The tuples of matching leaves of `trees`, paired by key as
    `tree_map` pairs them, in the first tree's `tree_leaves` order."""
    out = []
    tree_map(lambda *leaves: out.append(leaves), *trees)
    return out
