"""Linear Centered Kernel Alignment (CKA) — the layer-convergence metric
behind SimFreeze (paper Eq. 1, after Kornblith et al. 2019); ports
`repro.core.cka`.

Two equal ways to evaluate CKA(X, Y) for centered X [n, dx], Y [n, dy]
(row = example, column = feature):

- *feature form*  ||Y^T X||_F^2 / (||X^T X||_F ||Y^T Y||_F): Grams over
  features, cheap when d <= n;
- *example form*  <K, L>_F / (||K||_F ||L||_F) with K = X X^T,
  L = Y Y^T: Grams over examples, cheap when n << d.

``cka(X, Y)`` picks the cheaper form. With ``use_kernel`` it always goes
through the CKA Gram-term kernels (repro_torch.kernels.cka), whatever the
shape — the JAX package routes it the same way (through its feature-form
entry point). On the card that module picks the form by the same rule:
the feature form (one Gram of [X | Y]) when dx + dy <= n, the example
form otherwise.
"""
from __future__ import annotations

import torch


def _center(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x - x.mean(dim=0, keepdim=True)


def _flatten_features(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] activations -> [n, d]. For token sequences [B, S, D] each
    (batch, position) pair is an example (standard minibatch CKA usage)."""
    if x.dim() == 2:
        return x
    if x.dim() == 3:  # [B, S, D] -> [B*S, D]
        return x.reshape(-1, x.shape[-1])
    return x.reshape(x.shape[0], -1)  # conv maps: flatten all features


def cka_feature_form(x: torch.Tensor, y: torch.Tensor,
                     use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        from repro_torch.kernels.cka import ops as cka_ops

        num, nx, ny = cka_ops.cka_terms(x, y)
    else:
        xty = y.T @ x
        num = (xty * xty).sum()
        xtx = x.T @ x
        yty = y.T @ y
        nx = torch.sqrt((xtx * xtx).sum())
        ny = torch.sqrt((yty * yty).sum())
    return num / torch.clamp(nx * ny, min=1e-12)


def cka_example_form(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    k = x @ x.T
    l = y @ y.T
    num = (k * l).sum()
    return num / torch.clamp(
        torch.sqrt((k * k).sum()) * torch.sqrt((l * l).sum()), min=1e-12)


def cka(x: torch.Tensor, y: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Linear CKA between two activation tensors (any matching leading
    shape). Returns a 0-d tensor in [0, 1]."""
    x = _center(_flatten_features(x))
    y = _center(_flatten_features(y))
    n, dx = x.shape
    dy = y.shape[1]
    if n < min(dx, dy) and not use_kernel:
        return cka_example_form(x, y)
    return cka_feature_form(x, y, use_kernel=use_kernel)


def layerwise_cka(feats_a, feats_b, use_kernel: bool = False):
    """CKA per layer between two lists of activations (same model probed at
    two points in time, same probe batch)."""
    return [cka(a, b, use_kernel=use_kernel) for a, b in zip(feats_a, feats_b)]
