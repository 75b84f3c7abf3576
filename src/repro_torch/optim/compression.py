"""Error-feedback gradient compression for data-parallel sync, ported from
`repro.optim.compression`.

Two codecs:
- int8 per-tensor-scale quantization (4x less traffic than fp32),
- top-k magnitude sparsification (sends k values and their indices).

Both keep a local error-feedback residual, so what compression loses
carries into later steps instead of being lost (Karimireddy et al.,
2019). They run around the collective: compress, all-gather, decompress
(`distributed/collectives.py`). Trees are the port's params trees; their
leaves pair by dict key, as `optim/optimizer.py` pairs them.

`torch.round` rounds half to even, as `jnp.round` does, so the int8
payloads, scales and residuals are the reference's bit for bit on fp32
inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree_map, tree_unflatten, tree_zip


# ---------------------------------------------------------------------------
# int8 with per-tensor scale


def int8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress(grads, residual, encode, decode):
    """(first payload tree, second payload tree, new residual) of `encode`
    applied to each leaf plus its residual."""
    out = []
    for g, r in tree_zip(grads, residual):
        gf = g.float() + r
        a, b = encode(gf)
        out.append((a, b, gf - decode(a, b, gf.shape)))
    return tuple(tree_unflatten(grads, list(col)) for col in zip(*out))


def int8_compress_tree(grads, residual):
    """Returns (quantized tree, scales tree, new residual)."""
    return _compress(grads, residual, int8_encode,
                     lambda q, s, _: int8_decode(q, s))


def int8_decompress_tree(q_tree, s_tree):
    return tree_map(int8_decode, q_tree, s_tree)


def init_residual(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


# ---------------------------------------------------------------------------
# top-k sparsification


def topk_encode(x: torch.Tensor, frac: float = 0.01):
    xf = x.float().reshape(-1)
    k = max(1, int(xf.numel() * frac))
    _, idx = torch.topk(xf.abs(), k)
    return xf[idx], idx, tuple(x.shape)


def topk_decode(vals, idx, shape):
    out = torch.zeros(int(torch.Size(shape).numel()), dtype=torch.float32,
                      device=vals.device)
    return out.index_put_((idx,), vals).reshape(shape)


def topk_compress_tree(grads, residual, frac: float = 0.01):
    """Returns (values tree, indices tree, new residual)."""
    return _compress(grads, residual,
                     lambda gf: topk_encode(gf, frac)[:2], topk_decode)
