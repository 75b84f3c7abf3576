"""Semi-supervised continual learning (paper §IV-C): SimSiam-style
self-supervised objective on unlabeled data, followed by supervised
fine-tuning on the labeled portion (ports `repro.core.semi`).

SimSiam (Chen & He, CVPR'21): two augmented views, a projector +
predictor head, negative-cosine loss with a stop-gradient on the target
branch. The augmentations are a random crop-shift, a horizontal flip and
a brightness jitter. Their random draws (`AugmentDraws`) are an argument:
`draw_augment` draws them from a `torch.Generator`, and since the JAX
package draws them with `jax.random`, which the port cannot reproduce, a
parity test passes the reference's draws in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common


def init_simsiam_head(generator: torch.Generator, feat_dim: int,
                      proj_dim: int = 64) -> dict:
    """Projector and predictor on the generator's device."""
    zeros = torch.zeros(proj_dim, device=generator.device)
    return {
        "proj_w": common.dense_init(generator, feat_dim, (feat_dim, proj_dim)),
        "proj_b": zeros,
        "pred_w": common.dense_init(generator, proj_dim, (proj_dim, proj_dim)),
        "pred_b": zeros.clone(),
    }


@dataclass(frozen=True)
class AugmentDraws:
    """The random draws of one augmented view of a [B, H, W, C] batch:
    the crop offset (row, column), each in [0, 2 * pad) with
    pad = max(H // 8, 1); whether to flip horizontally; and the
    brightness factors [B, 1, 1, 1], 1 + 0.2 * U(-1, 1)."""
    offset: Tuple[int, int]
    flip: bool
    bright: torch.Tensor


def _pad(height: int) -> int:
    return max(height // 8, 1)  # shift by up to 12.5%


def draw_augment(generator: torch.Generator, shape) -> AugmentDraws:
    """The draws of one view of a batch of `shape` [B, H, W, C], from
    `generator` (CPU draws; `augment` moves the brightness to the
    images' device)."""
    B, H = shape[0], shape[1]
    off = torch.randint(0, 2 * _pad(H), (2,), generator=generator)
    flip = bool(torch.rand((), generator=generator) < 0.5)
    bright = 1.0 + 0.2 * (2.0 * torch.rand((B, 1, 1, 1),
                                           generator=generator) - 1.0)
    return AugmentDraws((int(off[0]), int(off[1])), flip, bright)


def augment(images: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """Random shift (edge padding + crop), horizontal flip and
    brightness jitter of [B, H, W, C] images, as `draws` says."""
    B, H, W, C = images.shape
    pad = _pad(H)
    padded = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="replicate").permute(0, 2, 3, 1)
    oy, ox = draws.offset
    imgs = padded[:, oy:oy + H, ox:ox + W, :]
    if draws.flip:
        imgs = imgs.flip(2)
    return imgs * draws.bright.to(images.device)


def _neg_cosine(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
    return -(p * z.detach()).sum(dim=-1).mean()


def simsiam_loss(backbone_feats_fn: Callable, head: dict, params,
                 images: torch.Tensor,
                 draws: Tuple[AugmentDraws, AugmentDraws]) -> torch.Tensor:
    """backbone_feats_fn(params, images) -> pooled features [B, F]; the
    two views augment with the two `draws`."""
    v1, v2 = (augment(images, d) for d in draws)
    f1 = backbone_feats_fn(params, v1)
    f2 = backbone_feats_fn(params, v2)
    z1 = f1 @ head["proj_w"] + head["proj_b"]
    z2 = f2 @ head["proj_w"] + head["proj_b"]
    p1 = z1 @ head["pred_w"] + head["pred_b"]
    p2 = z2 @ head["pred_w"] + head["pred_b"]
    return 0.5 * (_neg_cosine(p1, z2) + _neg_cosine(p2, z1))
