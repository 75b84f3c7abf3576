"""Freeze plans: SimFreeze's decisions in the form the execution engine
reads (counterpart of `repro.core.freeze_plan`).

- `LayerFreezePlan` — unrolled paper models: one flag per layer.
- `FreezePlan` — scanned LMs: one flag per layer group, plus embed/head;
  `lm_segments` cuts it into contiguous runs of equal flags, and
  `grad_multiplier_tree` turns it into the optimizers' 0/1 masks.

Plans are frozen dataclasses, so they compare and hash by value. In the
forward pass a frozen layer's params are detached (`maybe_stop`), the
counterpart of JAX's `stop_gradient`; with serving and probing under
`torch.inference_mode()` the plan has no effect on any value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch import tree_map


@dataclass(frozen=True)
class FreezePlan:
    groups: Tuple[bool, ...] = ()   # True = frozen
    embed: bool = False
    head: bool = False

    @property
    def num_frozen(self) -> int:
        return sum(self.groups) + int(self.embed) + int(self.head)

    @property
    def all_active(self) -> bool:
        return self.num_frozen == 0

    def freeze(self, idx: int) -> "FreezePlan":
        g = list(self.groups)
        g[idx] = True
        return dataclasses.replace(self, groups=tuple(g))

    def unfreeze(self, idx: int) -> "FreezePlan":
        g = list(self.groups)
        g[idx] = False
        return dataclasses.replace(self, groups=tuple(g))

    def frozen_fraction(self) -> float:
        n = len(self.groups) + 2
        return self.num_frozen / n


def all_active(num_groups: int) -> FreezePlan:
    return FreezePlan(groups=(False,) * num_groups)


def lm_segments(plan: FreezePlan) -> List[Tuple[int, int, bool]]:
    """Contiguous (lo, hi, frozen) runs over the group axis."""
    segs: List[Tuple[int, int, bool]] = []
    lo = 0
    for i in range(1, len(plan.groups) + 1):
        if i == len(plan.groups) or plan.groups[i] != plan.groups[lo]:
            segs.append((lo, i, plan.groups[lo]))
            lo = i
    return segs


def grad_multiplier_tree(plan: FreezePlan, params) -> dict:
    """0/1 multipliers matching an LM's params tree, for the optimizers'
    `masks`: they pin frozen slices exactly (weight decay and momentum
    must not move them). The port's blocks are a list of per-layer dicts
    in layer order, g = len(blocks) // len(plan.groups) layers a group,
    so each block leaf gets its group's multiplier as a scalar where the
    reference's stacked [G, ...] leaves get a [G] vector. Every leaf under
    "embed" (the token table, an untied head and a frontend projection)
    gets 0 under `plan.embed`; every other leaf gets 1, as in the
    reference, which masks no head under `plan.head`."""
    blocks = params["blocks"]
    g = len(blocks) // max(len(plan.groups), 1)

    def const(value):
        return lambda t: torch.full((), value, dtype=t.dtype, device=t.device)

    out = {}
    for key, sub in params.items():
        if key == "blocks":
            out[key] = [tree_map(const(0.0 if plan.groups[i // g] else 1.0),
                                 blk) for i, blk in enumerate(blocks)]
        else:
            out[key] = tree_map(const(0.0 if key == "embed" and plan.embed
                                      else 1.0), sub)
    return out


@dataclass(frozen=True)
class LayerFreezePlan:
    layers: Tuple[bool, ...] = ()

    @property
    def num_frozen(self) -> int:
        return sum(self.layers)

    def freeze(self, idx: int) -> "LayerFreezePlan":
        l = list(self.layers)
        l[idx] = True
        return LayerFreezePlan(tuple(l))

    def unfreeze(self, idx: int) -> "LayerFreezePlan":
        l = list(self.layers)
        l[idx] = False
        return LayerFreezePlan(tuple(l))

    def frozen_prefix(self) -> int:
        n = 0
        for f in self.layers:
            if not f:
                break
            n += 1
        return n


def maybe_stop(params_layer, frozen: bool):
    """A frozen layer's params, detached from autograd."""
    return tree_map(lambda t: t.detach(), params_layer) if frozen \
        else params_layer
