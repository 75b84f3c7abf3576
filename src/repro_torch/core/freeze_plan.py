"""Freeze plans: SimFreeze's decisions in the form the execution engine
reads (counterpart of `repro.core.freeze_plan`).

- `LayerFreezePlan` — unrolled paper models: one flag per layer.
- `FreezePlan` — scanned LMs: one flag per layer group, plus embed/head.

Plans are frozen dataclasses, so they compare and hash by value. In the
forward pass a frozen layer's params are detached (`maybe_stop`), the
counterpart of JAX's `stop_gradient`; with serving and probing under
`torch.inference_mode()` the plan has no effect on any value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

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
