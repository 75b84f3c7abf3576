"""Train steps of the port (counterpart of `repro.runtime.train_loop`):
one eager, freeze-plan-aware step per plan, with the same recompile
ledger as the reference's jitted cache, FLOPs per plan for the cost
model, and the host-batch and evaluation helpers serving shares.

A step takes the gradient of the model's `loss` on fresh leaves made
from the params (the stored params never require grad), turns the
`None` autograd gives a leaf the plan froze into a zero gradient, as
`jax.grad` gives zeros behind `stop_gradient`, and applies the
optimizer to every leaf, out of place. The reference's compiled path
(`multi_step`, `fused_call`, `compiled_model`) has no counterpart yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               sgdm_init, sgdm_update)


def batch_signature(batch: dict) -> Tuple:
    """Hashable (shape, dtype) signature of a host/device batch dict —
    the key the recompile ledger counts shapes by."""
    return tuple(sorted(
        (k, tuple(getattr(v, "shape", ())), str(getattr(v, "dtype", "")))
        for k, v in batch.items()))


def grads_of(loss_fn, params, batch, plan):
    """(loss, metrics, grads) of `loss_fn(params, batch, plan)`; a leaf the
    plan cut off from the loss gets a zero gradient."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, plan)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True) \
            if loss.requires_grad else [None] * len(leaves)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = tree_map(lambda t: t.detach(), metrics)
    return loss.detach(), metrics, tree_unflatten(params, grads)


@dataclass
class TrainStepCache:
    """Per-freeze-plan train steps + their FLOPs.

    `recompiles` counts distinct (plan, batch-shape) programs, as the
    reference's jit cache does: one per new plan, plus one per
    *additional* batch shape a plan is asked to handle (the first shape
    rides on the plan's own compile). PyTorch runs the steps eagerly, so
    nothing is compiled: the count is what the cost model charges."""
    model: Any
    opt_cfg: Any
    _steps: Dict[Any, Callable] = field(default_factory=dict)
    _shapes: Dict[Any, set] = field(default_factory=dict)
    _flops: Dict[Any, float] = field(default_factory=dict)
    _meta_params: Any = None
    recompiles: int = 0

    def _raw_step(self, plan):
        opt_cfg = self.opt_cfg
        loss_fn = self.model.loss
        update = adamw_update if isinstance(opt_cfg, AdamWConfig) \
            else sgdm_update

        def step(params, opt_state, batch):
            _, metrics, grads = grads_of(loss_fn, params, batch, plan)
            params, opt_state = update(grads, opt_state, params, opt_cfg)
            return params, opt_state, metrics

        return step

    def get(self, plan, example_batch: dict = None) -> Callable:
        """The single step for `plan`. Passing the batch about to be
        trained keeps the recompile ledger shape-accurate."""
        if plan not in self._steps:
            self._steps[plan] = self._raw_step(plan)
            self._shapes[plan] = set()
            self.recompiles += 1
        if example_batch is not None:
            sig = batch_signature(example_batch)
            shapes = self._shapes[plan]
            if sig not in shapes:
                if shapes:  # first shape rides on the plan's compile
                    self.recompiles += 1
                shapes.add(sig)
        return self._steps[plan]

    def flops(self, plan, example_batch) -> float:
        """FLOPs of one train step's loss and gradient under `plan`, as
        `FlopCounterMode` counts them (matmuls only, forward and
        backward), on `meta` tensors of the params' and the batch's
        shapes: nothing is computed and no state moves. Cached per plan.
        XLA's count, which the reference takes, also counts elementwise
        work, so only the ratios between plans carry over (the cost
        model is calibrated on the first round's plan)."""
        if plan not in self._flops:
            if self._meta_params is None:  # the params' shapes, once
                self._meta_params = tree_map(
                    lambda t: torch.empty_like(t, device="meta"),
                    self.model.init(torch.Generator()))
            batch = {k: torch.empty(tuple(v.shape),
                                    dtype=torch.as_tensor(v[:0]).dtype,
                                    device="meta")
                     for k, v in example_batch.items()}
            counter = FlopCounterMode(display=False)
            with counter:
                grads_of(self.model.loss, self._meta_params, batch, plan)
            self._flops[plan] = float(counter.get_total_flops())
        return self._flops[plan]


def same_shape_runs(batches: Sequence[dict]):
    """Yield the maximal runs of consecutive same-signature batches."""
    i, n = 0, len(batches)
    while i < n:
        j = i + 1
        sig = batch_signature(batches[i])
        while j < n and batch_signature(batches[j]) == sig:
            j += 1
        yield batches[i:j]
        i = j


def make_optimizer_state(model, opt_cfg, params):
    if isinstance(opt_cfg, AdamWConfig):
        return adamw_init(params, opt_cfg)
    return sgdm_init(params, opt_cfg)


def as_tensor(batch: dict, device) -> dict:
    """Host batch dict -> tensors on `device` (shared by training and
    serving; the counterpart of `as_jnp`). Call it outside
    `torch.inference_mode()` for a batch that trains: a tensor made in
    inference mode cannot be saved for backward."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def evaluate(model, params, batch) -> Tuple[float, np.ndarray]:
    """Returns (accuracy, logits as host numpy) on a labeled batch of
    tensors on the model's device."""
    if model.predict is None:
        raise ValueError("model has no predict()")
    logits = model.predict(params, batch)
    acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
    return acc, logits.cpu().numpy()
