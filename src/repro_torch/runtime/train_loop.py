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

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

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


def _taps_in_bounds(size: int, low: int, k: int, stride: int, out: int):
    """Window taps of a strided 1-D window over `out` outputs that land
    in an input of `size` padded by `low` in front."""
    return sum(max(0, min(k, size + low - o * stride)
                   - max(0, low - o * stride)) for o in range(out))


def _in_bounds_conv_formulas():
    """FlopCounterMode formulas that count a convolution's window taps
    as XLA's cost analysis does: only those that land in the input, not
    in the "SAME" padding that `F.pad` put around it (the CNNs pad apart
    from the convolution, models/cnn.py). Torch's own formulas count
    every tap; on the deep units' small maps (a 3x3 window over 2x2 has
    16 of its 36 taps in bounds) that overcounts them, and the count's
    ratios between freeze plans drift from the reference's. Torch's
    formulas are kept otherwise, and scaled by the in-bounds share."""
    aten = torch.ops.aten
    padded = {}  # id of a padded map -> (its weakref, H, top, W, left)

    def pad(x, widths, *args, out_val=None, **kwargs):
        if x.dim() == 4 and len(widths) == 4:  # (left, right, top, bottom)
            padded[id(out_val)] = (weakref.ref(out_val), x.shape[2],
                                   widths[2], x.shape[3], widths[0])
        return 0

    def share(x, w, stride, out_hw):
        entry = padded.get(id(x))
        if entry is None or entry[0]() is not x:
            return 1.0
        _, h, top, wd, left = entry
        kh, kw = w.shape[2:]
        return (_taps_in_bounds(h, top, kh, stride[0], out_hw[0])
                * _taps_in_bounds(wd, left, kw, stride[1], out_hw[1])
                / (kh * kw * out_hw[0] * out_hw[1]))

    def conv(x, w, bias, stride, *args, out_val=None, **kwargs):
        full = flop_registry[aten.convolution](x, w, bias, stride, *args,
                                               out_val=out_val, **kwargs)
        return round(full * share(x, w, stride, out_val.shape[2:]))

    def conv_backward(grad_out, x, w, bias_sizes, stride, *args,
                      out_val=None, **kwargs):
        full = flop_registry[aten.convolution_backward](
            grad_out, x, w, bias_sizes, stride, *args, out_val=out_val,
            **kwargs)
        return round(full * share(x, w, stride, grad_out.shape[2:]))

    for f in (pad, conv, conv_backward):
        f._get_raw = True
    return {aten.constant_pad_nd: pad, aten.convolution: conv,
            aten.convolution_backward: conv_backward}


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
        `FlopCounterMode` counts them (matmuls and convolutions only,
        forward and backward; a convolution's taps in its input, as XLA
        counts them), on `meta` tensors of the params' and the batch's
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
            counter = FlopCounterMode(
                display=False, custom_mapping=_in_bounds_conv_formulas())
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
