"""Train steps of the port (counterpart of `repro.runtime.train_loop`):
one eager, freeze-plan-aware step per plan, with the same recompile
ledger as the reference's jitted cache, FLOPs per plan for the cost
model, and the host-batch and evaluation helpers serving shares.

A step takes the gradient of the model's `loss` on fresh leaves made
from the params (the stored params never require grad), turns the
`None` autograd gives a leaf the plan froze into a zero gradient, as
`jax.grad` gives zeros behind `stop_gradient`, and applies the
optimizer to every leaf, out of place.

Compiled hot path (DESIGN.md §12; the reference's `multi_step`,
`fused_call`, `compiled_model`): `fused_call` runs a same-shape run of
batches as one call of a masked loop of `bucket` steps, the run padded up
to a power-of-two bucket with a per-step validity mask
(``torch.where(valid[i], new, old)`` on every leaf, Adam's step count
included, so a padding step leaves the carry bitwise unchanged). On the
CPU that loop runs eagerly. On a CUDA device it is one CUDA graph of
`bucket` steps (`CapturedCall`): a replay launches exactly the kernels
the eager steps launch, in the same order, so fused, per-batch and eager
training agree to the bit, which is what XLA's scan gives the reference.
`compiled_model` replays a model's `predict` and `features` from a graph
per batch signature. There is no fallback: a capture or replay that fails
on the card raises.

A graph reads its inputs from static buffers and writes its outputs to
memory the next replay overwrites, while the runtime keeps params in
several holders between rounds (serving lanes, SimFreeze's reference,
the pretrained reference params). So every call copies its inputs into
the graph's buffers and hands out fresh copies of its outputs: no tensor
a caller holds is ever written by a replay.

The reference's steps and forwards are jitted, so Python state a jitted
function reads (RigL's masks) is frozen at its trace, once per cache
entry. Each cache here runs its calls inside its entry (`program`): the
eager step per (plan, batch signature), the fused loop per bucket too, a
compiled forward per batch signature, whether called alone or inside a
stacked serving call (`forward_program`), so a function that reads such
state can keep what it first read per entry (`current_program`), on the
CPU as in a captured graph.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               sgdm_init, sgdm_update)
from repro_torch.runtime.flops import FlopCount, count_flops


# Process-global registries, keyed as the reference's: sessions over the
# same model (the same loss and forward functions) share every captured
# graph instead of capturing their own. Keys hold the functions
# themselves (not id()), so a live entry never collides with a recycled id.
_MULTI: Dict[Tuple, Callable] = {}
_MULTI_BUCKETS: Dict[Tuple, set] = {}
_COMPILED_MODELS: Dict[Any, Any] = {}
# a plan's step FLOPs, counted once a process per (loss, init, optimizer,
# plan, batch signature), as the reference's `_FLOPS` compiles once
_FLOPS: Dict[Tuple, FlopCount] = {}
# one CUDA-graph memory pool per device, shared by every graph: replays
# run one at a time on one stream, and each call copies its outputs out
# before any other graph replays, so one graph's scratch may reuse
# another's
_POOLS: Dict[Any, Any] = {}
_PROGRAM: contextvars.ContextVar = contextvars.ContextVar("program",
                                                         default=None)


@contextlib.contextmanager
def program(key):
    """Run the block inside the cache entry `key` (module docstring). A
    call already inside an entry stays in it: the reference traces a
    nested jitted call into its caller."""
    token = _PROGRAM.set(key) if _PROGRAM.get() is None else None
    try:
        yield
    finally:
        if token is not None:
            _PROGRAM.reset(token)


def current_program():
    """The key of the cache entry the current call runs in; None for a
    call the reference dispatches eagerly."""
    return _PROGRAM.get()


def forward_program(fn: Callable, batch: dict):
    """The entry a compiled forward `fn(params, batch)` runs in: the
    reference's jitted forward traces once per batch signature, called
    alone or inside a stacked serving call (a jitted function under
    `vmap` traces at its unbatched shapes, sharing the entry)."""
    return program(("forward", fn, batch_signature(batch)))


def batch_signature(batch: dict) -> Tuple:
    """Hashable (shape, dtype) signature of a host/device batch dict —
    the key the recompile ledger counts shapes by."""
    return tuple(sorted(
        (k, tuple(getattr(v, "shape", ())), str(getattr(v, "dtype", "")))
        for k, v in batch.items()))


def _bucket(n: int) -> int:
    """Next power of two >= n (scan-length / group-size padding bucket)."""
    return 1 << max(n - 1, 0).bit_length()


def _flatten(tree, leaves: list):
    """Append `tree`'s leaves to `leaves`; return its structure (dicts,
    lists, tuples and NamedTuples kept) for `_unflatten`."""
    if isinstance(tree, dict):
        return dict, [(k, _flatten(v, leaves)) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return type(tree), [_flatten(v, leaves) for v in tree]
    leaves.append(tree)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, children = spec
    if kind is dict:
        return {k: _unflatten(c, it) for k, c in children}
    vals = [_unflatten(c, it) for c in children]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def _copy(dst: list, src: list) -> None:
    """dst[i].copy_(src[i]) for every i, without blocking the host: one
    multi-tensor copy per (device, dtype) group of sources, the form that
    takes a few launches instead of one a tensor."""
    groups: Dict[Tuple, list] = {}
    for d, s in zip(dst, src, strict=True):
        groups.setdefault((s.device, s.dtype), []).append((d, s))
    for pairs in groups.values():
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs],
                             non_blocking=True)


def _fresh(leaves: list) -> list:
    """New tensors holding `leaves`' values."""
    out = [torch.empty_like(t) for t in leaves]
    _copy(out, leaves)
    return out


class CapturedCall:
    """`fn(tree)` on a CUDA device, replayed from one CUDA graph.

    The first call copies its input leaves into static buffers, runs `fn`
    once on a side stream (autograd, cuBLAS and the kernel libraries set
    themselves up there, as capture requires) and captures it into a
    graph in the device's shared pool. Every call then copies its inputs
    into the static buffers (device tensors, or pinned host tensors
    copied without blocking), replays the graph and returns fresh copies
    of its outputs, in `fn`'s structure. Inputs must keep the shapes,
    dtypes and structure of the first call. `replays` counts replays
    (the kernels inside a graph launch on the card without passing their
    host-side wrappers again)."""

    def __init__(self, fn: Callable, device: torch.device):
        self.fn = fn
        self.device = device
        self.graph = None
        self.replays = 0
        self._inputs: list = []
        self._outputs: list = []
        self._out_spec = None

    def __call__(self, tree):
        leaves: list = []
        spec = _flatten(tree, leaves)
        if self.graph is None:
            self._capture(spec, leaves)
        else:
            _copy(self._inputs, leaves)
        self.graph.replay()
        self.replays += 1
        return _unflatten(self._out_spec, iter(_fresh(self._outputs)))

    def _capture(self, spec, leaves: list) -> None:
        with torch.inference_mode(False):
            self._inputs = [torch.empty_like(t, device=self.device)
                            for t in leaves]
        _copy(self._inputs, leaves)
        static = _unflatten(spec, iter(self._inputs))
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.fn(static)
        stream.wait_stream(side)
        pool = _POOLS.get(self.device)
        if pool is None:
            pool = _POOLS[self.device] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = self.fn(static)
        self._outputs = []
        self._out_spec = _flatten(out, self._outputs)
        self.graph = graph


def on_card(device: torch.device) -> bool:
    """Whether calls on `device` replay from CUDA graphs (else they run
    eagerly, as on the CPU)."""
    return device.type == "cuda"


def pinned(batch: dict) -> dict:
    """A host batch as pinned CPU tensors (copied to the card without
    blocking the host)."""
    return {k: torch.as_tensor(v).pin_memory() for k, v in batch.items()}


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
    rides on the plan's own compile). The count is what the cost model
    charges; it is kept the same whether the steps run eagerly or as the
    fused steps' CUDA graphs (`multi_step`), which are captured per
    (plan, batch shape, bucket) and counted nowhere."""
    model: Any
    opt_cfg: Any
    _steps: Dict[Any, Callable] = field(default_factory=dict)
    _shapes: Dict[Any, set] = field(default_factory=dict)
    flop_counts: Dict[Any, FlopCount] = field(default_factory=dict)
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

    def _eager_step(self, plan):
        """The single step, run inside its (plan, batch signature) entry:
        the reference's jitted step traces once per batch shape."""
        raw = self._raw_step(plan)
        base = ("step", self.model.loss, self.opt_cfg, plan)

        def step(params, opt_state, batch):
            with program(base + (batch_signature(batch),)):
                return raw(params, opt_state, batch)

        return step

    def get(self, plan, example_batch: dict = None) -> Callable:
        """The single step for `plan`. Passing the batch about to be
        trained keeps the recompile ledger shape-accurate."""
        if plan not in self._steps:
            self._steps[plan] = self._eager_step(plan)
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

    # ---- fused multi-batch step (compiled hot path) ----------------------
    def multi_step(self, plan, example_batch: dict,
                   length: int) -> Tuple[Callable, int]:
        """The masked loop over a run of `length` same-shape batches;
        returns (fn, bucket) where fn(params, opt_state, batches, valid)
        takes `bucket` host batches and a [bucket] bool mask. Padding
        steps leave the carry bitwise untouched, which also lets a short
        run ride an already-captured *larger* bucket instead of capturing
        its own. Reuse is capped at 2x the run's natural bucket so padding
        never more than doubles the device work. The reference's contract,
        registries and keys, without its `donate` flag."""
        base = (self.model.loss, self.opt_cfg, plan,
                batch_signature(example_batch))
        need = _bucket(length)
        captured = _MULTI_BUCKETS.setdefault(base, set())
        fits = [b for b in captured if need <= b <= 2 * need]
        bucket = min(fits) if fits else need
        captured.add(bucket)
        key = base + (bucket,)
        fn = _MULTI.get(key)
        if fn is None:
            fn = _MULTI[key] = _MultiStep(self._raw_step(plan),
                                          self.model.device, key)
        return fn, bucket

    def fused_call(self, plan, params, opt_state, batches: Sequence[dict]):
        """Train a same-shape run of host batches in one call (one graph
        replay on a CUDA device). The single-batch case is the same masked
        loop at bucket 1, so per-batch and fused execution agree to the
        bit; the returned params and state are fresh tensors."""
        self.get(plan, batches[0])  # recompile-ledger bookkeeping
        fn, bucket = self.multi_step(plan, batches[0], len(batches))
        padded = list(batches) + [batches[0]] * (bucket - len(batches))
        valid = np.arange(bucket) < len(batches)
        return fn(params, opt_state, padded, valid)

    def flops(self, plan, example_batch) -> float:
        """FLOPs of one whole train step under `plan`: the loss, its
        gradient and the optimizer's update, counted as XLA's cost
        analysis counts the reference's step (`runtime/flops.py`), on
        `meta` tensors of the params', the optimizer state's and the
        batch's shapes: nothing is computed and no state moves. Counted
        once a process per model, optimizer, plan and batch signature;
        `flop_counts[plan]` keeps the split."""
        if plan not in self.flop_counts:
            key = (self.model.loss, self.model.init, self.opt_cfg, plan,
                   batch_signature(example_batch))
            if key not in _FLOPS:
                if self._meta_params is None:  # the params' shapes, once
                    self._meta_params = tree_map(
                        lambda t: torch.empty_like(t, device="meta"),
                        self.model.init(torch.Generator()))
                batch = {k: torch.empty(tuple(v.shape),
                                        dtype=torch.as_tensor(v[:0]).dtype,
                                        device="meta")
                         for k, v in example_batch.items()}
                params = self._meta_params
                opt_state = make_optimizer_state(self.model, self.opt_cfg,
                                                 params)
                _FLOPS[key] = count_flops(self._raw_step(plan), params,
                                          opt_state, batch)
            self.flop_counts[plan] = _FLOPS[key]
        return float(self.flop_counts[plan].total)


class _MultiStep:
    """`bucket` train steps as one masked loop: step i's outputs replace
    the carry where ``valid[i]``, leaf by leaf (``torch.where``), so a
    padding step keeps every bit of the params and the optimizer state.
    On a CUDA device the loop is one `CapturedCall`; on the CPU it runs
    eagerly. Every call runs inside the entry `key`."""

    def __init__(self, raw_step: Callable, device: torch.device, key):
        self.raw_step = raw_step
        self.key = ("multi",) + key
        self.graph = CapturedCall(self._loop, device) \
            if on_card(device) else None

    def _loop(self, args):
        params, opt_state, batches, valid = args
        metrics = []
        for i, batch in enumerate(batches):
            p2, o2, m = self.raw_step(params, opt_state, batch)
            keep = valid[i]
            params = tree_map(lambda new, old: torch.where(keep, new, old),
                              p2, params)
            opt_state = type(opt_state)(*(
                tree_map(lambda new, old: torch.where(keep, new, old), a, b)
                for a, b in zip(o2, opt_state)))
            metrics.append(m)
        return params, opt_state, tree_map(lambda *ms: torch.stack(ms),
                                           *metrics)

    def __call__(self, params, opt_state, batches, valid):
        with program(self.key):
            if self.graph is None:
                device = tree_leaves(params)[0].device
                return self._loop((params, opt_state,
                                   [as_tensor(b, device) for b in batches],
                                   torch.as_tensor(valid)))
            return self.graph((params, opt_state,
                               [pinned(b) for b in batches],
                               torch.as_tensor(valid).pin_memory()))


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


class GraphedForward:
    """A model's `predict` or `features` replayed from a CUDA graph per
    batch signature: the params and the batch are
    copied into the graph's static buffers before each replay, and the
    outputs come back as fresh tensors. `eager` is the function itself;
    it runs as it is on the CPU, when the call needs a gradient (SimSiam
    differentiates `features`), and inside another capture, which then
    records its kernels."""

    def __init__(self, eager: Callable):
        self.eager = eager
        self.graphs: Dict[Tuple, CapturedCall] = {}

    def __call__(self, params, batch):
        with forward_program(self.eager, batch):
            return self._call(params, batch, batch_signature(batch))

    def _call(self, params, batch, key):
        leaves = tree_leaves(params)
        device = leaves[0].device
        if not on_card(device) or torch.cuda.is_current_stream_capturing() \
                or (torch.is_grad_enabled()
                    and any(p.requires_grad for p in leaves)):
            return self.eager(params, batch)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = CapturedCall(
                lambda args: self.eager(*args), device)
        return graph((params, batch))


def compiled_model(model):
    """The model whose `predict` and `features` replay from CUDA graphs
    (`GraphedForward`), the compiled hot path's serving and probe side.
    `loss` stays as it is: it only runs inside train steps. Memoized on
    the (features, predict) functions, so repeated wraps of one model
    share its graphs process-wide."""
    key = (model.features, model.predict)
    wrapped = _COMPILED_MODELS.get(key)
    if wrapped is None:
        kw = {"features": GraphedForward(model.features)}
        if model.predict is not None:
            kw["predict"] = GraphedForward(model.predict)
        wrapped = _COMPILED_MODELS[key] = dataclasses.replace(model, **kw)
    return wrapped


def evaluate(model, params, batch) -> Tuple[float, np.ndarray]:
    """Returns (accuracy, logits as host numpy) on a labeled batch of
    tensors on the model's device."""
    if model.predict is None:
        raise ValueError("model has no predict()")
    logits = model.predict(params, batch)
    acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
    return acc, logits.cpu().numpy()
