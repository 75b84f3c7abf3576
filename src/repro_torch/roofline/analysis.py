"""Roofline terms of a dry-run step on the H100, ported from
`repro.roofline.analysis`.

compute term    = FLOPs per rank / 989 TFLOP/s (dense bf16)
memory term     = bytes per rank / 3.35 TB/s (HBM3)
collective term = collective bytes per rank / 50 GB/s (NDR InfiniBand)

(`roofline/h100.py` names the datasheet each comes from.) The reference
reads a compiled step: XLA's cost analysis for its FLOPs and bytes, its
memory analysis, and the collectives of its partitioned HLO. The port
compiles nothing. A dry-run step runs once, on fake tensors, under
`StepCostCounter`, which records per rank, from the ATen ops the step
dispatches:

- FLOPs, by `runtime/flops.py`'s rules (`StepFlopCounter`: XLA's
  `HloCostAnalysis` rules, without XLA's fusion recomputation, ROADMAP
  C.8);
- bytes: what each op reads and writes, its tensor inputs and outputs
  once each. This is unfused: a chain of elementwise ops that XLA or a
  CUDA kernel would fuse counts each intermediate written and read again.
  A view moves nothing, and a composite op counts its own inputs and
  outputs, not those of its decomposition;
- collectives: each c10d or functional collective's payload, the bytes
  of its result as the reference takes the HLO line's result shape,
  times the reference's ring factor (`_FACTORS`), with a count by kind. A
  functional collective's `wait_tensor` is the second half of its async
  pair and is not counted, as the reference skips `-done`;
- memory: the peak of the live storage the step made (fake, so nothing
  is allocated), above its arguments: the dry run's `temp`. Some of
  autograd's backward work runs in place on a plain tensor and out of
  place on a tensor subclass such as a fake tensor: the sum of two
  gradients of one tensor (where autograd holds the last reference to
  one), and the formulas that write a gradient into fresh zeros
  (gather's, index's, topk's, index_select's). There the counter does
  not count the op's new storage at the peak where the input it would
  write into dies with it (`_IN_PLACE`, `_in_place`). Without that,
  gather's gradient in gemma2-2b's loss counted one fp32 [tokens, vocab]
  copy too many at the backward's peak (2.10 GB at 4 x 512, 15% of what
  an H100 allocated for the loss and gradients under remat full).

A DTensor op is left to DTensor, which runs the rank's local op back
through the counter: every count is the rank's own, never the op's
global size (ROADMAP A.9.2). DTensor's sharding propagation also runs an
op once on global-shaped fake tensors, the first time it meets the op's
shapes, to learn its output's shape: those runs are not the step's, and
the counter runs them and counts none of them (it mutes itself inside
`ShardingPropagator._propagate_tensor_meta_non_cached`). Without that,
the first of two equal steps in a process would count more than the
second.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.h100 import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.runtime.flops import StepFlopCounter

# bytes-on-the-wire multiplier per collective kind (ring algorithms)
_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}

# the reference's kind of each c10d and functional collective. A send is
# a collective-permute's one move; its recv is the pair's other half.
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _dense(t: torch.Tensor) -> bool:
    """Whether `t` covers its memory exactly once (a contiguous tensor or
    a permutation of one), as autograd asks of a tensor it adds into."""
    expected = 1
    for stride, size in sorted((st, sz) for sz, st in zip(t.shape, t.stride())
                               if sz != 1):
        if stride != expected:
            return False
        expected *= size
    return True


_VIEWS: dict = {}

# the ops autograd's backward runs out of place on a tensor subclass and
# in place on a plain tensor, by the arguments it may write into: the sum
# of two gradients (`InputBuffer::accumulate`), and the formulas that
# write a gradient into fresh zeros (`FunctionsManual.cpp`)
_IN_PLACE = {torch.ops.aten.add.Tensor: (0, 1),
             torch.ops.aten.scatter_add.default: (0,),
             torch.ops.aten.scatter.src: (0,),
             torch.ops.aten.index_put.default: (0,),
             torch.ops.aten.index_add.default: (0,)}


def _is_view(func) -> bool:
    """Whether `func` returns a view of an input (it moves no bytes)."""
    view = _VIEWS.get(func)
    if view is None:
        view = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return view


@dataclass
class CollectiveStats:
    bytes_per_chip: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)

    def add(self, kind: str, payload: float) -> None:
        """One collective of `kind` whose result holds `payload` bytes."""
        b = payload * _FACTORS.get(kind, 1.0)
        self.bytes_per_chip += b
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + b


class StepCostCounter(StepFlopCounter):
    """Counts a step's FLOPs, bytes, collectives and peak memory per rank
    (module docstring). `arguments` are the step's inputs (DTensors or
    plain tensors): their storage is not the step's to count."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.bytes = 0
        self.collectives = CollectiveStats()
        self._args = set()
        for t in tree_leaves(arguments):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._args.add(StorageWeakRef(t.untyped_storage()).cdata)
        self._made = {}  # storage -> (its weak ref, its bytes)
        self.live = 0    # bytes of the made storages, freed ones among them
        self.peak = 0    # the largest live bytes at any allocation
        self._muted = 0  # inside sharding propagation's shape runs
        self._unpatch = None
        # an `_IN_PLACE` op's inputs and the live bytes it would peak at,
        # settled at the next op
        self._pending = None

    def __enter__(self):
        # a private method of DTensor's, checked against torch 2.11 and
        # 2.13; tests/test_torch_dryrun.py holds two equal steps' counts
        # equal, which fails if a release stops running the shape runs
        # through it
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        shape_run = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def muted(prop, op_schema):
            counter._muted += 1
            try:
                return shape_run(prop, op_schema)
            finally:
                counter._muted -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        self._unpatch = lambda: setattr(
            ShardingPropagator, "_propagate_tensor_meta_non_cached",
            shape_run)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._pending is not None:
            self._settle()
        if self._unpatch is not None:
            self._unpatch()
            self._unpatch = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if self._muted:
            return func(*args, **kwargs)
        if self._pending is not None:
            self._settle()
        namespace = func.namespace
        if namespace == "aten":
            out = self._dispatch(func, args, kwargs)
            if not _is_view(func):
                self.bytes += _tensor_bytes((args, kwargs)) + \
                    _tensor_bytes(out)
        else:
            out = func(*args, **kwargs)
            if namespace in _COLLECTIVE_NAMESPACES:
                name = func.overloadpacket.__name__
                if name in _KINDS:
                    payload = _tensor_bytes(out) or _tensor_bytes(args[0])
                    self.collectives.add(_KINDS[name], payload)
        self._track(out, self._in_place(func, args, out))
        return out

    def _in_place(self, func, args, out):
        """Where `func` is an `_IN_PLACE` op that autograd's backward
        runs: the weak refs of the step-made inputs that it would write
        into on a plain tensor (dense, the output's shape and dtype,
        storages of its size). Else None."""
        where = _IN_PLACE.get(func)
        if where is None or torch.is_grad_enabled() \
                or torch._C._current_autograd_node() is None \
                or not isinstance(out, torch.Tensor):
            return None
        if func is torch.ops.aten.scatter_add.default \
                and args[2].shape != args[3].shape:
            return None  # gather's gradient runs out of place here too
        n = out.untyped_storage().nbytes()
        refs = []
        for t in (args[i] for i in where):
            if not (isinstance(t, torch.Tensor) and t.shape == out.shape
                    and t.dtype == out.dtype
                    and _dense(t)):
                continue
            made = self._made.get(StorageWeakRef(t.untyped_storage()).cdata)
            if made is not None and made[1] == n:
                refs.append(made[0])
        return refs or None

    def _settle(self) -> None:
        """The pending `_IN_PLACE` op's peak counts unless one of its
        inputs died with it: on a plain tensor autograd wrote into that
        input in place and made nothing."""
        refs, live = self._pending
        self._pending = None
        if not any(ref.expired() for ref in refs):
            self.peak = max(self.peak, live)

    def _track(self, out, reuse=None) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            ref = StorageWeakRef(storage)
            key = ref.cdata
            if key in self._args:
                continue
            old = self._made.get(key)
            if old is not None:
                if not old[0].expired():
                    continue  # a view of a storage the step made
                self.live -= old[1]
            n = storage.nbytes()
            self._made[key] = (ref, n)
            self.live += n
            if self.live > self.peak:
                # `live` still holds storages freed since the last sweep:
                # only a sweep says whether this is a new peak
                self._sweep()
                if reuse:
                    self._pending = (reuse, self.live)
                else:
                    self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        for key, (ref, n) in list(self._made.items()):
            if ref.expired():
                self.live -= n
                del self._made[key]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    flops_ratio: float = 0.0            # MODEL_FLOPS / global counted flops
    collective_counts: Dict[str, int] = field(default_factory=dict)
    memory_per_chip: Dict[str, float] = field(default_factory=dict)

    def finalize(self, peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
                 link_bw=LINK_BW):
        self.compute_s = self.flops_per_chip / peak_flops
        self.memory_s = self.bytes_per_chip / hbm_bw
        self.collective_s = self.collective_bytes_per_chip / link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        global_flops = self.flops_per_chip * self.chips
        self.flops_ratio = self.model_flops / global_flops if global_flops \
            else 0.0
        return self

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """How close the step is to the compute roofline: ideal compute
        time / achievable time (dominant term)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops": self.model_flops, "compute_s": self.compute_s,
            "memory_s": self.memory_s, "collective_s": self.collective_s,
            "dominant": self.dominant, "flops_ratio": self.flops_ratio,
            "roofline_fraction": self.roofline_fraction(),
            "collective_counts": self.collective_counts,
            "memory_per_chip": self.memory_per_chip,
        }


def analyze(counter: StepCostCounter, *, arch: str, shape: str,
            mesh_name: str, chips: int, model_flops: float,
            memory: dict) -> RooflineReport:
    """The report of a step counted by `counter`; `memory` is its
    `memory_per_chip` (argument, output, temp, generated_code)."""
    stats = counter.collectives
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=float(counter.count.total),
        bytes_per_chip=float(counter.bytes),
        collective_bytes_per_chip=stats.bytes_per_chip,
        model_flops=model_flops, collective_counts=dict(stats.counts),
        memory_per_chip=dict(memory))
    return rep.finalize()


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active per token
    (decode), N = active params (MoE counts routed experts only)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
