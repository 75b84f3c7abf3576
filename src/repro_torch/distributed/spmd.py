"""The sharded step's SPMD layer: what the reference gets from XLA's
partitioner, written out for a model that runs on each rank's local
shards.

The reference jits its LM step with the params placed by `param_specs`
and its activations hinted (`sharding.hint`), and XLA splits every op
over the mesh. The port's step (`launch/train.py`, `launch/dryrun.py`)
enters `step(mesh)`; inside it the model code runs on plain tensors that
are this rank's shards:

- a batch's rows are the rank's data shard (the batch specs' split);
- a param is taken for its use by `use`: its FSDP shards over the data
  axes gathered, its `model` placement kept. It is a DTensor
  redistribute, so its backward reduce-scatters the gradient back to the
  param's placement (an all-reduce where the param is replicated over
  the data axes), and a layer under remat gathers again in its recompute;
- where the rows are not split (`step(mesh, rows=False)`: a decode of
  one row, whose cache the data axes split by sequence) every rank holds
  the same activations, and the weights stay where they lie, as XLA's
  partitioner leaves them: `use` gathers nothing, and each product of a
  weight that FSDP may split (`matmul`; the token table's lookup,
  `columns`) runs on the rank's shard. Where FSDP split the product's
  contracted dim the rank takes its part of the input and the partial
  products are summed over the data axes; where it split the output dim
  the rank's columns are gathered over them. Only activations move;
- where a param is split over `model` (heads, the MLP's hidden dim, the
  vocabulary, experts, channels), the block computes its part of the
  layer and joins the parts with the collectives below, each an
  `autograd.Function` with its adjoint as backward. A dim the spec
  replicates on `model` is computed whole on every rank, as the
  reference replicates it.

Every rank of a `model` group holds the same activations: what enters a
split computation passes `to_model` (identity; its gradient all-reduced
over `model`), what leaves one passes `from_model` (all-reduced; its
gradient passed through). A rank's loss is its share of the global mean
(`data_sum` joins the shares), so the data axes' gradient is the sum that
`use`'s backward makes. Where the rows are not split the data axes join
a product's parts as `model` does, with the same three functions.

Outside `step` (no mesh, or the mesh of one rank where every spec
replicates) `current()` is None, every helper is the identity, and the
model runs the ops it runs on one card.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.distributed import sharding as sh

_GROUPS: dict = {}


@dataclass(frozen=True)
class Spmd:
    """A sharded step's groups: `model` (tp ranks, this one the `mr`-th)
    and the data axes flattened (pod-major, as the batch specs split
    rows). `nd` and `dr` are the number of data shards the batch's rows
    are split into and this rank's (1 and 0 where every rank holds the
    whole batch: a decode of one row, whose cache the data axes split by
    sequence). `wn` and `wr` are the number of data shards the weights
    stay split into and this rank's: the data axes' size and this rank's
    place on them where the rows are not split, else 1 and 0 (`use`
    gathers the FSDP shards). One of `nd` and `wn` is 1."""

    model_group: object
    tp: int
    mr: int
    data_group: object
    nd: int
    dr: int
    wn: int
    wr: int


def _data_group(mesh):
    """The process group over the mesh's data axes, pod-major."""
    axes = sh.data_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():   # the dry run's mesh, its ranks real
            _GROUPS[key] = (mesh, mesh[axes]._flatten().get_group())
    return _GROUPS[key][1]


def context(mesh, rows: bool = True) -> Spmd:
    """This rank's `Spmd` on `mesh`."""
    sizes = sh.axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    dr, nd = 0, 1
    for a in sh.data_axes(mesh):
        dr, nd = dr * sizes[a] + coord[a], nd * sizes[a]
    tp = sizes.get("model", 1)
    return Spmd(model_group=mesh.get_group("model") if tp > 1 else None,
                tp=tp, mr=coord.get("model", 0),
                data_group=_data_group(mesh) if nd > 1 else None,
                nd=nd if rows else 1, dr=dr if rows else 0,
                wn=1 if rows else nd, wr=0 if rows else dr)


@contextmanager
def step(mesh, rows: bool = True):
    """The sharded step on `mesh`: `activation_sharding(mesh)` and the
    model on local shards; `rows` where the batch's rows are split over
    the data axes (else every rank holds the whole batch). A mesh of one
    rank runs as no mesh."""
    global _CTX
    ctx = context(mesh, rows) if mesh is not None and mesh.size() > 1 \
        else None
    old, _CTX = _CTX, ctx
    try:
        with sh.activation_sharding(mesh):
            yield ctx
    finally:
        _CTX = old


# the step's context is the process's, not a thread's: autograd runs a
# CUDA backward, and under remat the forward it recomputes, on a device
# thread of its own, whose collectives must be the step's too
_CTX: Optional[Spmd] = None


def current() -> Optional[Spmd]:
    return _CTX


def tp() -> int:
    ctx = current()
    return ctx.tp if ctx is not None else 1


def nd() -> int:
    ctx = current()
    return ctx.nd if ctx is not None else 1


def _stationary() -> Optional[Spmd]:
    """The step's context where its weights stay split over the data axes
    (`Spmd.wn` > 1), else None."""
    ctx = current()
    return ctx if ctx is not None and ctx.wn > 1 else None


# ---------------------------------------------------------------------------
# params at their use


def use(p):
    """A param as the plain tensor a layer computes with: a DTensor's FSDP
    shards over the data axes gathered, its `model` placement kept (a
    DTensor redistribute, whose backward reduce-scatters the gradient
    back to the param's placement); a plain tensor as it is. The
    gradient's placement over the data axes is Partial: each rank's loss
    is its share of the global mean.

    Where the rows are not split (`Spmd.wn` > 1) nothing is gathered: the
    param is its local shard, an FSDP dim split over the data axes as it
    lies (the products take it so, `matmul`), and its gradient is placed
    as the param is (every rank's loss is the whole loss)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    data = set(sh.data_axes(mesh))
    if _stationary() is not None:
        split = {pl.dim if pl.is_shard() else None for name, size, pl in
                 zip(mesh.mesh_dim_names, mesh.shape, p.placements)
                 if name in data and size > 1}
        if len(split) > 1:
            # `matmul` takes a shard's place on the data axes flattened
            raise NotImplementedError(
                f"a param placed {p.placements} is split over some of the "
                f"data axes only; a step whose rows are not split keeps "
                f"the weights where they lie, over all of them or none")
        return p.to_local(grad_placements=p.placements)
    keep, grad = [], []
    for name, size, pl in zip(mesh.mesh_dim_names, mesh.shape, p.placements):
        if name in data:
            keep.append(Replicate())
            grad.append(Partial() if size > 1 else Replicate())
        else:
            keep.append(pl)
            grad.append(pl)
    if tuple(keep) != tuple(p.placements) or tuple(grad) != tuple(keep):
        # the redistribute's backward takes the gradient back to the
        # param's placement: Partial over the data axes reduce-scattered
        # (all-reduced where the param is replicated over them)
        p = p.redistribute(mesh, keep)
    return p.to_local(grad_placements=grad)


def use_tree(tree):
    from repro_torch import tree_map

    return tree_map(use, tree)


def split(local: torch.Tensor, dim: int, full: int) -> bool:
    """Whether `local`, a param at its use, holds a part of its dim `dim`
    (of global size `full`): the spec put that dim on `model`."""
    return local.shape[dim] != full


def part(full: int) -> tuple:
    """This rank's [lo, hi) of a dim of size `full` split over `model`."""
    ctx = current()
    n = full // ctx.tp
    return ctx.mr * n, (ctx.mr + 1) * n


# ---------------------------------------------------------------------------
# collectives (functional c10d ops, so the dry run's fake tensors and its
# counter see them)


def _c10d():
    return torch.ops._c10d_functional


def _wait(t):
    return _c10d().wait_tensor(t)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return _wait(_c10d().all_reduce(x.contiguous(), op, group.group_name))


def all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The group's `x`s joined along `dim`, in rank order."""
    moved = x.movedim(dim, 0).contiguous()
    out = _wait(_c10d().all_gather_into_tensor(moved, n, group.group_name))
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The sum of the group's `x`s, this rank's 1/n along `dim`."""
    moved = x.movedim(dim, 0).contiguous()
    out = _wait(_c10d().reduce_scatter_tensor(moved, "sum", n,
                                              group.group_name))
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    return x.chunk(n, dim=dim)[i].contiguous()


class _Enter(torch.autograd.Function):
    """Identity; the gradient all-reduced over `group`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Sum(torch.autograd.Function):
    """All-reduced over `group`; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Join(torch.autograd.Function):
    """The `n` ranks' parts joined along `dim`; the gradient's own part
    (the `i`-th) comes back."""

    @staticmethod
    def forward(ctx, x, group, n, i, dim):
        ctx.n, ctx.i, ctx.dim = n, i, dim
        return all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.n, ctx.i, ctx.dim), None, None, None, None


class _ScatterData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, dim):
        ctx.s, ctx.dim = s, dim
        return reduce_scatter(x, s.data_group, s.nd, dim)

    @staticmethod
    def backward(ctx, g):
        s = ctx.s
        return all_gather(g, s.data_group, s.nd, ctx.dim), None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, dim):
        ctx.s, ctx.dim = s, dim
        return all_gather(x, s.data_group, s.nd, dim)

    @staticmethod
    def backward(ctx, g):
        s = ctx.s
        return reduce_scatter(g, s.data_group, s.nd, ctx.dim), None, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """`x`, the same on every rank of `model`, entering a computation
    split over it: its gradient is all-reduced over `model`."""
    return _Enter.apply(x, current().model_group) if tp() > 1 else x


def from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over `model` of each rank's part (a row-parallel product,
    a vocabulary's partial sums); the gradient passes through."""
    return _Sum.apply(x, current().model_group) if tp() > 1 else x


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts of `x` joined along `dim`, for a computation that
    every rank of `model` then runs whole; the gradient's own part
    comes back."""
    if tp() == 1:
        return x
    ctx = current()
    return _Join.apply(x, ctx.model_group, ctx.tp, ctx.mr, dim)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data axes of each rank's share; the gradient
    passes through, so each rank's backward covers its own rows."""
    return _Sum.apply(x, current().data_group) if nd() > 1 else x


def scatter_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reduce-scatter over the data axes along `dim` (its adjoint, the
    all-gather, in the backward)."""
    return _ScatterData.apply(x, current(), dim) if nd() > 1 else x


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather over the data axes along `dim` (its adjoint, the
    reduce-scatter, in the backward)."""
    return _GatherData.apply(x, current(), dim) if nd() > 1 else x


def matmul(x: torch.Tensor, w: torch.Tensor, out: int = 0,
           model_sum: bool = False) -> torch.Tensor:
    """`x @ w` for `w` a weight at its use (`torch.bmm` for a stack of
    experts' weights [E, K, N]); `out` is the whole size of the product's
    last dim where FSDP may split the weight's output dim, and
    `model_sum` that the contracted dim is split over `model` (a
    row-parallel product, its parts summed over `model`, `from_model`).
    Where the rows are not split (`Spmd.wn` > 1) the weight is its shard
    as it lies: a contracted dim shorter than x's is FSDP's, so the rank
    takes its part of x's last dim and the partial products are summed
    over the data axes; an output dim shorter than `out` is FSDP's, so the
    rank's columns are gathered over them (after the sum over `model`,
    the smaller payload first). Elsewhere it is the product as it
    stands."""
    prod = torch.bmm if w.dim() == 3 else torch.matmul
    ctx = _stationary()
    k = w.shape[-2]
    if ctx is not None and k != x.shape[-1]:
        x = _Enter.apply(x, ctx.data_group)[..., ctx.wr * k:(ctx.wr + 1) * k]
        y = _Sum.apply(prod(x, w), ctx.data_group)
    elif ctx is not None and out and w.shape[-1] != out:
        y = prod(_Enter.apply(x, ctx.data_group), w)
        return columns(from_model(y) if model_sum else y, out)
    else:
        y = prod(x, w)
    return from_model(y) if model_sum else y


def columns(y: torch.Tensor, full: int) -> torch.Tensor:
    """`y` with its last dim whole (of size `full`) where the rows are not
    split and it holds the rank's columns of a weight FSDP split there (a
    lookup of the token table's shard), the ranks' columns gathered over
    the data axes; else `y`."""
    ctx = _stationary()
    if ctx is None or y.shape[-1] == full:
        return y
    return _Join.apply(y, ctx.data_group, ctx.wn, ctx.wr, -1)


@torch.no_grad()
def model_max(x: torch.Tensor) -> torch.Tensor:
    """The max over `model`, outside autograd."""
    return all_reduce(x, current().model_group, "max") if tp() > 1 else x


@torch.no_grad()
def model_total(x: torch.Tensor) -> torch.Tensor:
    """A statistic summed over `model`, outside autograd."""
    return all_reduce(x, current().model_group) if tp() > 1 else x


@torch.no_grad()
def data_total(x: torch.Tensor) -> torch.Tensor:
    """A statistic summed over the data axes, outside autograd."""
    return all_reduce(x, current().data_group) if nd() > 1 else x


# ---------------------------------------------------------------------------
# sharded state


def local(tree):
    """(`tree` with each DTensor leaf as its local shard, a function that
    turns a tree of such shards back into DTensors placed as these): a
    decode's caches, and a one-rank mesh's params and gradients."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree_leaves, tree_map, tree_unflatten

    leaves = tree_leaves(tree)
    placed = [t if isinstance(t, DTensor) else None for t in leaves]

    def back(new):
        # a shard of its like's local shape and type takes its like's
        # spec as it is: DTensor's constructor, not `from_local`'s
        # autograd function, which costs ~20x the host time a leaf
        out = []
        for t, like in zip(tree_leaves(new), placed, strict=True):
            if like is None:
                out.append(t)
            elif t.shape == like._local_tensor.shape and \
                    t.dtype == like.dtype and not t.requires_grad:
                out.append(DTensor(t, like._spec, requires_grad=False))
            else:
                out.append(DTensor.from_local(
                    t, like.device_mesh, like.placements, run_check=False,
                    shape=like.shape, stride=like.stride()))
        return tree_unflatten(new, out)

    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                    else t, tree), back


def offsets(t) -> tuple:
    """Where a DTensor's local shard starts in its global value, per dim
    (zeros for a plain tensor). The specs split evenly: a dim sharded
    over mesh dims i < j < ... is cut in their row-major order."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return (0,) * t.dim()
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    index = [0] * t.dim()
    parts = [1] * t.dim()
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            index[pl.dim] = index[pl.dim] * mesh.shape[i] + coord[i]
            parts[pl.dim] *= mesh.shape[i]
    return tuple(index[d] * (t.shape[d] // parts[d]) for d in range(t.dim()))
