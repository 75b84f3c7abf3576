"""Sharding rules for the production meshes, ported from
`repro.distributed.sharding` onto `torch.distributed`.

Meshes (launch/mesh.py): single-pod ``(data=16, model=16)`` = 256 ranks,
multi-pod ``(pod=2, data=16, model=16)`` = 512 ranks. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` whose dim names are the
reference's axis names.

A placement is written as the reference writes it, a `PartitionSpec`:
per tensor dim an axis name, a tuple of names or None. `placements(mesh,
spec)` turns one into DTensor placements (`Shard(d)` on each mesh dim a
tensor dim takes, `Replicate()` elsewhere), and `named(mesh, specs)`
pairs each spec with its mesh as a `NamedSharding`, which places a tensor
(`NamedSharding.place`).

Param placement is name-based with **divisibility fallback chains** — the
`model` axis is 16 but gemma2-2b has 8 query heads and granite-20b a
single KV head, so no fixed "heads on model" rule holds for the ten
archs. Each tensor kind declares an ordered list of (dim, axes)
candidates; the first whose dimension divides the axes' size wins, else
the tensor is replicated on them.

The port keeps an LM's blocks as a list of per-layer dicts where the
reference stacks a group's layers along a leading [G] dim: a block
leaf's spec here is the reference's without that dim, and a cache
leaf's likewise. FSDP ("zero3") optionally shards the d_model/reduction
dim of every large param over the data axes (and the pod axis).

`hint` is the reference's activation-layout assertion: under
`activation_sharding(mesh)` it redistributes a DTensor activation to its
spec; a plain tensor passes through untouched, and so does everything
outside `activation_sharding`. The sharded LM step (`distributed/
spmd.py`) enters `activation_sharding` and runs the model on each rank's
local shards, plain tensors already laid out as the hints name (batch
over the data axes; heads, hidden dims, vocabulary and experts over
`model` where the params' specs split them), so there they pass through.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.checkpoint.ckpt import _flatten_with_names
from repro_torch.configs.base import ModelConfig, ShapeConfig


class PartitionSpec:
    """Per tensor dim: an axis name, a tuple of axis names or None (the
    reference's `jax.sharding.PartitionSpec`; a one-name tuple is stored
    as the name, as jax stores it). A leaf of the port's trees, not a
    tuple, so `tree_map` does not descend into it."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (the reference's `mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of `spec` on `mesh`: mesh dim i gets Shard(d)
    where tensor dim d names its axis, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for d, s in enumerate(spec):
        for a in ((s,) if isinstance(s, str) else tuple(s or ())):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def place(self, t: torch.Tensor):
        """`t`, the whole value on every rank, as a DTensor on the mesh's
        device: each rank keeps its own shard, with no communication."""
        from torch.distributed.tensor import distribute_tensor

        t = t.to(self.mesh.device_type)
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


# ---------------------------------------------------------------------------
# activation sharding hints (MaxText-style logical-axis constraints)

_ACTIVATION_MESH = threading.local()

BATCH_AXES = ("pod", "data")


@contextmanager
def activation_sharding(mesh):
    old = getattr(_ACTIVATION_MESH, "mesh", None)
    _ACTIVATION_MESH.mesh = mesh
    try:
        yield
    finally:
        _ACTIVATION_MESH.mesh = old


def _current_mesh():
    return getattr(_ACTIVATION_MESH, "mesh", None)


def hint(x, *spec):
    """A DTensor `x` redistributed to P(*spec) on the activation mesh,
    dropping axes that are absent or do not divide the dim; `x` itself
    where it is a plain tensor or no activation mesh is set."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    clean = []
    for dim in range(x.ndim):
        s = spec[dim] if dim < len(spec) else None
        axes = (s,) if isinstance(s, str) else tuple(s or ())
        axes = tuple(a for a in axes if a in sizes)
        size = 1
        for a in axes:
            size *= sizes[a]
        if axes and size > 1 and x.shape[dim] % size == 0:
            clean.append(axes)
        else:
            clean.append(None)
    return x.redistribute(mesh, placements(mesh, P(*clean)))


@dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True               # shard params over data axes (ZeRO-3)
    fsdp_pod: bool = True           # include the pod axis in FSDP
    shard_embed_vocab: bool = True  # vocab dim of embeddings on `model`
    seq_shard_long: bool = True     # shard seq dim when batch < data axis


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def fsdp_axes(mesh, policy: ShardingPolicy) -> Tuple[str, ...]:
    if not policy.fsdp:
        return ()
    axes = ["data"] if "data" in mesh.mesh_dim_names else []
    if policy.fsdp_pod and "pod" in mesh.mesh_dim_names:
        axes = ["pod"] + axes
    return tuple(axes)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    size = _axis_size(mesh, axes)
    return size > 1 and dim % size == 0


def _pick(mesh, shape, candidates) -> PartitionSpec:
    """candidates: ordered [(dim_index, axes)] claims; claims compose as
    long as dims differ and each divides."""
    spec = [None] * len(shape)
    used = set()
    for dim, axes in candidates:
        if axes is None or dim >= len(shape) or spec[dim] is not None:
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a in used for a in ax_tuple):
            continue
        if all(a in mesh.mesh_dim_names for a in ax_tuple) \
                and _fits(shape[dim], mesh, ax_tuple):
            spec[dim] = axes
            used.update(ax_tuple)
    return P(*spec)


def map_with_path(fn, tree, *rest, path=()):
    """`fn(names, leaf, *matching leaves of rest)` over a tree's leaves,
    `names` the leaf's path as the checkpoint names it (dict keys, list
    indices, ".field" of a NamedTuple); the result keeps `tree`'s
    structure, NamedTuples included, and None stays None. Dicts pair by
    key."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(
            fn, getattr(tree, f), *(getattr(r, f) for r in rest),
            path=path + ("." + f,)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(path), tree, *rest)


def place(tree, spec_tree, mesh):
    """Every leaf of `tree` (its whole value on every rank) as a DTensor
    by its spec on `mesh`."""
    return map_with_path(lambda _, t, s: s.place(t), tree,
                         named(mesh, spec_tree))


# ---------------------------------------------------------------------------
# parameter specs


def _param_candidates(names, leaf, cfg: ModelConfig, fa) -> list:
    """The reference's candidates of one leaf, on the port's unstacked
    block leaves."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    nd = leaf.ndim
    hd = cfg.shard_head_dim
    if "embed" in names and name == "tok":
        return [(0, "model"), (1, fa)] if fa else [(0, "model")]
    if "embed" in names and name == "head":
        return [(1, "model"), (0, fa)]
    if "embed" in names and name == "frontend_proj":
        return [(1, "model")]
    if name in ("wq", "wk", "wv"):
        # GQA fallback chain: heads -> (optional head_dim) -> replicate
        return [(1, "model"), (0, fa)] + ([(2, "model")] if hd else [])
    if name == "wo" and parent == "mix" and nd == 3:
        return [(0, "model"), (2, fa)] + ([(1, "model")] if hd else [])
    if name in ("bq", "bk", "bv"):
        return [(0, "model")] + ([(1, "model")] if hd else [])
    if name in ("wg", "wu") and nd == 3:                 # moe [E, D, F]
        return [(0, "model"), (1, fa)]
    if name == "wd" and nd == 3:                         # moe [E, F, D]
        return [(0, "model"), (2, fa)]
    if name in ("wg", "wu"):                             # mlp [D, F]
        return [(1, "model"), (0, fa)]
    if name == "wd":                                     # mlp [F, D]
        return [(0, "model"), (1, fa)]
    if name == "router":
        return [(1, "model")]
    if name == "in_proj":                                # mamba [D, 2di]
        return [(1, "model"), (0, fa)]
    if name == "out_proj":                               # mamba [di, D]
        return [(0, "model"), (1, fa)]
    if name == "x_proj":                                 # [di, R+2N]
        return [(0, "model")]
    if name == "dt_proj":                                # [R, di]
        return [(1, "model")]
    if name in ("A_log", "D_skip", "dt_bias"):
        return [(0, "model")]
    if name == "conv_w":                                 # [w, di]
        return [(1, "model")]
    if name == "conv_b":
        return [(0, "model")]
    if parent == "mix" and name in ("wr", "wk", "wv", "wg"):  # rwkv [D, D]
        return [(1, "model"), (0, fa)]
    if parent == "mix" and name == "wo":
        return [(0, "model"), (1, fa)]
    if parent == "ffn" and name == "wr":
        return [(1, "model")]
    if name == "wA":
        return [(0, fa)]
    if name == "wB":
        return [(1, "model")]
    if name == "u":
        return [(0, "model")]
    return []  # norms, biases, mu, small tensors: replicated


def param_specs(params, cfg: ModelConfig, mesh,
                policy: ShardingPolicy = ShardingPolicy()):
    """Tree of PartitionSpec matching `params` (LM models; the paper's
    CV/NLP models run on one device and take replicated specs)."""
    fa = fsdp_axes(mesh, policy)
    return map_with_path(lambda names, leaf: _pick(
        mesh, leaf.shape, _param_candidates(names, leaf, cfg, fa)), params)


# ---------------------------------------------------------------------------
# batch / cache / optimizer specs


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                policy: ShardingPolicy = ShardingPolicy()):
    da = data_axes(mesh)
    n = _axis_size(mesh, da)
    batch_ax = da if n > 1 and shape.global_batch % n == 0 else None
    specs = {"tokens": P(batch_ax, None), "targets": P(batch_ax, None)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = P(batch_ax, None, None)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, cache,
                policy: ShardingPolicy = ShardingPolicy()):
    """Specs for the port's per-layer KV/state caches. Falls back to
    sequence-dim sharding when the batch does not divide the data axes
    (long_500k: batch 1, a 524288-long cache)."""
    da = data_axes(mesh)
    dsize = _axis_size(mesh, da)
    batch_ok = dsize > 1 and shape.global_batch % dsize == 0
    bax = da if batch_ok else None

    def spec_for(names, leaf):
        name = names[-1]
        if name in ("k", "v"):   # [B, L, Hkv, hd]
            c = [(0, bax)]
            if not batch_ok and policy.seq_shard_long:
                c.append((1, da))
            return _pick(mesh, leaf.shape, c + [(2, "model"), (3, "model")])
        if name == "h":          # mamba [B, di, N]
            return _pick(mesh, leaf.shape, [(0, bax), (1, "model")])
        if name == "conv":       # [B, w-1, di]
            return _pick(mesh, leaf.shape, [(0, bax), (2, "model")])
        if name == "s":          # rwkv [B, H, n, n]
            return _pick(mesh, leaf.shape, [(0, bax), (1, "model")])
        if name in ("x_tm", "x_cm"):  # [B, D]
            return _pick(mesh, leaf.shape, [(0, bax)])
        return P()

    return map_with_path(spec_for, cache)


def named(mesh, spec_tree):
    """Each spec of `spec_tree` on `mesh`, as a `NamedSharding`."""
    return map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


def opt_state_specs(param_spec_tree, opt_state, params):
    """Optimizer moments take the spec of the first param (in JAX's
    flattening order) of their shape and dtype, else of their shape;
    scalars replicate — the reference's rule."""
    flat_p = [leaf for _, leaf in _flatten_with_names(params)]
    flat_s = [s for _, s in _flatten_with_names(param_spec_tree)]
    by_shape, by_shape_any = {}, {}
    for p, s in zip(flat_p, flat_s):
        by_shape.setdefault((tuple(p.shape), p.dtype), s)
        by_shape_any[tuple(p.shape)] = s

    def spec_for(leaf):
        if leaf.ndim == 0:
            return P()
        s = by_shape.get((tuple(leaf.shape), leaf.dtype))
        return by_shape_any.get(tuple(leaf.shape), P()) if s is None else s

    return map_with_path(lambda _, leaf: spec_for(leaf), opt_state)
