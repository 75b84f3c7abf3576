"""Elastic scaling, ported from `repro.distributed.elastic`: re-shard a
live tree (params and optimizer state) onto another mesh — grow after a
repair, shrink after an eviction — with every value kept. With the
checkpoint manager this is the recovery path: `restore_latest` onto the
new mesh (`elastic_restore`), then resume.

Meshes are `torch.distributed` DeviceMeshes; a leaf is a DTensor or a
plain tensor holding the whole value on every rank. Every rank of the
old mesh takes part in `remesh` (a DTensor's whole value is gathered
over it) and every rank of the world in `shrink_mesh` (the new mesh's
process groups are made by all of them).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh


def whole(leaf):
    """A leaf's whole value as a plain tensor (a DTensor gathered)."""
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def remesh(tree, new_mesh, spec_tree):
    """Every leaf placed by its spec on `new_mesh` (values kept)."""
    return sh.place(sh.map_with_path(lambda _, leaf: whole(leaf), tree),
                    spec_tree, new_mesh)


def shrink_mesh(mesh, drop_axis: str = "data"):
    """A mesh of the first half of the ranks along `drop_axis` (the
    failure of a slice)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = mesh.mesh_dim_names
    size = sh.axis_sizes(mesh)[drop_axis]
    if size % 2:
        raise ValueError(f"cannot halve axis {drop_axis!r} of size {size}")
    idx = [slice(None)] * mesh.ndim
    idx[names.index(drop_axis)] = slice(0, size // 2)
    return DeviceMesh(mesh.device_type, mesh.mesh[tuple(idx)],
                      mesh_dim_names=names)


def elastic_restore(manager, like, cfg: ModelConfig, mesh,
                    policy: sh.ShardingPolicy = sh.ShardingPolicy()):
    """The latest valid checkpoint restored straight onto `mesh` (of any
    shape, e.g. after an eviction): (tree, step)."""
    specs = sh.param_specs(like, cfg, mesh, policy)
    return manager.restore_latest(like, shardings=sh.named(mesh, specs))
