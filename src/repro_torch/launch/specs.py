"""Abstract inputs of a dry-run cell, ported from `repro.launch.specs`:
every model input and state as a DTensor over a fake local shard, placed
by `distributed.sharding`'s specs on the given mesh. Nothing is
allocated: the tensors are `FakeTensorMode`'s, the active one where one
is active (the dry run runs its step in the same mode), else a new one.

Where the reference returns `(structs, specs)`, so does the port; the
parameters and caches are the port's (`init_lm` and `init_lm_cache` run
under the fake mode), a block or cache leaf one layer's, where the
reference's stacks a group's layers along a leading [G] dim.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as T


@contextlib.contextmanager
def _faking():
    """Inside the active FakeTensorMode, else inside a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE):
        yield
    else:
        with FakeTensorMode():
            yield


def _local_shape(shape, spec: sh.PartitionSpec, mesh) -> tuple:
    """A rank's shard of a global `shape` placed by `spec` on `mesh` (the
    specs only take a dim whose axes divide it)."""
    sizes = sh.axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            out[d] //= sizes[a]
    return tuple(out)


def _struct(shape, dtype, mesh, spec: sh.PartitionSpec):
    """A DTensor of global `shape` by `spec` on `mesh`, over a fake local
    shard."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    local = torch.empty(_local_shape(shape, spec, mesh), dtype=dtype)
    stride = torch.empty(shape, dtype=dtype, device="meta").stride()
    return DTensor.from_local(local, mesh, sh.placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _place(tree, specs, mesh):
    return sh.map_with_path(
        lambda _, t, s: _struct(t.shape, t.dtype, mesh, s), tree, specs)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      policy: sh.ShardingPolicy = sh.ShardingPolicy()
                      ) -> Dict[str, Any]:
    """{tokens, targets, (frontend_embeds)} DTensors."""
    specs = sh.batch_specs(cfg, shape, mesh, policy)
    B, S = shape.global_batch, shape.seq_len
    with _faking():
        batch = {"tokens": _struct((B, S), torch.int32, mesh,
                                   specs["tokens"]),
                 "targets": _struct((B, S), torch.int32, mesh,
                                    specs["targets"])}
        if cfg.frontend != "none":
            batch["frontend_embeds"] = _struct(
                (B, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16,
                mesh, specs["frontend_embeds"])
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        policy: sh.ShardingPolicy = sh.ShardingPolicy()):
    batch = train_batch_specs(cfg, shape, mesh, policy)
    del batch["targets"]
    return batch


def param_structs(cfg: ModelConfig, mesh,
                  policy: sh.ShardingPolicy = sh.ShardingPolicy()):
    """(DTensor tree, spec tree) of the model params: the port's init run
    on fake tensors, so nothing is allocated."""
    with _faking():
        structs = T.init_lm(torch.Generator(), cfg)
        specs = sh.param_specs(structs, cfg, mesh, policy)
        return _place(structs, specs, mesh), specs


def opt_state_structs(params, specs, opt_cfg, mesh):
    """AdamW's state for `param_structs`' output: each moment by its
    param's spec, in `opt_cfg.state_dtype` where one is set, the step
    count replicated (the reference's `AdamWState` specs)."""
    from repro_torch.optim.optimizer import AdamWState

    def moment(_, p, spec):
        dtype = getattr(torch, opt_cfg.state_dtype) if opt_cfg.state_dtype \
            else p.dtype
        return _struct(p.shape, dtype, mesh, spec)

    with _faking():
        return AdamWState(step=_struct((), torch.int32, mesh, sh.P()),
                          m=sh.map_with_path(moment, params, specs),
                          v=sh.map_with_path(moment, params, specs))


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  policy: sh.ShardingPolicy = sh.ShardingPolicy(),
                  cache_dtype=torch.bfloat16):
    B, L = shape.global_batch, shape.seq_len
    with _faking():
        structs = T.init_lm_cache(cfg, B, L, cache_dtype, device="cpu")
        specs = sh.cache_specs(cfg, shape, mesh, structs, policy)
        return _place(structs, specs, mesh), specs


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       policy: sh.ShardingPolicy = sh.ShardingPolicy()):
    da = sh.data_axes(mesh)
    B = shape.global_batch
    n = sh._axis_size(mesh, da)
    spec = sh.P(da if n > 1 and B % n == 0 else None, None)
    with _faking():
        return _struct((B, 1), torch.int32, mesh, spec)
