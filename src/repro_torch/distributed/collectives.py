"""Explicit gradient collectives on `torch.distributed`, ported from
`repro.distributed.collectives`:

- `sync_grads` (the reference's `sync_grads_shard_map`): the mean of each
  rank's gradients over a mesh axis, by `all_reduce`; with
  ``compress=True`` each rank quantizes its gradients to int8 with error
  feedback (`optim/compression.py`), all-gathers the payloads and scales,
  and dequantizes and averages locally, the standard compressed
  all-reduce. Freeze-aware *skipping*: a leaf whose freeze mask is all
  zero is returned as zeros and sends nothing (ETuner's collective-term
  saving; DESIGN.md §2). The reference skips frozen leaves on its plain
  path only; its compressed path sends them too.
- `hierarchical_grad_sync`: reduce within a pod first, then across pods.

Gradients are each rank's local tensors, in the port's params trees
(leaves paired by dict key). The reference's `shard_map` version shim
has no counterpart.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree_map, tree_unflatten, tree_zip
from repro_torch.optim import compression


def _frozen(mask) -> bool:
    return bool(torch.all(torch.as_tensor(mask) == 0))


def _axis(mesh, axis: str):
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def _all_reduce_mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out / n


def _gather_mean(q: torch.Tensor, s: torch.Tensor, group,
                 n: int) -> torch.Tensor:
    """The mean over the group of each rank's int8 payload `q` times its
    scale `s`."""
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, s, group=group)
    deq = torch.stack(qs).float() * torch.stack(ss).reshape(
        (-1,) + (1,) * q.ndim)
    return deq.mean(dim=0)


def sync_grads(mesh, grads, *, axis: str = "data", compress: bool = False,
               residual=None, freeze_mask=None):
    """Returns (grads averaged over the mesh axis `axis`, new residual).

    freeze_mask: optional 0/1 tree; leaves whose mask is all zero come
    back as zeros and produce no collective traffic (their residual is
    kept as it was)."""
    group, n = _axis(mesh, axis)
    if compress and residual is None:
        residual = compression.init_residual(grads)
    trees = [grads] + ([residual] if compress else []) + \
        ([freeze_mask] if freeze_mask is not None else [])
    synced, kept = [], []
    for leaves in tree_zip(*trees):
        g, r = leaves[0], (leaves[1] if compress else None)
        if freeze_mask is not None and _frozen(leaves[-1]):
            synced.append(torch.zeros_like(g))
            kept.append(r)
        elif not compress:
            synced.append(_all_reduce_mean(g, group, n))
        else:
            gf = g.float() + r
            q, s = compression.int8_encode(gf)
            kept.append(gf - compression.int8_decode(q, s))
            synced.append(_gather_mean(q, s, group, n))
    new_res = tree_unflatten(grads, kept) if compress else residual
    return tree_unflatten(grads, synced), new_res


def hierarchical_grad_sync(mesh, grads):
    """Sum over 'data' (within a pod), then over 'pod' (across pods), and
    divide by the ranks summed over."""
    axes = [a for a in ("data", "pod") if a in mesh.mesh_dim_names]
    denom = 1
    out = grads
    for a in axes:
        group, n = _axis(mesh, a)
        denom *= n

        def reduce(x, group=group):
            x = x.clone()
            dist.all_reduce(x, group=group)
            return x

        out = tree_map(reduce, out)
    return tree_map(lambda x: x / denom, out)
