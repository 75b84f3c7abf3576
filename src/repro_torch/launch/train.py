"""Production continual fine-tuning entry point, the counterpart of
`repro.launch.train`: the ETuner LM loop on a device mesh with sharded
params, one cached step per freeze plan, gradient sync over the data
axes and crash-safe checkpointing. It runs a reduced arch unless --full
is passed, on the host mesh of the world it is started in
(`launch.mesh.make_host_mesh`: a world of one gives (1, 1)), on the card
unless --device names another:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 60
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu

Params (the port's init from seed 0, or the caller's: bridged JAX params,
for one) are placed as DTensors by `distributed.sharding.param_specs`
through `named`, and AdamW's moments by `opt_state_specs`; AdamW updates
them as DTensors, each rank its own shards (`implicit_replication` lets
its scalars and step count in). The loss and its gradients are the
sharded step (`_loss_and_grads` under `distributed.spmd.step`): a rank
trains on its data shard's rows of each global batch, each layer gathers
its params' FSDP shards for its use and computes its part of the heads,
the MLP, the vocabulary and the experts over `model`
(`distributed/spmd.py`), and the gradients come back placed as the
params are, summed over the data axes by the reduce-scatters of that
gather's backward. A frozen leaf is detached before its gather, so its
gradient is zeros and nothing of it is sent. The hand-written kernels
(flash attention, WKV6) run on each rank's local heads. No param is
gathered whole but for a checkpoint.

As in the reference: AdamW at lr 1e-3 with no schedule, batches of
uniform tokens from `default_rng(0)`, the half-prefix plan (the first
half of the groups and the embedding frozen) from --freeze-at, a save of
the params every 25 steps and a blocking one at the end. The default
--ckpt-dir lives under the temporary directory (`TMPDIR`, else /tmp).
There is no resume.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.freeze_plan import FreezePlan
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import spmd
from repro_torch.distributed.elastic import whole
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.platform import bootstrap
from repro_torch.models import build_model
from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.train_loop import grads_of

log = get_logger("launch.train")

OPT_CFG = AdamWConfig(lr=1e-3)


def _data_shards(mesh) -> tuple:
    """(this rank's index along the data axes, their number of shards)."""
    index, n = 0, 1
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for a in sh.data_axes(mesh):
        size = sh.axis_sizes(mesh)[a]
        index, n = index * size + coord[a], n * size
    return index, n


def _loss_and_grads(model, params, batch, plan, mesh):
    """The loss and the params' gradients: on `mesh` the sharded step on
    this rank's rows of the batch, the gradients placed as their params
    (DTensors), the loss the global batch's."""
    if mesh is None:
        loss, _, grads = grads_of(model.loss, params, batch, plan)
        return loss, grads
    if mesh.size() == 1:
        # one rank holds every leaf whole: its local tensors are taken
        # once here, not at each use (DTensor's host dispatch), and the
        # gradients placed as the params are
        local, back = spmd.local(params)
        with spmd.step(mesh):
            loss, _, grads = grads_of(model.loss, local, batch, plan)
        return loss, back(grads)
    with spmd.step(mesh):
        loss, _, grads = grads_of(model.loss, params, batch, plan)
    return loss, grads


def make_step(model, opt_cfg: AdamWConfig, plan, mesh=None):
    """The train step under `plan`: (params, opt_state, batch) ->
    (params, opt_state, loss); params and moments DTensors on `mesh`, or
    plain tensors where `mesh` is None."""
    from torch.distributed.tensor.experimental import implicit_replication

    def step(params, opt_state, batch):
        loss, grads = _loss_and_grads(model, params, batch, plan, mesh)
        with implicit_replication():
            params, opt_state = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, loss

    return step


def synthetic_batch(rng, cfg: ModelConfig, batch: int, seq: int, device,
                    rows=slice(None)) -> dict:
    """The reference's batch for `rng`: uniform tokens [batch, seq + 1] cut
    into int32 tokens and targets (`rows` of them), and a frontend stub's
    zeros where the arch has one."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))[rows]
    out = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32,
                                     device=device),
           "targets": torch.as_tensor(toks[:, 1:], dtype=torch.int32,
                                      device=device)}
    if cfg.frontend != "none":
        out["frontend_embeds"] = torch.zeros(
            (len(toks), cfg.frontend_tokens, cfg.frontend_dim),
            dtype=torch.bfloat16, device=device)
    return out


def half_prefix_plan(num_groups: int) -> FreezePlan:
    return FreezePlan(groups=tuple(i < num_groups // 2
                                   for i in range(num_groups)), embed=True)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          freeze_at: int, ckpt_dir=None, mesh=None, device=None,
          params=None, on_step=None) -> dict:
    """The loop: `steps` steps of AdamW on `cfg`'s model, the half-prefix
    plan from step `freeze_at`, params placed on `mesh` (plain tensors on
    `device` where `mesh` is None) from `params` or the port's seed-0
    init, checkpoints in `ckpt_dir` (none where it is None).
    `on_step(step, plan)` is called before each step. Returns the losses
    (floats), the final params and optimizer state, and the seconds the
    steps took."""
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(0))
    opt_state = adamw_init(params, OPT_CFG)
    rows = slice(None)
    if mesh is not None:
        specs = sh.param_specs(params, cfg, mesh)
        opt_state = sh.place(opt_state, sh.opt_state_specs(
            specs, opt_state, params), mesh)
        params = sh.place(params, specs, mesh)
        index, n = _data_shards(mesh)
        if batch % n:
            raise ValueError(f"batch {batch} does not split over {n} data "
                             f"shards")
        rows = slice(index * batch // n, (index + 1) * batch // n)
    saving = ckpt_dir is not None
    mgr = CheckpointManager(ckpt_dir, keep=2) if saving and (
        mesh is None or dist.get_rank() == 0) else None

    cache = {}
    rng = np.random.default_rng(0)
    plan, losses = None, []
    t0 = time.perf_counter()
    for step_i in range(steps):
        if step_i == freeze_at:
            G = model.num_freeze_units
            plan = half_prefix_plan(G)
            log.info("step %d: structural freeze of %d/%d groups", step_i,
                     G // 2, G)
        if plan not in cache:
            cache[plan] = make_step(model, OPT_CFG, plan, mesh)
        b = synthetic_batch(rng, cfg, batch, seq, model.device, rows)
        if on_step is not None:
            on_step(step_i, plan)
        params, opt_state, loss = cache[plan](params, opt_state, b)
        losses.append(float(loss))
        if step_i % 10 == 0:
            log.info("step %3d loss=%.4f", step_i, losses[-1])
        if saving and step_i % 25 == 24:
            _save(mgr, step_i, params, block=False)
    seconds = time.perf_counter() - t0
    if saving:
        _save(mgr, steps - 1, params, block=True)
    log.info("done in %.1fs; ckpts at %s", seconds, ckpt_dir)
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "seconds": seconds}


def _save(mgr, step, params, *, block):
    """Every rank gathers the params' whole values; the first rank (the
    one with a manager) writes them."""
    full = tree_map(whole, params)
    if mgr is not None:
        mgr.save(step, full, block=block)


def main(argv=None):
    # a CLI entry point wants its progress visible by default; EDGEOL_LOG
    # still wins when set (e.g. EDGEOL_LOG=WARNING for quiet runs)
    configure_logging(os.environ.get("EDGEOL_LOG") or "INFO")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--freeze-at", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    ap.add_argument("--full", action="store_true",
                    help="the arch at full size (default: reduced)")
    args = ap.parse_args(argv)

    device = bootstrap(args.device)
    cfg = (get_config if args.full else get_reduced)(args.arch)
    started = not dist.is_initialized()
    mesh = make_host_mesh(device=device)
    log.info("mesh: %s ranks=%d", sh.axis_sizes(mesh), mesh.size())
    try:
        train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              freeze_at=args.freeze_at, ckpt_dir=args.ckpt_dir, mesh=mesh,
              device=device)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
