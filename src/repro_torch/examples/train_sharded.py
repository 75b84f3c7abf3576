"""`launch.train`'s loop on (data, model) meshes of the world's ranks,
each step the sharded step (`distributed/spmd.py`), printing each run's
losses, step seconds, tokens/s, flash kernel launches (none on the CPU,
where the wrapper runs its plain version) and peak memory as one JSON
line on the first rank. Start it with one process a card:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.train_sharded --mesh 2,2 --mesh 1,4
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.train_sharded --device cpu

It trains `--arch` (gemma2-2b by default; reduced unless --full) under
`use_pallas` for `--steps` steps from seed 0, the half-prefix plan from
`--freeze-at`, without checkpoints, in bf16 or (`--dtype float32`) fp32.
Each mesh takes the world's data x model ranks. With `--check` the first
rank also runs the loop on plain tensors on its own card, and each mesh
holds up step 0's loss and gradients, all active and under the
half-prefix plan (flash on the frozen layers' local heads), against the
plain-tensor step's (`step_gaps`): the JSON line gains the plain loop's
losses, each run's loss gaps by step, and step 0's loss gap and the
three leaves farthest from the plain step's (their largest gap, and
their largest |g|). Below fp32 the first rank also takes what the type
alone moves the plain step by (`type_gaps`, against fp32), and each
mesh's leaf whose gap is the most times that (`over_type`). In fp32 at
full size the plain loop does not fit one card: `--steps 0` keeps the
step-0 holds alone.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree_leaves, tree_map
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train
from repro_torch.launch.platform import bootstrap
from repro_torch.models import build_model
from repro_torch.runtime.train_loop import grads_of


def run(cfg, shape, *, steps: int, batch: int, seq: int, freeze_at: int,
        device) -> dict:
    """One run of the loop on a `shape` mesh: its losses, each step's
    seconds but the last's (from one step's start to the next's), the
    steps' tokens/s, the flash kernel's launches and the peak memory."""
    if shape[0] * shape[1] != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {shape[0] * shape[1]} "
                         f"ranks; the world has {dist.get_world_size()}")
    mesh = launch_mesh.make_mesh(shape, ("data", "model"), device)
    cuda = device.type == "cuda"
    starts = []

    def on_step(step, plan):
        if cuda:
            torch.cuda.synchronize()
        starts.append(time.perf_counter())

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches = att_ops.flash_attention.launches
    res = train.train(cfg, steps=steps, batch=batch, seq=seq,
                      freeze_at=freeze_at, mesh=mesh, device=device,
                      on_step=on_step)
    return {"losses": res["losses"],
            "step_s": [b - a for a, b in zip(starts, starts[1:])],
            "tokens_per_s": steps * batch * seq / res["seconds"],
            "flash_launches": att_ops.flash_attention.launches - launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else None}


def _paths(tree, prefix="") -> list:
    """Each leaf's path in a params tree, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def step_gaps(cfg, shape, *, batch: int, seq: int, device,
              frozen: bool) -> dict:
    """Step 0 of the loop, all active or (`frozen`) under the half-prefix
    plan, whose frozen layers run flash on each rank's local heads: the
    sharded step's loss and gradients on a `shape` mesh against the
    plain-tensor step's on the first rank (the same seed-0 params, whole,
    and the same batch, whole). On the first rank {"loss": the loss gap,
    "grads": {a leaf's path: [its largest gap, the plain leaf's largest
    |g|]}}; None on the others."""
    mesh = launch_mesh.make_mesh(shape, ("data", "model"), device)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    plan = train.half_prefix_plan(model.num_freeze_units) if frozen \
        else None
    index, n = train._data_shards(mesh)
    rows = slice(index * batch // n, (index + 1) * batch // n)
    b = train.synthetic_batch(np.random.default_rng(0), cfg, batch, seq,
                              model.device, rows)
    placed = sh.place(params, sh.param_specs(params, cfg, mesh), mesh)
    loss, grads = train._loss_and_grads(model, placed, b, plan, mesh)
    first = dist.get_rank() == 0
    if first:
        whole = train.synthetic_batch(np.random.default_rng(0), cfg, batch,
                                      seq, model.device)
        want, _, wgrads = grads_of(model.loss, params, whole, plan)
        wgrads = tree_leaves(wgrads)
    gaps = {}
    for i, (path, g) in enumerate(zip(_paths(params), tree_leaves(grads),
                                      strict=True)):
        g = g.full_tensor()
        if first:
            w = wgrads[i].float()
            gaps[path] = [float((g.float() - w).abs().max()),
                          float(w.abs().max())]
    if not first:
        return None
    return {"loss": abs(float(loss) - float(want)), "grads": gaps}


def type_gaps(cfg, *, batch: int, seq: int, device, frozen: bool) -> dict:
    """What the type alone moves step 0 by: the plain-tensor step in
    `cfg`'s type against the same step in fp32 on the same params (cast
    up, so exactly the same values) and batch, as `step_gaps` reports
    its gaps (the fp32 leaf's largest |g| beside each). A sharded step
    whose gaps to the plain step are of this size differs from it by
    rounding alone."""
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    plan = train.half_prefix_plan(model.num_freeze_units) if frozen \
        else None
    b = train.synthetic_batch(np.random.default_rng(0), cfg, batch, seq,
                              model.device)
    loss, _, grads = grads_of(model.loss, params, b, plan)
    grads = tree_leaves(grads)
    f32 = cfg.replace(dtype="float32", param_dtype="float32")
    params = tree_map(lambda t: t.float(), params)
    want, _, wgrads = grads_of(build_model(f32, device=device).loss, params,
                               b, plan)
    gaps = {}
    for path, g, w in zip(_paths(params), grads, tree_leaves(wgrads),
                          strict=True):
        gaps[path] = [float((g.float() - w).abs().max()),
                      float(w.abs().max())]
    return {"loss": abs(float(loss) - float(want)), "grads": gaps}


def _over(gaps: dict, by: dict) -> list:
    """The leaf whose gap is the most times `by`'s gap for it (its
    path, that ratio), over the leaves `by` moves."""
    return max(([p, e / by["grads"][p][0]] for p, (e, _) in
                gaps["grads"].items() if by["grads"][p][0] > 0),
               key=lambda pr: pr[1])


def _worst(gaps: dict, k: int = 3) -> dict:
    """The loss gap and the `k` leaves farthest from the plain step's,
    relative to their largest |g| (a frozen leaf's gap as it is)."""
    rel = sorted(gaps["grads"].items(),
                 key=lambda kv: kv[1][0] / (kv[1][1] or 1.0))
    return {"loss": gaps["loss"], "worst": [[p, e, m] for p, (e, m) in
                                            rel[-k:]]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCHS))
    ap.add_argument("--mesh", action="append",
                    help="data,model (repeat for several runs; default: "
                         "2,2)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--freeze-at", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    ap.add_argument("--full", action="store_true",
                    help="the arch at full size (default: reduced)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the params' and activations' type")
    ap.add_argument("--check", action="store_true",
                    help="hold each mesh against the plain-tensor loop "
                         "and step on the first rank")
    args = ap.parse_args(argv)

    device = bootstrap(args.device)
    cfg = (get_config if args.full else get_reduced)(args.arch).replace(
        use_pallas=True, dtype=args.dtype, param_dtype=args.dtype)
    launch_mesh.init_world(device)
    loop = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                freeze_at=args.freeze_at)
    plans = (("all_active", False), ("half_prefix", True))
    out, types = {}, {}
    try:
        if args.check and dist.get_rank() == 0:
            out["plain_losses"] = train.train(cfg, device=device,
                                              **loop)["losses"]
            if args.dtype != "float32":
                types = {name: type_gaps(cfg, batch=args.batch,
                                         seq=args.seq, device=device,
                                         frozen=frozen)
                         for name, frozen in plans}
                out["type_gaps"] = {k: _worst(v) for k, v in types.items()}
        for m in args.mesh or ["2,2"]:
            shape = tuple(int(a) for a in m.split(","))
            out[m] = run(cfg, shape, device=device, **loop)
            if args.check:
                for name, frozen in plans:
                    gaps = step_gaps(cfg, shape, batch=args.batch,
                                     seq=args.seq, device=device,
                                     frozen=frozen)
                    if gaps is None:
                        continue
                    r = out[m].setdefault("step0_gaps", {})[name] = \
                        _worst(gaps)
                    if types:
                        r["over_type"] = _over(gaps, types[name])
                if "plain_losses" in out:
                    out[m]["loss_gaps"] = [abs(a - b) for a, b in zip(
                        out[m]["losses"], out["plain_losses"])]
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if dist.get_rank() == 0:
            print(json.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
