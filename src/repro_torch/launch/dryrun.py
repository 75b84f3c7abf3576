"""Multi-pod dry run of the port, ported from `repro.launch.dryrun`.

Per cell (arch x input shape x mesh) a worker starts a `fake` process
group of the mesh's size and takes rank 0's view: 256 ranks for
``single`` (data 16, model 16), 512 for ``multi`` (pod 2, data 16,
model 16), and 1 for ``one``, the (1, 1) mesh of a world of one that
`launch.train` runs on a single card. It builds the cell's inputs with
`launch/specs.py` (DTensors over fake shards: nothing is allocated) and
runs, on fake tensors under `roofline.analysis.StepCostCounter`, the
step the port would really run:

- train: `launch/train.py::make_step`, the sharded step
  (`distributed/spmd.py`): the rank's data rows are its own, each layer
  gathers its params' FSDP shards for its use and computes its part
  over `model`, the gradients are reduce-scattered back to the params'
  placements and AdamW updates the shards. With ``update=False``
  (``--no-update``) the step stops before AdamW: the loss and gradients
  alone (`launch.train._loss_and_grads`), whose peak is the activations'
  and remat's, not the optimizer's;
- prefill and decode: the same sharded step under `torch.no_grad`,
  `lm_prefill` or `lm_decode` on the rank's shards of the batch; a
  decode writes its token into the rank's shard of the cache. Where the
  data axes do not split the batch (``long_500k``: a decode of one row)
  the step runs with `rows=False`, and the weights stay where they lie
  (`spmd.matmul`): only activations move.

The record carries the reference's keys: the counted FLOPs, bytes and
collectives per rank, `memory_per_chip` (`argument`: the local bytes of
the step's inputs; `output`: those of its outputs; `temp`: the peak of
the storage the step made, above its arguments; `generated_code`: 0),
the roofline terms at the H100's peaks, and the seconds it took to
build the inputs (`lower_s`) and to run the counted step (`compile_s`),
the port's counterparts of the reference's lowering and compile. The
port counts every layer, so the totals need none of the reference's
depth probes; on the ``single`` and ``multi`` meshes the record still
carries `probe_per_group` and `probe_outer`, by the reference's probe
arithmetic on counts at 1 and 2 groups (2 and 4 under a freeze prefix).
The reference probes on ``single`` only: on ``multi`` its totals are
XLA:CPU's rolled count, which counts the scanned group body once (outer
work plus one group, `probe_outer + probe_per_group` here; ROADMAP
C.19).

The model runs its plain path: a cell with ``use_pallas`` raises, since
the hand-written kernels take a tensor's data pointer and a fake tensor
has none (the reference's dry run also lowers the plain path).

Worker:        python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
Orchestrator:  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--jobs N]

A shape is one of the four LM shapes or ``<kind>_<batch>x<seq>`` (e.g.
``train_4x512``). The orchestrator runs one worker subprocess per cell
(each its own process group, with a timeout), `jobs` at a time. Records
go to `results_torch/dryrun/` at the repo root (--results-dir).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from repro_torch.obs.log import configure_logging, get_logger

log = get_logger("launch.dryrun")

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results_torch", "dryrun"))

# mesh name -> (shape, axis names)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model"))}

_SHAPE = re.compile(r"^(train|prefill|decode)_(\d+)x(\d+)$")

NO_KERNELS = ("use_pallas: the dry run runs on fake tensors, which have no "
              "data pointer for the hand-written kernels to take; it runs "
              "the plain path, as the reference's does")


def get_cell_shape(name: str):
    """One of the four LM shapes, or ``<kind>_<batch>x<seq>``."""
    from repro_torch.configs import get_shape
    from repro_torch.configs.base import ShapeConfig

    m = _SHAPE.match(name)
    if m:
        return ShapeConfig(name, int(m.group(3)), int(m.group(2)),
                           m.group(1))
    return get_shape(name)


def cell_filename(arch: str, shape: str, mesh: str, tag: str = "",
                  results_dir: Optional[str] = None) -> str:
    suffix = f"_{tag}" if tag else ""
    return os.path.join(results_dir or RESULTS_DIR,
                        f"{arch}__{shape}__{mesh}{suffix}.json")


@contextlib.contextmanager
def fake_world(mesh_name: str):
    """A DeviceMesh of `mesh_name` over a `fake` process group of its size
    in this process (rank 0), destroyed on exit."""
    import torch.distributed as dist
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MESHES[mesh_name]
    if dist.is_initialized():
        raise RuntimeError("a process group is running: the dry run starts "
                           "its own fake one (run it in a worker)")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def _rows(leaf):
    """A batch leaf as the plain tensor of this rank's shard: its rows
    where the batch specs split them over the data axes."""
    from torch.distributed.tensor import DTensor

    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def _split_rows(leaf) -> bool:
    """Whether a batch leaf's rows are split over the data axes."""
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor) and any(
        p.is_shard(0) for p in leaf.placements)


def reference_position_bytes(arch: str, shape_name: str) -> int:
    """The bytes the reference's record of a cell counts for its decode's
    int32 position, a traced scalar there and a Python int in the port:
    4 where the decode reads it (an attention layer writes and attends at
    it), else 0, since `jax.jit` drops an argument the function does not
    read (`keep_unused=False`), as it drops rwkv6's."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    reads = any(cfg.layer_kind(i) == "attn" for i in range(T.group_size(cfg)))
    return 4 if get_cell_shape(shape_name).kind == "decode" and reads else 0


def local_bytes(tree) -> float:
    """The bytes of a tree's tensors on this rank (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return float(total)


def count_step(cfg, shape, mesh, policy, opt_cfg, frozen_groups: int = 0,
               update: bool = True) -> dict:
    """Run the cell's step once on fake inputs under a `StepCostCounter`
    (a train step without its AdamW update where `update` is False):
    {"counter", "memory", "build_s", "step_s"}."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import tree_map
    from repro_torch.core.freeze_plan import FreezePlan
    from repro_torch.distributed import spmd
    from repro_torch.launch import specs as S
    from repro_torch.launch.train import _loss_and_grads, make_step
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.roofline.analysis import StepCostCounter

    t0 = time.time()
    with FakeTensorMode():
        params, param_spec = S.param_structs(cfg, mesh, policy)
        if shape.kind == "train":
            G = T.num_groups(cfg)
            k = frozen_groups
            plan = FreezePlan(groups=tuple(i < k for i in range(G)),
                              embed=k > 0) if k else None
            model = build_model(cfg, device="cpu")
            batch = tree_map(_rows, S.train_batch_specs(cfg, shape, mesh,
                                                        policy))
            if update:
                step = make_step(model, opt_cfg, plan, mesh)
                args = (params, S.opt_state_structs(params, param_spec,
                                                     opt_cfg, mesh), batch)
            else:
                def step(params, batch):
                    return _loss_and_grads(model, params, batch, plan, mesh)

                args = (params, batch)
        elif shape.kind == "prefill":
            specs = S.prefill_batch_specs(cfg, shape, mesh, policy)
            rows = _split_rows(specs["tokens"])

            def step(params, batch):
                with torch.no_grad(), spmd.step(mesh, rows):
                    return T.lm_prefill(params, cfg, batch)

            args = (params, tree_map(_rows, specs))
        else:
            cache, _ = S.cache_structs(cfg, shape, mesh, policy)
            pos = shape.seq_len - 1
            tokens = S.decode_token_specs(cfg, shape, mesh, policy)
            rows = _split_rows(tokens)

            def step(params, cache, tokens):
                with torch.no_grad(), spmd.step(mesh, rows):
                    return T.lm_decode(params, cfg, tokens, cache, pos)

            args = (params, cache, _rows(tokens))
        build_s = time.time() - t0
        counter = StepCostCounter(arguments=args)
        with counter:
            out = step(*args)
        memory = {"argument": local_bytes(args),
                  "output": local_bytes(out), "temp": float(counter.peak),
                  "generated_code": 0.0}
        del out, args, params
    return {"counter": counter, "memory": memory, "build_s": build_s,
            "step_s": time.time() - t0 - build_s}


def _costs(run: dict) -> dict:
    c = run["counter"]
    return {"flops": float(c.count.total), "bytes": float(c.bytes),
            "coll": c.collectives.bytes_per_chip}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             fsdp: bool = True, freeze_prefix: float = 0.0,
             remat: Optional[str] = None, tag: str = "",
             print_analysis: bool = True, update: bool = True) -> dict:
    from repro_torch.configs import cell_is_applicable, get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig
    from repro_torch.roofline import analysis as RA

    cfg = get_config(arch).replace(ssm_chunk=2048, attn_q_block=4096,
                                   attn_k_block=4096)
    if remat:
        cfg = cfg.replace(remat=remat)
    # Perf-iteration hook: REPRO_OVERRIDES="field=value,..." patches the
    # ModelConfig (types coerced from the field's current value).
    for kv in filter(None, os.environ.get("REPRO_OVERRIDES", "").split(",")):
        key, val = kv.split("=")
        cur = getattr(cfg, key)
        typ = type(cur)
        coerced = (val.lower() in ("1", "true")) if typ is bool else typ(val)
        cfg = cfg.replace(**{key: coerced})
    if cfg.use_pallas:
        raise NotImplementedError(NO_KERNELS)
    shape = get_cell_shape(shape_name)
    if not update and shape.kind != "train":
        raise ValueError(f"update=False counts a train step without its "
                         f"AdamW update; {shape_name} is a {shape.kind}")
    skip = cell_is_applicable(cfg, shape)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "fsdp": fsdp, "freeze_prefix": freeze_prefix, "tag": tag,
              "remat": cfg.remat}
    if not update:
        record["update"] = False
    if skip:
        record.update({"status": "skip", "reason": skip})
        return record

    policy = sh.ShardingPolicy(fsdp=fsdp)
    # bf16 optimizer moments for >=100B-param configs (DESIGN.md §4)
    big = cfg.param_count() > 100e9
    opt_cfg = AdamWConfig(lr=1e-4, state_dtype="bfloat16" if big else None,
                          clip_norm=0.0)
    G = T.num_groups(cfg)
    k_full = int(G * freeze_prefix) if shape.kind == "train" else 0
    t0 = time.time()
    with fake_world(mesh_name) as mesh:
        mesh_s = time.time() - t0
        chips = mesh.size()
        run = count_step(cfg, shape, mesh, policy, opt_cfg, k_full, update)
        probes = None
        if mesh_name != "one":
            # the reference's depth probes, by its arithmetic (it
            # extrapolates its single-mesh totals from them; the port's
            # are counted)
            g = T.group_size(cfg)

            def probe(groups, frozen):
                return _costs(count_step(
                    cfg.replace(num_layers=groups * g),
                    shape, mesh, policy, opt_cfg, frozen, update))

            if not freeze_prefix:
                p1, p2 = probe(1, 0), probe(2, 0)
                per_group = {k: p2[k] - p1[k] for k in p1}
                outer = {k: p1[k] - per_group[k] for k in p1}
            else:
                f21, f41, f42 = probe(2, 1), probe(4, 1), probe(4, 2)
                per_group, outer = {}, {}
                for key in f21:
                    ac = (f41[key] - f21[key]) / 2.0
                    fr = f42[key] - f41[key] + ac
                    per_group[key] = ac
                    outer[key] = f21[key] - fr - ac
            probes = (per_group, outer)
    counter, memory = run["counter"], run["memory"]
    if print_analysis:
        log.info("[%s x %s x %s] mesh of %d ranks in %.2f s, inputs in "
                 "%.2f s, the counted step in %.2f s", arch, shape_name,
                 mesh_name, chips, mesh_s, run["build_s"], run["step_s"])
        log.info("[%s x %s x %s] memory_per_chip: %s", arch, shape_name,
                 mesh_name, memory)
        log.info("[%s x %s x %s] counted: %s", arch, shape_name, mesh_name,
                 {"flops": counter.count.total, "bytes": counter.bytes,
                  "collective bytes": counter.collectives.bytes_per_chip})
    rep = RA.analyze(counter, arch=arch, shape=shape_name,
                     mesh_name=mesh_name, chips=chips,
                     model_flops=RA.model_flops_estimate(cfg, shape),
                     memory=memory)
    if probes is not None:
        record["probe_per_group"], record["probe_outer"] = probes
    record.update({"status": "ok",
                   "lower_s": round(mesh_s + run["build_s"], 1),
                   "compile_s": round(run["step_s"], 1), **rep.to_dict()})
    return record


def save_record(record: dict, results_dir: Optional[str] = None) -> str:
    os.makedirs(results_dir or RESULTS_DIR, exist_ok=True)
    path = cell_filename(record["arch"], record["shape"], record["mesh"],
                         record.get("tag", ""), results_dir)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return path


def orchestrate(mesh_modes, archs=None, shapes=None, timeout=2400,
                tag="", extra_args=(), *, jobs: int = 1, cells=None,
                results_dir: Optional[str] = None) -> int:
    """One worker subprocess a cell, `jobs` at a time: every (mesh, arch,
    shape) of `mesh_modes` x `archs` x `shapes` with `tag` and
    `extra_args`, or the given `cells`, each (arch, shape, mesh, tag,
    extra args). A cell whose record exists is skipped. Returns 1 if a
    worker failed or timed out, else 0."""
    from repro_torch.configs import ARCHS, LM_SHAPES

    if cells is None:
        archs = archs or list(ARCHS)
        shapes = shapes or [s.name for s in LM_SHAPES]
        cells = [(a, s, m, tag, tuple(extra_args)) for m in mesh_modes
                 for a in archs for s in shapes]
    todo = []
    for arch, shape, mesh_name, cell_tag, extra in cells:
        out = cell_filename(arch, shape, mesh_name, cell_tag, results_dir)
        if os.path.exists(out):
            log.info("skip existing %s", out)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_name,
               "--save"] + list(extra)
        if cell_tag:
            cmd += ["--tag", cell_tag]
        if results_dir:
            cmd += ["--results-dir", results_dir]
        todo.append(((arch, shape, mesh_name), cmd))

    def work(item):
        cell, cmd = item
        log.info(">> %s", " ".join(cmd))
        try:
            # workers side by side would interleave their JSON records
            r = subprocess.run(cmd, timeout=timeout, stdout=(
                subprocess.DEVNULL if jobs > 1 else None))
            return None if r.returncode == 0 else (*cell, r.returncode)
        except subprocess.TimeoutExpired:
            return (*cell, "timeout")

    with ThreadPoolExecutor(max(1, jobs)) as pool:
        failures = [f for f in pool.map(work, todo) if f is not None]
    if failures:
        log.error("FAILURES: %s", failures)
        return 1
    log.info("all cells complete")
    return 0


def main(argv=None):
    configure_logging(os.environ.get("EDGEOL_LOG") or "INFO")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--freeze-prefix", type=float, default=0.0)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--no-update", action="store_true",
                    help="train cells: the loss and gradients alone, "
                         "without the AdamW update")
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: worker subprocesses at once")
    ap.add_argument("--results-dir", default=None,
                    help="where records go (default results_torch/dryrun)")
    args = ap.parse_args(argv)

    if args.all:
        modes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        extra = []
        if args.no_fsdp:
            extra.append("--no-fsdp")
        if args.remat:
            extra += ["--remat", args.remat]
        if args.freeze_prefix:
            extra += ["--freeze-prefix", str(args.freeze_prefix)]
        if args.no_update:
            extra.append("--no-update")
        sys.exit(orchestrate(modes, timeout=args.timeout, tag=args.tag,
                             extra_args=extra, jobs=args.jobs,
                             results_dir=args.results_dir))

    try:
        record = run_cell(args.arch, args.shape, args.mesh,
                          fsdp=not args.no_fsdp,
                          freeze_prefix=args.freeze_prefix,
                          remat=args.remat, tag=args.tag,
                          update=not args.no_update)
    except Exception as e:
        record = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:], "tag": args.tag}
        if args.save:
            save_record(record, args.results_dir)
        # the JSON record is the worker's machine-readable stdout
        # contract; diagnostics go through the logger (stderr)
        sys.stdout.write(json.dumps(
            {k: v for k, v in record.items() if k != "traceback"},
            indent=1) + "\n")
        log.error("cell failed:\n%s", record["traceback"])
        sys.exit(2)
    if args.save:
        path = save_record(record, args.results_dir)
        log.info("saved %s", path)
    sys.stdout.write(json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    main()
