"""Shared tables harness (counterpart of `benchmarks/common.py`): run the
four ETuner configurations and the SOTA baselines on a continual
benchmark, returning paper-style rows.

The paper methods are declarative policy stacks and the baselines
controller objects, both from `repro_torch.baselines.harness`; the
runtime is built through the `RuntimeConfig` front door. Every number
comes from the port's runtime (its train steps, their FLOP counts) and
the calibrated `EdgeCostModel`; nothing is hard-coded.

Beside the reference's arguments, `run_method` takes keyword-only
`device` (the card unless the caller passes the CPU), `use_pallas` (the
model's kernels and SimFreeze's CKA kernel) and `model_cfg` (a model
config in place of `get_reduced(arch)`). The defaults keep the
reference's semantics: the reduced config, no kernels."""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from repro_torch import resolve_device
from repro_torch.baselines.harness import (ET_LAZYTUNE, ET_SIMFREEZE,
                                           PAPER_METHODS, make_controller,
                                           method_policies, profiling_charge)
from repro_torch.configs import get_reduced
from repro_torch.data import streams
from repro_torch.models import build_model
from repro_torch.runtime import (ContinualRuntime, HookSpec, RuntimeConfig,
                                 SlotConfig)

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, os.pardir,
    "results_torch"))

__all__ = ["PAPER_METHODS", "ET_LAZYTUNE", "ET_SIMFREEZE", "RESULTS_DIR",
           "make_controller", "method_policies", "run_method", "save_rows",
           "print_csv"]


def _benchmark(bench_name: str, scenarios: int, batches: int, seed: int):
    if bench_name == "20news":
        return streams.text_benchmark(num_scenarios=scenarios,
                                      batches=batches, seed=seed)
    kw = dict(batches=batches, seed=seed)
    if bench_name != "s-cifar":
        kw["num_scenarios"] = scenarios
    return streams.REGISTRY[bench_name](**kw)


def run_method(arch: str, bench_name: str, method: str, *, seeds=(0,),
               batches: int = 16, scenarios: int = 4, inferences: int = 40,
               quant_bits: int = 0, unlabeled: float = 0.0,
               data_dist: str = "poisson", inf_dist: str = "poisson",
               inference_window: float = 0.0, device=None,
               use_pallas: bool = False, model_cfg=None) -> Dict:
    """One method on one benchmark, averaged over `seeds`: the row of
    accuracy (and its spread), modeled time and energy, TFLOPs and
    rounds. RigL trains its wrapped model; Ekya's profiling is charged
    after the run."""
    device = resolve_device(device)
    accs, times, energies, tflops, rounds = [], [], [], [], []
    hooks = []
    if quant_bits:
        hooks.append(HookSpec("fake-quant", {"bits": quant_bits}))
    if unlabeled:
        hooks.append(HookSpec("simsiam", {"fraction": unlabeled}))
    for seed in seeds:
        cfg = get_reduced(arch) if model_cfg is None else model_cfg
        if use_pallas:
            cfg = cfg.replace(use_pallas=True)
        model = build_model(cfg, device=device)
        bench = _benchmark(bench_name, scenarios, batches, seed)
        ctrl = make_controller(model, method, use_kernel=use_pallas)
        if method == "rigl":
            model = ctrl.wrap_model()
        rt = ContinualRuntime.from_config(
            RuntimeConfig(
                slots={"default": SlotConfig(arch=arch,
                                             hooks=tuple(hooks))},
                seed=seed, pretrain_epochs=2,
                inference_window=inference_window, use_pallas=use_pallas),
            device=device, model=model, benchmark=bench, controller=ctrl)
        res = rt.run(inferences_total=inferences, data_dist=data_dist,
                     inf_dist=inf_dist)
        # Ekya's trial-and-error profiling cost (extra rounds of compute)
        res.total_time_s, res.total_energy_j = profiling_charge(
            ctrl, res.rounds, res.total_time_s, res.total_energy_j)
        accs.append(res.avg_inference_acc)
        times.append(res.total_time_s)
        energies.append(res.total_energy_j)
        tflops.append(res.compute_tflops)
        rounds.append(res.rounds)
    return {"arch": arch, "bench": bench_name, "method": method,
            "acc": float(np.mean(accs)), "acc_std": float(np.std(accs)),
            "time_s": float(np.mean(times)),
            "energy_j": float(np.mean(energies)),
            "tflops": float(np.mean(tflops)),
            "rounds": float(np.mean(rounds)), "seeds": len(seeds)}


def save_rows(name: str, rows: List[dict]) -> str:
    """Write `rows` to `results_torch/<name>.json`; returns the path."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    return path


def print_csv(name: str, rows: List[dict], keys=("acc", "time_s", "energy_j")):
    for r in rows:
        derived = " ".join(f"{k}={r[k]:.4g}" for k in keys if k in r)
        print(f"{name},{r['arch']}/{r['bench']}/{r['method']},{derived}")
