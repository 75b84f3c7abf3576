"""The controllers of `benchmarks/common.py`, ported: `method_policies`
gives each paper method's policy stack (with the reference's
`trigger_policy`), `make_controller` builds every method of Tables II-VIII
with the harness's parameters, and `profiling_charge` adds Ekya's
trial-and-error profiling to a session's totals, as `run_method` does.
`repro_torch.harness` builds the runs and the tables on them."""
from __future__ import annotations

from typing import Tuple

from repro_torch.baselines.controllers import (EgeriaController,
                                               EkyaController,
                                               RigLController,
                                               SlimFitController,
                                               StaticController)
from repro_torch.core.policies import PolicySpec, PolicyStackSpec

#: the four paper ablations (Immed. / LazyTune / SimFreeze / ETuner)
PAPER_METHODS = ("immed", "lazytune", "simfreeze", "etuner")

# the harness's operating point at reduced scale
ET_LAZYTUNE = {"max_batches_needed": 6.0}
ET_SIMFREEZE = {"freeze_interval": 10, "min_history": 3,
                "cka_threshold": 0.01}


def method_policies(method: str, trigger_policy: str = "default",
                    use_kernel: bool = False) -> PolicyStackSpec:
    """The policy stack of one paper method. `trigger_policy` swaps the
    LazyTune trigger for its priority-weighted variant
    ("priority-weighted", BENCH schema v4): the accumulation target is
    scaled by each stream's QoS priority, so it only makes sense for the
    LazyTune-bearing methods. `use_kernel` routes SimFreeze's CKA through
    the CKA kernel; without it the stack names no route, so a session's
    `use_pallas` picks it (`runtime/config.py::_slot_policies`), and its
    `to_dict()` is the reference's."""
    if method not in PAPER_METHODS:
        raise KeyError(method)
    lazy = method in ("lazytune", "etuner")
    freeze = method in ("simfreeze", "etuner")
    if trigger_policy == "default":
        trigger = PolicySpec("lazytune", dict(ET_LAZYTUNE)) if lazy \
            else PolicySpec("immediate")
    elif trigger_policy == "priority-weighted":
        if not lazy:
            raise ValueError(
                f"trigger_policy 'priority-weighted' scales LazyTune's "
                f"accumulation target; method {method!r} has no LazyTune")
        trigger = PolicySpec("priority-weighted", dict(ET_LAZYTUNE))
    else:
        raise ValueError(f"unknown trigger_policy {trigger_policy!r}; "
                         f"known: ['default', 'priority-weighted']")
    kernel = {"use_kernel": True} if use_kernel else {}
    return PolicyStackSpec(
        trigger=trigger,
        freeze=PolicySpec("simfreeze", dict(ET_SIMFREEZE, **kernel))
        if freeze else PolicySpec("none"),
        drift=PolicySpec("none"))


def make_controller(model, method: str, trigger_policy: str = "default",
                    use_kernel: bool = False):
    """The controller of `method`: a paper method's policy stack, or a
    baseline on LazyTune with the harness's parameters (Egeria interval
    4; SlimFit interval 4 at threshold 0.05; RigL sparsity 0.5; Ekya
    windows of 6 batches; `staticN` a round every N batches). A RigL
    session runs `ctrl.wrap_model()`. A baseline takes no trigger."""
    if method in PAPER_METHODS:
        return method_policies(method, trigger_policy,
                               use_kernel).build(model)
    if trigger_policy != "default":
        raise ValueError(f"trigger_policy={trigger_policy!r} only applies "
                         f"to the paper methods {PAPER_METHODS}")
    if method == "egeria":
        return EgeriaController(model, with_lazytune=True, interval=4)
    if method == "slimfit":
        return SlimFitController(model, with_lazytune=True, interval=4,
                                 threshold=0.05)
    if method == "rigl":
        return RigLController(model, with_lazytune=True, sparsity=0.5)
    if method == "ekya":
        return EkyaController(model, with_lazytune=True, window_batches=6)
    if method.startswith("static"):
        return StaticController(model,
                                interval=int(method[len("static"):]))
    raise KeyError(method)


def profiling_charge(ctrl, rounds: int, time_s: float,
                     energy_j: float) -> Tuple[float, float]:
    """A session's modeled (time, energy) with Ekya's profiling charged:
    a fifth of a mean round for every profiling round. Other controllers
    have no `profile_rounds` and are charged nothing."""
    n = getattr(ctrl, "profile_rounds", 0)
    return (time_s + n * 0.2 * time_s / max(rounds, 1),
            energy_j + n * 0.2 * energy_j / max(rounds, 1))
