"""SOTA efficient-training baselines the paper compares against (§V-C,
Tables V & VII), ported from `repro.baselines`. All expose the
ETunerController event API so they plug into the port's
`ContinualRuntime` unchanged (through `LegacyControllerAdapter` where
their `should_trigger` predates a keyword):

- StaticController     — fixed-interval lazy tuning (Table VII S1..S4)
- EgeriaController     — knowledge-guided *module* freezing, strictly
                         front-to-back (Wang et al., EuroSys'23)
- SlimFitController    — weight-update-magnitude freezing (Ardakani'23)
- RigLController       — sparse training w/ magnitude-drop/gradient-regrow
                         (Evci et al., ICML'20)
- EkyaController       — fixed-window scheduling + trial-and-error config
                         search (Bhardwaj et al., NSDI'22)

Each can be combined with LazyTune (the paper integrates its inter-tuning
optimization into every baseline for Table V) via `with_lazytune=True`.
`make_controller` builds every method with the parameters of
`benchmarks/common.py`, and `profiling_charge` adds Ekya's profiling cost
to a session's totals.
"""
from repro_torch.baselines.controllers import (EgeriaController,
                                               EkyaController,
                                               RigLController,
                                               SlimFitController,
                                               StaticController)
from repro_torch.baselines.harness import make_controller, profiling_charge

__all__ = ["StaticController", "EgeriaController", "SlimFitController",
           "RigLController", "EkyaController", "make_controller",
           "profiling_charge"]
