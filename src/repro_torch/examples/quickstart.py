"""Quickstart: ETuner vs immediate fine-tuning on a tiny continual-learning
stream, built through the declarative session API (DESIGN.md §11): a
`RuntimeConfig` names the model slot, its benchmark and its policy stack
(trigger / freeze / drift / publish), and `edgeol_session` materializes
the runtime. The counterpart of `examples/quickstart.py`, with the same
stacks, sizes and printed lines; it runs on CUDA unless `--device` names
another device.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Sanity (`sanity`): ETuner shows lower time and energy than Immediate,
nonzero freezes and two or more recompiles.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.core.policies import PolicySpec, PolicyStackSpec
from repro_torch.runtime import RuntimeConfig, SlotConfig, edgeol_session

BENCH = dict(num_classes=10, num_scenarios=4, batches=8, batch_size=16)
INFERENCES = 24

STACKS = {
    # immediate fine-tuning: every batch triggers, nothing freezes
    "Immediate": PolicyStackSpec(trigger=PolicySpec("immediate"),
                                 freeze=PolicySpec("none"),
                                 drift=PolicySpec("none")),
    # ETuner = LazyTune trigger + SimFreeze plan (paper Algorithm 1)
    "ETuner": PolicyStackSpec(
        trigger=PolicySpec("lazytune", {"max_batches_needed": 8.0}),
        freeze=PolicySpec("simfreeze", {"freeze_interval": 6}),
        drift=PolicySpec("none")),
}


def sanity(results) -> list:
    """The quickstart's checks on `main`'s results; the failed ones."""
    (imm, _), (et, et_rt) = results["Immediate"], results["ETuner"]
    failed = []
    if not et.total_time_s < imm.total_time_s:
        failed.append("ETuner's time is not below Immediate's")
    if not et.total_energy_j < imm.total_energy_j:
        failed.append("ETuner's energy is not below Immediate's")
    if not et_rt.controller.stats().get("freezes", 0) > 0:
        failed.append("ETuner froze nothing")
    if not et.recompiles >= 2:
        failed.append("ETuner recompiled fewer than two times")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for name, stack in STACKS.items():
        cfg = RuntimeConfig(
            slots={"default": SlotConfig(arch="mobilenetv2", benchmark="nc",
                                         benchmark_kw=BENCH,
                                         policies=stack)},
            pretrain_epochs=2)
        rt = edgeol_session(cfg, device=device)
        res = rt.run(inferences_total=INFERENCES)
        print(f"{name:10s} {res.summary()}")
        bd = {k: round(v, 2) for k, v in res.breakdown.items()}
        print(f"           breakdown: {bd}")
        print(f"           controller: {rt.controller.stats()}")
        results[name] = (res, rt)
    return results


if __name__ == "__main__":
    main()
