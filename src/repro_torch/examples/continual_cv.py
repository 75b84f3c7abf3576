"""End-to-end continual-learning driver (paper Table II / Figs. 8-9 style):
compare Immed / LazyTune / SimFreeze / ETuner on a chosen model and
benchmark, with per-method time/energy/accuracy. Each method is a
declarative policy stack (`repro_torch.harness.common.method_policies`)
run through the `RuntimeConfig` session API (DESIGN.md §11). The
counterpart of `examples/continual_cv.py`, with the same flags and
printed lines; it runs on CUDA unless `--device` names another device.

    PYTHONPATH=src python -m repro_torch.examples.continual_cv \\
        --arch mobilenetv2 --bench nc --scenarios 4 --batches 8 \\
        --inferences 30 [--device cpu]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.harness.common import run_method


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mobilenetv2",
                    choices=["mobilenetv2", "resnet50", "deit-tiny"])
    ap.add_argument("--bench", default="nc",
                    choices=["nc", "ni", "nic", "s-cifar"])
    ap.add_argument("--scenarios", type=int, default=4)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--inferences", type=int, default=30)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--inference-window", type=float, default=0.0,
                    help="micro-batched serving: coalesce requests landing "
                         "within this many timeline seconds into one "
                         "forward pass (0 = per-request serving)")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base, rows = None, []
    for method in ("immed", "lazytune", "simfreeze", "etuner"):
        r = run_method(args.arch, args.bench, method,
                       seeds=tuple(range(args.seeds)),
                       scenarios=args.scenarios, batches=args.batches,
                       inferences=args.inferences,
                       inference_window=args.inference_window,
                       device=device)
        if base is None:
            base = r
        print(f"{method:10s} acc={r['acc'] * 100:6.2f}% "
              f"time={r['time_s']:7.1f}s "
              f"({r['time_s'] / base['time_s'] * 100:5.1f}%) "
              f"energy={r['energy_j']:7.1f}J "
              f"({r['energy_j'] / base['energy_j'] * 100:5.1f}%) "
              f"rounds={r['rounds']:.0f} tflops={r['tflops']:.3f}")
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
