"""Tables harness on the port (counterpart of `benchmarks/run.py`): one
function per paper table or figure. Prints ``name,case,derived`` CSV rows
and writes JSON to `results_torch/`.

Quick mode (default) uses one seed and the lighter model/benchmark pairs;
`--full` widens models, seeds and benchmarks. All time and energy figures
come from the calibrated `EdgeCostModel` over the port's train-step FLOP
counts. `roofline_table` is not here: it formats the distributed dry
run's output, which waits for the port of `roofline/` (ROADMAP A.9).

    python -m repro_torch.harness.run --only tab2 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.harness import common as C


def tab2_accuracy(full: bool, device=None):
    """Table II: avg inference accuracy of Immed/LazyTune/SimFreeze/ETuner
    across CL benchmarks. Also feeds Figs. 8-9 (time/energy, normalized)."""
    archs = ["mobilenetv2", "resnet50", "deit-tiny"] if full \
        else ["mobilenetv2"]
    benches = ["nc", "nic", "s-cifar"] if full else ["nc", "s-cifar"]
    seeds = (0, 1, 2) if full else (0,)
    rows = []
    for arch in archs:
        for bench in benches:
            base = None
            for method in ("immed", "lazytune", "simfreeze", "etuner"):
                r = C.run_method(arch, bench, method, seeds=seeds,
                                 device=device)
                if method == "immed":
                    base = r
                r["time_norm"] = r["time_s"] / base["time_s"]
                r["energy_norm"] = r["energy_j"] / base["energy_j"]
                r["acc_delta_pp"] = 100 * (r["acc"] - base["acc"])
                rows.append(r)
    C.save_rows("tab2_accuracy_fig8_9", rows)
    C.print_csv("tab2/fig8-9", rows,
                keys=("acc", "time_norm", "energy_norm", "acc_delta_pp"))
    return rows


def tab3_flops(full: bool, device=None):
    """Table III: computation (TFLOPs) over the whole CL process."""
    rows = []
    for arch in (["mobilenetv2", "resnet50"] if full else ["mobilenetv2"]):
        for method in ("immed", "etuner"):
            r = C.run_method(arch, "nc", method, device=device)
            rows.append(r)
    C.save_rows("tab3_flops", rows)
    C.print_csv("tab3", rows, keys=("tflops", "rounds"))
    return rows


def tab4_nlp(full: bool, device=None):
    """Table IV: NLP workload (BERT / 20News-style)."""
    rows = []
    for method in ("immed", "lazytune", "simfreeze", "etuner"):
        rows.append(C.run_method("bert-base", "20news", method,
                                 scenarios=4, batches=8, device=device))
    C.save_rows("tab4_nlp", rows)
    C.print_csv("tab4", rows)
    return rows


def tab5_sota(full: bool, device=None):
    """Table V: SOTA methods, all with LazyTune integrated (as the paper
    does), vs ETuner."""
    rows = []
    methods = ("lazytune", "egeria", "slimfit", "rigl", "ekya", "etuner")
    for bench in (["nc", "nic"] if full else ["nc"]):
        for m in methods:
            rows.append(C.run_method("mobilenetv2", bench, m, device=device))
    C.save_rows("tab5_sota", rows)
    C.print_csv("tab5", rows, keys=("acc", "energy_j"))
    return rows


def tab6_semi(full: bool, device=None):
    """Table VI: semi-supervised (10% labeled) — SimSiam on unlabeled."""
    rows = []
    for method in ("immed", "etuner"):
        rows.append(C.run_method("mobilenetv2", "nc", method, unlabeled=0.9,
                                 device=device))
    C.save_rows("tab6_semi", rows)
    C.print_csv("tab6", rows)
    return rows


def tab7_static(full: bool, device=None):
    """Table VII: static lazy strategies S1..S4 vs LazyTune."""
    rows = []
    for method in ("immed", "static2", "static4", "static8", "lazytune"):
        rows.append(C.run_method("mobilenetv2", "nc", method, device=device))
    C.save_rows("tab7_static", rows)
    C.print_csv("tab7", rows, keys=("acc", "energy_j", "rounds"))
    return rows


def tab8_quant(full: bool, device=None):
    """Table VIII: compatibility with int8 quantization-aware training."""
    rows = []
    for bits in (0, 8):
        for method in ("immed", "etuner"):
            r = C.run_method("mobilenetv2", "nc", method, quant_bits=bits,
                             device=device)
            r["bits"] = bits or 32
            rows.append(r)
    C.save_rows("tab8_quant", rows)
    C.print_csv("tab8", rows, keys=("acc", "bits"))
    return rows


def fig13_14_sensitivity(full: bool, device=None):
    """Figs. 13-14: #inference requests + arrival-distribution sensitivity."""
    rows = []
    for n in ([10, 30, 60] if full else [10, 30]):
        for method in ("immed", "etuner"):
            r = C.run_method("mobilenetv2", "nc", method, inferences=n,
                             device=device)
            r["inferences"] = n
            rows.append(r)
    for dist in ("uniform", "normal", "trace"):
        for method in ("immed", "etuner"):
            r = C.run_method("mobilenetv2", "nc", method, data_dist=dist,
                             inf_dist=dist, device=device)
            r["dist"] = dist
            rows.append(r)
    C.save_rows("fig13_14_sensitivity", rows)
    C.print_csv("fig13-14", rows, keys=("acc", "energy_j"))
    return rows


TABLES = {
    "tab2": tab2_accuracy, "tab3": tab3_flops, "tab4": tab4_nlp,
    "tab5": tab5_sota, "tab6": tab6_semi, "tab7": tab7_static,
    "tab8": tab8_quant, "fig13": fig13_14_sensitivity,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    names = [n for n in args.only.split(",") if n] or list(TABLES)
    for name in names:
        print(f"# === {name} ===", flush=True)
        try:
            TABLES[name](args.full, device=device)
        except Exception as e:  # keep the suite going; report at the end
            print(f"{name},ERROR,{type(e).__name__}: {e}", flush=True)
    print(f"# total wall: {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
