"""Multi-stream workload driver: run one workload preset (multi-stream /
bursty MMPP / diurnal+duty-cycle / mixed / qos — see
repro_torch.workloads.presets) against a chosen controller and print the
global, per-stream and per-model outcome (accuracy, modeled time/energy,
rounds — the CostLedger attributes every charge both to the arrival
stream whose batches the round trained and to the model slot that
executed it). The counterpart of `examples/multi_stream.py`, with the
same flags and printed lines, plus `--device`: it runs on CUDA unless
`--device` names another device.

Sessions are built through the declarative `RuntimeConfig` API
(`repro_torch.harness.workloads.workload_config` -> `edgeol_session`;
DESIGN.md §11). The `mixed` preset is a true mixed-modality run: its NLP
stream binds to a real BERT/20news model slot in a ModelPool, sharing
the device with the CV slot; `--memory-budget` caps device memory (MB) so a
budget smaller than the resident set forces cold-slot swap charges. The
`qos` preset pairs a latency-critical stream with a bulk stream:
`--preemptible` lets its arrivals split in-flight rounds, and
`--trigger-policy priority-weighted` scales LazyTune's accumulation
target by stream priority (BENCH v4).

Runs execute on the compiled hot path by default (DESIGN.md §12):
homogeneous event segments train as one masked loop, replayed from a
CUDA graph on the card. `--no-compiled` selects the per-event path
(bit-identical results, just slower); `--use-pallas` additionally routes
attention forwards and the CKA drift probe through the port's kernels
(their plain versions on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.multi_stream \
        --preset two-stream --method etuner --batches 6 --inferences 16 \
        --scenarios 3
    PYTHONPATH=src python -m repro_torch.examples.multi_stream \
        --preset mixed --memory-budget 2.5
    PYTHONPATH=src python -m repro_torch.examples.multi_stream \
        --preset qos --preemptible --trigger-policy priority-weighted
    PYTHONPATH=src python -m repro_torch.examples.multi_stream \
        --arch deit-tiny --use-pallas
    PYTHONPATH=src python -m repro_torch.examples.multi_stream \
        --preset qos --preemptible --trace-out qos_trace.json

`--trace-out` turns on telemetry (DESIGN.md §14): the run records every
round/segment/swap/serve/publish on the modeled timeline and writes a
Perfetto-loadable Chrome trace (or a JSONL event feed when the path ends
in ``.jsonl``); summarize it with
`python -m repro_torch.harness.trace_report`.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.harness.workloads import METHODS, run_workload, trace_spec
from repro_torch.workloads import presets


def main(argv=None):
    names = sorted(presets())
    ap = argparse.ArgumentParser(
        description="Run one workload preset through the declarative "
                    "EdgeOL session API and report per-stream/per-model "
                    "attribution.")
    ap.add_argument("--preset", "--workload", dest="preset",
                    default="two-stream", choices=names,
                    help="workload preset (--workload is a legacy alias)")
    ap.add_argument("--method", default="etuner",
                    choices=list(METHODS) + ["egeria", "slimfit", "ekya"],
                    help="paper methods run as declarative policy stacks; "
                         "the SOTA baselines inject monolithic controllers")
    ap.add_argument("--arch", default="mobilenetv2",
                    choices=["mobilenetv2", "resnet50", "deit-tiny"],
                    help="model for 'cv' streams (an 'nlp' stream always "
                         "gets the BERT slot)")
    ap.add_argument("--scenarios", type=int, default=3)
    ap.add_argument("--batches", type=int, default=6,
                    help="training batches per scenario per stream")
    ap.add_argument("--inferences", type=int, default=16,
                    help="inference requests per stream over the horizon")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preemptible", action="store_true",
                    help="QoS: let higher-priority inference arrivals "
                         "split in-flight fine-tuning rounds (try with "
                         "--preset qos)")
    ap.add_argument("--trigger-policy", default="default",
                    choices=["default", "priority-weighted"],
                    help="priority-weighted scales LazyTune's accumulation "
                         "target by StreamSpec.priority (paper methods "
                         "with LazyTune only; try with --preset qos)")
    ap.add_argument("--memory-budget", type=float, default=0.0,
                    help="ModelPool device memory budget in MB (0 = "
                         "unlimited); only multi-modality workloads "
                         "(mixed) swap — try 2.5 to force it")
    ap.add_argument("--no-compiled", dest="compiled", action="store_false",
                    help="use the pure-Python per-event fallback instead "
                         "of the segment-batched compiled hot path "
                         "(bit-identical results; DESIGN.md §12)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="route attention forwards and the CKA drift "
                         "probe through the port's kernels (their plain "
                         "versions on the CPU)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record the run's telemetry trace (DESIGN.md "
                         "§14) to PATH: a Perfetto-loadable Chrome trace, "
                         "or the JSONL event feed if PATH ends in "
                         "'.jsonl'; summarize with `python -m "
                         "repro_torch.harness.trace_report PATH`")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = presets(batches_per_scenario=args.batches,
                   inferences=args.inferences,
                   num_scenarios=args.scenarios,
                   seed=args.seed)[args.preset]
    print(f"workload {spec.name}: {len(spec.streams)} stream(s), "
          f"{len(spec.modalities)} model slot(s) {spec.modalities}, "
          f"{spec.num_scenarios} scenarios, drift={spec.drift}, "
          f"preemptible={args.preemptible}, "
          f"trigger={args.trigger_policy}")
    cell = run_workload(args.arch, spec, args.method, seed=args.seed,
                        preemptible=args.preemptible,
                        memory_budget_mb=args.memory_budget,
                        trigger_policy=args.trigger_policy,
                        compiled=args.compiled,
                        use_pallas=args.use_pallas,
                        workload_scale=dict(
                            batches_per_scenario=args.batches,
                            inferences=args.inferences,
                            num_scenarios=args.scenarios),
                        telemetry=trace_spec(args.trace_out),
                        device=device)
    print(f"{args.method:10s} acc={cell['acc']* 100:6.2f}% "
          f"time={cell['time_s']:7.1f}s energy={cell['energy_j']:7.1f}J "
          f"rounds={cell['rounds']} events={cell['events']} "
          f"preemptions={cell['preemptions']} swaps={cell['swaps']} "
          f"(wall {cell['wall_s']:.0f}s)")
    for sid, per in sorted(cell["per_stream"].items()):
        ss = spec.streams[int(sid)]
        print(f"  stream {sid} [{ss.modality}/{ss.benchmark} "
              f"data={ss.data_dist} inf={ss.inf_dist} prio={ss.priority}] "
              f"acc={per['avg_inference_acc']* 100:6.2f}% "
              f"time={per['time_s']:6.1f}s energy={per['energy_j']:6.1f}J "
              f"rounds={per['rounds']:.0f} requests={per['inferences']:.0f} "
              f"p50={per['latency_p50']:.2f}s p95={per['latency_p95']:.2f}s")
    for mid, per in sorted(cell["per_model"].items()):
        print(f"  model  {mid:7s} acc={per['avg_inference_acc']* 100:6.2f}% "
              f"time={per['time_s']:6.1f}s energy={per['energy_j']:6.1f}J "
              f"rounds={per['rounds']:.0f} requests={per['inferences']:.0f} "
              f"swaps={per['swaps']:.0f}")
    if args.trace_out:
        print(f"trace written to {args.trace_out} — load at "
              f"https://ui.perfetto.dev or run "
              f"`python -m repro_torch.harness.trace_report "
              f"{args.trace_out}`")
    return cell


if __name__ == "__main__":
    main()
