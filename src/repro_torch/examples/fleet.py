"""DeviceFleet driver: run a workload across a simulated multi-device
fleet (DESIGN.md §13) and print per-device utilization, swap/sync counts
and the fleet-level accuracy. The counterpart of `examples/fleet.py`,
with the same flags and printed lines, plus `--use-pallas` and
`--device`: it runs on CUDA unless `--device` names another device.

A fleet session is the same declarative `RuntimeConfig` session as any
other — plus a device list (`--devices` heterogeneous edge devices with
deterministic speed/energy spread), a routing policy (`--routing static`
pins stream i to device i mod N; `least-loaded` packs streams onto
devices LPT-style by event count over device speed), and a federated
aggregation period (`--aggregate-every` timeline seconds: devices'
fine-tuned params merge as a rounds-weighted average, each participant
charged a cross-device sync). `--devices 1` degenerates to the classic
single-device run — bit-for-bit, which `tests/test_torch_fleet.py`
holds.

The default preset is `fleet` (hundreds of light camera streams, scaled
down here by --streams); any other preset works too:

    PYTHONPATH=src python -m repro_torch.examples.fleet --devices 4 \
        --streams 12
    PYTHONPATH=src python -m repro_torch.examples.fleet --devices 8 \
        --routing static --aggregate-every 50 --streams 24 --inferences 8
    PYTHONPATH=src python -m repro_torch.examples.fleet \
        --preset two-stream --devices 2
    PYTHONPATH=src python -m repro_torch.examples.fleet --devices 4 \
        --streams 12 --trace-out fleet_trace.json

`--trace-out` turns on telemetry (DESIGN.md §14): a Perfetto-loadable
Chrome trace with one track per device lane (the occupancy Gantt of
rounds, swaps and fleet syncs) and one per stream (request latency
spans); ``.jsonl`` paths get the raw event feed instead. Summarize with
`python -m repro_torch.harness.trace_report`.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.harness.workloads import METHODS, run_workload, trace_spec
from repro_torch.runtime import ROUTING_POLICIES, fleet_devices
from repro_torch.workloads import presets


def main(argv=None):
    names = sorted(presets())
    ap = argparse.ArgumentParser(
        description="Run a workload across a simulated DeviceFleet and "
                    "report per-device utilization and fleet-level "
                    "accuracy.")
    ap.add_argument("--preset", default="fleet", choices=names,
                    help="workload preset (default: the many-stream "
                         "fleet preset)")
    ap.add_argument("--devices", type=int, default=4,
                    help="fleet size; heterogeneous speed/energy scales "
                         "are drawn deterministically from the seed "
                         "(device 0 is always the 1.0x reference)")
    ap.add_argument("--routing", default="least-loaded",
                    choices=sorted(ROUTING_POLICIES),
                    help="initial stream->device placement policy")
    ap.add_argument("--aggregate-every", type=float, default=50.0,
                    help="federated merge period in timeline seconds "
                         "(0 = never aggregate; devices drift apart)")
    ap.add_argument("--method", default="etuner",
                    choices=list(METHODS) + ["egeria", "slimfit", "ekya"])
    ap.add_argument("--arch", default="mobilenetv2",
                    choices=["mobilenetv2", "resnet50", "deit-tiny"])
    ap.add_argument("--streams", type=int, default=8,
                    help="stream count of the 'fleet' preset (other "
                         "presets have a fixed stream mix)")
    ap.add_argument("--scenarios", type=int, default=2)
    ap.add_argument("--batches", type=int, default=4,
                    help="training batches per scenario per stream")
    ap.add_argument("--inferences", type=int, default=8,
                    help="inference requests per stream over the horizon")
    ap.add_argument("--speed-spread", type=float, default=0.4,
                    help="clone devices draw speed scales from 1 +- this")
    ap.add_argument("--energy-spread", type=float, default=0.2)
    ap.add_argument("--battery-j", type=float, default=0.0,
                    help="per-device battery capacity in joules "
                         "(DESIGN.md §15; 0 = mains power). Pairs with "
                         "--throttle battery so rounds defer instead of "
                         "overdrawing; a device draining to its reserve "
                         "anyway is evicted like a straggler")
    ap.add_argument("--thermal-cap", type=float, default=0.0,
                    help="DVFS thermal cap in deg C (0 = no governor): "
                         "devices at/above the cap step down the "
                         "frequency ladder — slower but cooler and "
                         "cheaper per unit work")
    ap.add_argument("--throttle", default="none",
                    choices=["none", "battery", "thermal"],
                    help="ThrottlePolicy facet for the paper methods' "
                         "policy stacks (DESIGN.md §15)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-compiled", dest="compiled", action="store_false",
                    help="pure-Python per-event fallback (bit-identical)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record the fleet's telemetry trace (DESIGN.md "
                         "§14) to PATH: a Perfetto-loadable Chrome trace "
                         "with one track per device and per stream, or "
                         "the JSONL event feed if PATH ends in '.jsonl'; "
                         "summarize with `python -m "
                         "repro_torch.harness.trace_report PATH`")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the models' and SimFreeze's kernels")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    scale = dict(batches_per_scenario=args.batches,
                 inferences=args.inferences,
                 num_scenarios=args.scenarios,
                 fleet_streams=args.streams)
    spec = presets(seed=args.seed, **scale)[args.preset]
    devices = fleet_devices(args.devices, seed=args.seed,
                            speed_spread=args.speed_spread,
                            energy_spread=args.energy_spread)
    print(f"workload {spec.name}: {len(spec.streams)} stream(s) over "
          f"{len(devices)} device(s), routing={args.routing}, "
          f"aggregate_every={args.aggregate_every:g}s, "
          f"method={args.method}")
    for d in devices:
        print(f"  {d.name}: speed x{d.speed_scale:.2f} "
              f"energy x{d.energy_scale:.2f}")
    cell = run_workload(args.arch, spec, args.method, seed=args.seed,
                        compiled=args.compiled, workload_scale=scale,
                        devices=devices, routing=args.routing,
                        aggregate_every=args.aggregate_every,
                        energy_budget_j=args.battery_j,
                        thermal_cap_c=args.thermal_cap,
                        throttle=args.throttle,
                        telemetry=trace_spec(args.trace_out),
                        use_pallas=args.use_pallas, device=device)
    print(f"{args.method:10s} fleet acc={cell['acc'] * 100:6.2f}% "
          f"time={cell['time_s']:7.1f}s energy={cell['energy_j']:7.1f}J "
          f"rounds={cell['rounds']} syncs={cell['syncs']} "
          f"events={cell['events']} (wall {cell['wall_s']:.0f}s)")
    for did, per in sorted(cell["per_device"].items()):
        print(f"  device {did:6s} util={per['utilization'] * 100:5.1f}% "
              f"acc={per['avg_inference_acc'] * 100:6.2f}% "
              f"streams={per['streams']:.0f} rounds={per['rounds']:.0f} "
              f"requests={per['inferences']:.0f} "
              f"swaps={per['swaps']:.0f} syncs={per['syncs']:.0f} "
              f"time={per['time_s']:6.1f}s energy={per['energy_j']:6.1f}J"
              + (f" throttled={per['throttle_s']:.0f}s"
                 if per.get("throttle_s") else "")
              + ("  [battery dead]" if per.get("battery_dead") else "")
              + ("  [evicted]" if per.get("evicted") else ""))
    if args.trace_out:
        print(f"trace written to {args.trace_out} — load at "
              f"https://ui.perfetto.dev or run "
              f"`python -m repro_torch.harness.trace_report "
              f"{args.trace_out}`")
    return cell


if __name__ == "__main__":
    main()
