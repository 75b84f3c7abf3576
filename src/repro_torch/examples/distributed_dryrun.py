"""Count one (arch x shape) cell's step on the production mesh and print
its roofline terms — a thin, readable wrapper over
`repro_torch.launch.dryrun` (fake tensors and a fake process group:
nothing is allocated, no card is needed).

    PYTHONPATH=src python -m repro_torch.examples.distributed_dryrun \\
        --arch gemma2-2b --shape train_4k --mesh single
"""
import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell

    record = run_cell(args.arch, args.shape, args.mesh)
    print(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
