"""Per-op microbenchmark of the port's hand-written kernels against their
plain PyTorch versions, the counterpart of `benchmarks/kernels_micro.py`
(schema v1).

Times each runtime-facing kernel — flash attention (the `use_pallas`
serving forward), the CKA ratio through the Gram-term kernel
(SimFreeze's drift metric) and the WKV6 recurrence — beside its plain
version on the same inputs, with CUDA events on the card, and records
the largest difference between the two. The inputs are the reference's
`_cases`: the same `default_rng(seed)` draws in the same order, at the
same shapes (flash at [8, 65, 3, 64], non-causal and ragged; CKA at
520 x 192, its feature route; WKV6 at [2, 128, 2, 64]).

The fields keep the reference's names, so its `validate_bench` reads
this document: `pallas_ms` holds the hand-written kernel's time and
`ref_ms` the plain version's, each the median of `iters` timed calls
after a warm-up call (the kernels' build included in that one). It needs
the card and raises on the CPU, which cannot run the kernels:

    PYTHONPATH=src python -m repro_torch.harness.kernels_micro [--iters 5]

Writes ``results_torch/BENCH_kernels_micro.json`` (or --out), never the
reference's file at the root.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.harness.common import RESULTS_DIR
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops
from repro_torch.kernels.rwkv import ops as wkv_ops

SCHEMA_VERSION = 1
DEFAULT_OUT = os.path.join(RESULTS_DIR, "BENCH_kernels_micro.json")

#: Numeric fields every cell must carry (schema contract with CI).
CELL_FIELDS = ("pallas_ms", "ref_ms", "max_abs_err", "iters")


def _time(fn: Callable, iters: int) -> float:
    """Median ms per call on the card (CUDA events around each call),
    after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def case_inputs(seed: int) -> Dict[str, tuple]:
    """The reference's `_cases` arrays, drawn in its order: q, k, v; x, y;
    r, k, v, logw, u."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    att = (f32(8, 65, 3, 64), f32(8, 65, 3, 64), f32(8, 65, 3, 64))
    cka = (f32(520, 192), f32(520, 192))
    r, kk, vv = f32(2, 128, 2, 64), f32(2, 128, 2, 64), f32(2, 128, 2, 64)
    logw = -np.exp(f32(2, 128, 2, 64) * 0.1).astype(np.float32)
    return {"flash_attention": att, "cka": cka,
            "rwkv_wkv": (r, kk, vv, logw, f32(2, 64))}


def cka_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The CKA ratio of `cka_ops.cka` by the plain Gram terms."""
    hsic, kk, ll = cka_ops.cka_terms_plain(cka_ops._prepare(x),
                                           cka_ops._prepare(y))
    return hsic / torch.clamp(torch.sqrt(kk) * torch.sqrt(ll), min=1e-12)


def _cases(seed: int, device) -> List[Dict]:
    t = {op: [torch.from_numpy(a).to(device) for a in arrays]
         for op, arrays in case_inputs(seed).items()}
    q, k, v = t["flash_attention"]
    x, y = t["cka"]
    wkv_in = t["rwkv_wkv"]
    return [
        dict(op="flash_attention", shape="B8xS65xH3xhd64 causal=False",
             kernel=lambda: att_ops.flash_attention(q, k, v, causal=False),
             plain=lambda: att_ops.attention_plain(q, k, v, causal=False)),
        dict(op="cka", shape="520x192",
             kernel=lambda: cka_ops.cka(x, y),
             plain=lambda: cka_plain(x, y)),
        dict(op="rwkv_wkv", shape="B2xT128xH2xhd64",
             kernel=lambda: wkv_ops.wkv(*wkv_in),
             plain=lambda: wkv_ops.wkv_plain(*wkv_in)[0]),
    ]


def run(iters: int = 5, seed: int = 0, device=None) -> Dict:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("kernels_micro times the hand-written CUDA "
                           "kernels, which run on the card only")
    cells = []
    with torch.no_grad():
        for case in _cases(seed, device):
            err = float((case["kernel"]() - case["plain"]()).abs().max())
            cell = {"op": case["op"], "shape": case["shape"],
                    "pallas_ms": round(_time(case["kernel"], iters), 4),
                    "ref_ms": round(_time(case["plain"], iters), 4),
                    "max_abs_err": err, "iters": iters}
            cells.append(cell)
            print(f"kernels_micro,{cell['op']},{cell['shape']},"
                  f"kernel={cell['pallas_ms']}ms plain={cell['ref_ms']}ms "
                  f"err={err:.2e}", flush=True)
    return {
        "schema_version": SCHEMA_VERSION, "suite": "kernels_micro",
        "seed": seed, "created_unix": int(time.time()),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": torch.cuda.get_device_name(device),
        "interpret": False, "cells": cells,
    }


def validate_bench(doc: Dict) -> List[str]:
    """Return a list of schema violations (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"schema_version != {SCHEMA_VERSION}")
    if doc.get("suite") != "kernels_micro":
        errors.append("suite != 'kernels_micro'")
    cells = doc.get("cells") or []
    if not isinstance(cells, list) or len(cells) < 3:
        errors.append("cells must list at least the 3 kernel ops")
        return errors
    for i, cell in enumerate(cells):
        if not cell.get("op") or not cell.get("shape"):
            errors.append(f"cell {i}: missing op/shape")
        for f in CELL_FIELDS:
            v = cell.get(f)
            if not isinstance(v, (int, float)) or v != v or v < 0:
                errors.append(f"cell {i}: field {f!r} missing or not a "
                              f"non-negative finite number (got {v!r})")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--validate", metavar="PATH",
                    help="validate an existing artifact and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; the CPU raises)")
    args = ap.parse_args(argv)

    if args.validate:
        with open(args.validate) as f:
            errors = validate_bench(json.load(f))
        for e in errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        print(f"{args.validate}: " +
              ("INVALID" if errors else "schema valid"))
        return 1 if errors else 0

    from repro_torch.launch.platform import bootstrap

    doc = run(iters=args.iters, seed=args.seed,
              device=bootstrap(args.device))
    errors = validate_bench(doc)
    if errors:
        for e in errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {args.out}: {len(doc['cells'])} kernel cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
