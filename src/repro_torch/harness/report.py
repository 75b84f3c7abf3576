"""The dry run's tables from its JSON records (counterpart of
`benchmarks/report.py`): a summary line and the roofline table of one
mesh, read from `results_torch/dryrun/` (`launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.harness.report [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR


def load(mesh: str, tag: str = ""):
    suffix = f"_{tag}" if tag else ""
    pat = os.path.join(RESULTS_DIR, f"*__{mesh}{suffix}.json")
    out = []
    for p in sorted(glob.glob(pat)):
        name = os.path.basename(p)[:-5]
        parts = name.split("__")
        if (tag and not name.endswith(suffix)) or (not tag and len(parts) > 3):
            continue
        with open(p) as f:
            try:
                out.append(json.load(f))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"malformed dry-run record {p}: {e}") from e
    return out


def fmt_bytes(b):
    if b >= 1e12:
        return f"{b/1e12:.2f}TB"
    if b >= 1e9:
        return f"{b/1e9:.2f}GB"
    return f"{b/1e6:.1f}MB"


ARCH_ORDER = ["qwen2-vl-72b", "jamba-1.5-large-398b", "gemma2-2b",
              "granite-20b", "gemma2-27b", "qwen1.5-32b", "rwkv6-3b",
              "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "musicgen-medium"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def roofline_markdown(mesh: str = "single", tag: str = "") -> str:
    rows = load(mesh, tag)
    idx = {(r["arch"], r["shape"]): r for r in rows}
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPs/HLO | roofline frac | HBM/chip (args+temp) | status |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = idx.get((arch, shape))
            if r is None:
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"- | MISSING |")
                continue
            if r["status"] == "skip":
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"- | SKIP (full attention @500k) |")
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                             f"- | ERROR {r.get('error','')[:40]} |")
                continue
            mem = r.get("memory_per_chip", {})
            hbm = fmt_bytes(mem.get("argument", 0) + mem.get("temp", 0))
            lines.append(
                f"| {arch} | {shape} | {r['compute_s']:.3g} "
                f"| {r['memory_s']:.3g} "
                f"| {r['collective_s']:.3g} | **{r['dominant']}** "
                f"| {r['flops_ratio']:.3f} | {r['roofline_fraction']:.4f} "
                f"| {hbm} | ok ({r.get('compile_s','?')}s compile) |")
    return "\n".join(lines)


def dryrun_summary(mesh: str) -> str:
    rows = load(mesh)
    ok = sum(r["status"] == "ok" for r in rows)
    skip = sum(r["status"] == "skip" for r in rows)
    err = sum(r["status"] not in ("ok", "skip") for r in rows)
    return f"{mesh}: {ok} compiled, {skip} skipped (documented), {err} errors"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(dryrun_summary(args.mesh))
    print()
    print(roofline_markdown(args.mesh, args.tag))


if __name__ == "__main__":
    main()
