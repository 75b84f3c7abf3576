"""Serve a small LM with batched requests through the prefill/decode engine
(the inference half of the continual-learning loop); the counterpart of
`examples/serve_lm.py`, with the same flags, defaults and printed lines.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma2-2b --batch 4

It serves all ten reduced LM architectures (`--arch`, as the
reference's), and runs on CUDA unless `--device` names another device
(`--device cpu`).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.models import build_model
from repro_torch.runtime.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, max_len=args.prompt_len + args.steps + 8)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.time()
    out = engine.generate(params, prompts, steps=args.steps)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} prefill={args.prompt_len} "
          f"decode={args.steps}")
    print(f"generated ids[0]: {out[0].tolist()}")
    print(f"wall={dt:.2f}s  ({args.batch * args.steps / dt:.1f} tok/s total; "
          f"stats={engine.stats})")


if __name__ == "__main__":
    main()
