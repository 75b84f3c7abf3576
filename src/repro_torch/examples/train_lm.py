"""End-to-end LM training script, the counterpart of
`examples/train_lm.py`: train a dense decoder LM for a few hundred steps
on synthetic next-token data with the full substrate — AdamW + cosine
schedule, the checkpoint manager (async, crash-safe), and SimFreeze
freezing groups mid-run (one step a plan, kept in a cache, as the
production path keeps its compiled steps).

The flags, defaults, presets and printed lines are the reference's. The
default preset is CPU-sized (1.5M params); --preset 100m builds a
larger model (same code path, heavier). It runs on CUDA unless --device
names another device:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

`PRESETS`, `OPT_CFG`, `WARMUP`, `synthetic_batch`, `half_prefix_plan`
and `make_step` are the pieces `main` runs, at module level for other
callers. Checkpoints go to `repro_torch_train_lm` under the temporary
directory (`TMPDIR`, else /tmp) unless --ckpt-dir names another. As in the
reference, the step passes no optimizer masks: a frozen leaf gets a zero
gradient, so AdamW's weight decay and leftover momentum still move it.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device, tree_leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.freeze_plan import FreezePlan
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.runtime.train_loop import grads_of

PRESETS = {
    "tiny": dict(num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=512, vocab_size=2048),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}
OPT_CFG = AdamWConfig(lr=3e-3)  # with cosine_schedule(step, WARMUP, steps)
WARMUP = 20


def preset_config(preset: str) -> ModelConfig:
    """The example's model config for `preset`."""
    return ModelConfig(name=f"train-lm-{preset}", family="dense",
                       remat="none", **PRESETS[preset])


def synthetic_batch(rng, vocab, batch, seq, device=None):
    """Markov-ish synthetic stream: next token correlated with current;
    int32 tokens and targets [batch, seq] on `device` (CUDA unless given),
    the reference's arrays for the same `rng`."""
    toks = rng.integers(0, vocab, (batch, seq + 1))
    toks[:, 1:] = (toks[:, :-1] * 31 + toks[:, 1:]) % vocab
    device = resolve_device(device)
    return {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32,
                                      device=device),
            "targets": torch.as_tensor(toks[:, 1:], dtype=torch.int32,
                                       device=device)}


def half_prefix_plan(num_groups: int) -> FreezePlan:
    """The plan `main` switches to at --freeze-at: the first half of
    the groups and the embedding frozen."""
    return FreezePlan(groups=tuple(i < num_groups // 2
                                   for i in range(num_groups)), embed=True)


def make_step(model, opt_cfg: AdamWConfig, plan):
    """The train step under `plan`: (params, opt_state, batch, lr_scale)
    -> (params, opt_state, loss), AdamW on the loss's gradients."""
    def train_step(params, opt_state, batch, lr_scale):
        loss, _, grads = grads_of(model.loss, params, batch, plan)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg,
                                         lr_scale=lr_scale)
        return params, opt_state, loss

    return train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--freeze-at", type=int, default=120,
                    help="step at which SimFreeze-style prefix freezing kicks in")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = preset_config(args.preset)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  groups={model.num_freeze_units}")

    opt_cfg = OPT_CFG
    opt_state = adamw_init(params, opt_cfg)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    # resume if a checkpoint exists (crash-safe restart path)
    restored, step0 = mgr.restore_latest((params, opt_state),
                                         device=model.device)
    if restored is not None:
        params, opt_state = restored
        print(f"resumed from step {step0}")
    step0 = max(step0, 0)

    step_cache = {}
    rng = np.random.default_rng(0)
    plan = None
    t0 = time.time()
    losses = []
    for step in range(step0, args.steps):
        if step == args.freeze_at:
            G = model.num_freeze_units
            plan = half_prefix_plan(G)
            print(f"step {step}: freezing prefix {G//2}/{G} groups + embed "
                  f"(recompile, cached)")
        key = plan
        if key not in step_cache:
            step_cache[key] = make_step(model, opt_cfg, plan)
        batch = synthetic_batch(rng, cfg.vocab_size, args.batch, args.seq,
                                model.device)
        lr = cosine_schedule(step, warmup=WARMUP, total=args.steps)
        params, opt_state, loss = step_cache[key](params, opt_state, batch, lr)
        losses.append(float(loss))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(loss):.4f} "
                  f"({(step - step0 + 1) / (time.time() - t0):.1f} it/s)")
        if step % 50 == 49:
            mgr.save(step, (params, opt_state))
    mgr.save(args.steps - 1, (params, opt_state), block=True)
    assert losses[-1] < losses[0], "training must reduce loss"
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
