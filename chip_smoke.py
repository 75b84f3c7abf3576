#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # and phase 5 as well

It imports nothing of JAX and nothing of the JAX package, and fails
(non-zero exit, no result line) on the first mismatch. In order:

1. card and software: the card's name, power limit and driver, torch and
   CUDA versions; builds the three CUDA kernels from `src/repro_torch/csrc`
   (one nvcc process each, started together), prints the build time and
   which CUDA runtime libraries the process has mapped;
2. kernel phase: each kernel against its plain PyTorch version on the
   card, at the main-path shapes and at ragged, masked, GQA and head-dim
   variants; CKA through both routes (feature and example form) at every
   shape (the CNN probe shapes, n = 16 and d up to 262144, through the
   example route only, and against float64), with the route the wrapper
   took printed and held to its rule,
   including shapes on the route boundary, with a ragged last row split
   and with the X/Y column boundary inside a tile (`RAGGED`); the example
   route at n on both sides of its 16-row tiles, dx != dy, dy = 1,
   d % 4 != 0, rows that are not 16-byte aligned and raw inputs whose
   columns carry offsets of 1e3-2e3 (which it centers itself where n <= 16)
   (`EXAMPLE_SHAPES`); the feature route's
   3xTF32 products against float64 on inputs one TF32 product cannot hold;
   CKA(x, x) = 1; WKV6 under two decay draws, the model's init range and
   logw = -exp(U(-8, 2)) (where a factorization exp(c_t) exp(-c_s) from
   a chunk's start overflows), at the main shape, at T = 1, ragged T, T
   at and one past a boundary of the kernel's 8-token tiles, with s0, and
   at head sizes 16, 32 and 64; and two launches that agree bit for bit
   for flash attention, both CKA routes (the example route also at
   n = 16, d = 131072 and 262144) and WKV6 (at 4 prompts and at one);
3. slice phase at full width: DeiT-tiny (`get_config("deit-tiny")`,
   224x224, 12 layers, d=192) with params from a seeded
   `torch.Generator`, serving every inference event of a
   `build_timeline` through `InferenceServer` and running SimFreeze's CKA
   probe on every data event under `EventScheduler`, with the kernels and
   again with the plain paths (`use_pallas`/`use_kernel` off); the two
   runs must give the same accuracies, freeze plans and CKA FLOPs, logits
   and CKA histories within the kernel tolerances, and the kernel run must
   have launched both kernels the expected number of times, CKA on the
   feature route only. Once more
   with coalesced serving (`batch_window` > 0): the same accuracies;
   then the ETuner loop on the same model, data and timeline through the
   port's front door, `ContinualRuntime.from_config(RuntimeConfig(...),
   model=<full-width DeiT-tiny>, benchmark=...).run(events)`: one
   pretraining epoch on scenario 0, then fine-tuning rounds that
   LazyTune triggers (`max_batches_needed=6`) under SimFreeze's freeze
   plans (`freeze_interval=3`, threshold 0.01), energy-score detection,
   oracle boundaries, AdamW at lr 1e-3 with two replay batches, serving
   every request, with the kernels (`use_pallas`), with the plain paths,
   and with the kernels again (bit for bit the first; the first run of a
   process pays the card's first calls, so the times printed are the
   later runs'): the runs must give the same rounds, recompiles,
   controller stats, freeze plans, validation curve and accuracies,
   logits within attention's tolerance and bitwise equal final params;
   the kernel run must launch flash attention 12 times a predict or
   features call, CKA 13 times a probe pass, and no kernel inside a train
   step. It prints each plan's train-step time (CUDA events around the
   runtime's `TrainStepCache` steps), its FLOPs (`FlopCounterMode`) and
   their ratio to the all-active plan, and the loop's wall time and
   rounds per second; then one more kernel run with detector boundaries
   and preemptible rounds, which prints its rounds, probes and
   preemptions;
   then the same ETuner loop on the CNNs at full width
   (`cnn_loop_phase`): MobileNetV2 (`get_config("mobilenetv2")`,
   128x128, width 1.0, 20 freeze units) with the kernels, plain and with
   the kernels again, and ResNet50 (18 freeze units) with the kernels and
   plain, on 50 classes of the same `nc_benchmark` and timeline at
   128x128. The runs must agree exactly: rounds, recompiles, controller
   stats, plans, validation curve, accuracies, and served logits and
   final params bit for bit; CKA launches once a feature map of a probe
   pass (19 for MobileNetV2, 17 for ResNet50: n = 16 examples of d = H*W*C
   from 2560 to 262144), all on the example route, none inside a train
   step. It prints the same step times, FLOP ratios and rounds per second
   as the DeiT loop. Then the reference's `semi_quant` session on
   MobileNetV2 (`hooks_phase`: immediate rounds, fake-quant 8 bits,
   SimSiam on half the batches), once: rounds, SimSiam updates, accuracy;
   then the compiled hot path (`compiled_phase`): DeiT-tiny (flash
   attention on) on the `single-poisson` and preemptible `qos` workload
   presets and MobileNetV2 on `single-poisson`, through
   `ContinualRuntime.from_config(RuntimeConfig(workload=...,
   compiled=...))` at the loops' size (3 scenarios of 6 batches of 16,
   48 requests a stream, benchmarks injected at the model's image size),
   each run compiled (train steps and pretraining replayed as CUDA
   graphs, serving drained as graphs, probes' forwards graphed), compiled
   with `segment=False`, eager, and compiled again (warm): all four must
   agree exactly (rounds, plans, recompiles, preemptions, accuracies,
   validation curve, ledger totals) with bitwise equal final params. It
   prints the flash launches the card ran inside graphs (captures x
   replays: the wrappers' counts do not see a replay) beside CKA's
   (eager), each plan's ms a graph step and a batch against the eager
   step, rounds/s and peak memory of each run, and, under torch.profiler,
   host launch calls a train step (eager against a bucket-8 replay) and
   the flash and CKA kernels one graphed predict and one probe pass ran;
   then rwkv6-3b serving at full width and depth (`get_config("rwkv6-3b")`,
   32 layers, d=2560, bf16, 3.07e9 params from a seeded CUDA generator):
   `ServeEngine.generate` on 4 prompts of 512 tokens for 16 greedy steps,
   with the WKV6 kernel (`use_pallas`, 32 launches per prefill), timed,
   and with the chunked closed form at chunk 32. The same pair runs again
   in fp32 (12.3 GB): there its prefill logits must agree within 1e-3,
   its tokens wherever the plain run's top-two margin exceeds 6e-2, and
   a prefill of 511 tokens plus a decode of the 512th must match the
   512-token prefill within 1e-3. The bf16 differences are printed, not
   held: they exceed the 3e-2 limit (`rwkv_phase` says why);
4. timing: each kernel, its plain version and (attention) PyTorch's
   `scaled_dot_product_attention` at the main-path shapes, with CUDA
   events around eager calls after a warm-up (`ms`) and from CUDA graphs
   (`device_ms`, the card's own time), beside two bounds the card's
   published peaks set for the least work the function needs: on the
   fp32 CUDA cores, and as 3xTF32 on the tensor cores (`bound`); CKA
   through both routes, and its example route at the CNN probe shapes on
   raw maps (`cnn_cka_timing`: one launch at MobileNetV2's stem map,
   n = 16, d = 131072, and whole MobileNetV2 and ResNet50 probe passes of
   19 and 17 launches) as its kernels, as the wrapper the loop calls and
   as the plain version, eager and on the card, with the card's time in
   each of its three passes (gram, fold, sum) from torch.profiler,
   against the bound of each input read once, and one
   `core.cka.cka(use_kernel=True)` call at the stem, which centers in
   torch before the wrapper; for CKA also the feature form
   that `core/cka.py` takes without the kernel, for WKV6 also the chunked
   form at chunk 32 and, under torch.profiler, the card's time in each of
   its two passes (the decay pass and the scan); the DeiT-tiny
   slice's requests per second and rwkv6-3b's prefill and decode tokens
   per second;
5. only with --profile: one more kernel run of each slice under
   torch.profiler (the DeiT-tiny slice, the ETuner loops on DeiT-tiny and
   MobileNetV2, the DeiT-tiny `single-poisson` session compiled, its
   graphs captured, and eager, one rwkv6-3b `generate`), for
   the device's busy share of its wall time, the kernels that fill it
   and the port's kernels' share of it, one SDPA call at the flash
   main-path shape, for the name of the kernel PyTorch runs there, and
   the cost of deterministic cuDNN:
   a full-width CNN train step with `resolve_device`'s deterministic
   algorithms and with cuDNN's default ones, in turns.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. A kernel's `launches` there is the
count of its newest path (CKA: the MobileNetV2 loop; flash attention: the
DeiT-tiny loop; WKV6: rwkv6-3b serving), and `launches_by_path` has every
path's count. CKA's times there are those of that path, a launch's mean
over a MobileNetV2 probe pass (with the pass, the stem launch and
ResNet50's pass in full); its DeiT-tiny feature-route numbers are under
`feature_route`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cka import cka as core_cka  # noqa: E402
from repro_torch.core.cka import cka_feature_form  # noqa: E402
from repro_torch.core.freeze_plan import LayerFreezePlan  # noqa: E402
from repro_torch.core.policies import etuner_stack_spec  # noqa: E402
from repro_torch.core.simfreeze import SimFreeze, SimFreezeConfig  # noqa: E402
from repro_torch.data.arrivals import build_timeline  # noqa: E402
from repro_torch.data.streams import REGISTRY, nc_benchmark  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention import ops as att_ops  # noqa: E402
from repro_torch.kernels.cka import ops as cka_ops  # noqa: E402
from repro_torch.kernels.rwkv import ops as wkv_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import fleet as fleet_mod  # noqa: E402
from repro_torch.runtime.config import (  # noqa: E402
    HookSpec, RuntimeConfig, SlotConfig)
from repro_torch.runtime.continual import ContinualRuntime  # noqa: E402
from repro_torch.runtime.costmodel import EdgeCostModel  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.executor import (  # noqa: E402
    FineTuneExecutor, SimSiamHook)
from repro_torch.runtime.inference import InferenceServer  # noqa: E402
from repro_torch.runtime.ledger import CostLedger  # noqa: E402
from repro_torch.runtime.scheduler import EventScheduler  # noqa: E402
from repro_torch.runtime.serve import ServeEngine  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainStepCache, as_tensor, compiled_model, make_optimizer_state)
from repro_torch.workloads import presets  # noqa: E402

# kernel tolerances, as tests/test_kernels.py holds the Pallas kernels
ATT_RTOL, ATT_ATOL = 2e-4, 2e-5
CKA_RTOL = 1e-4
# the CKA feature route against float64 on entries +-(1 + 2^-12): one TF32
# product is off by ~1e-3 there (check_cka_precision), 3xTF32 must not be
TF32X3_RTOL = 1e-5
CKA_HISTORY_ATOL = 1e-4
WKV_RTOL = WKV_ATOL = 1e-4
# rwkv6-3b logits: the JAX package's prefill/decode tolerance in bf16
# (tests/test_models.py:83-84)
LM_TOL = 3e-2
# generated tokens must agree where the plain run's top-two logit margin
# exceeds this
MARGIN = 6e-2
KERNELS = ("flash_attention", "cka_terms", "wkv6")
# the CUDA kernels of those sources, as the profiler names them
PORT_KERNELS = ("flash_fwd_kernel", "cka_gram_kernel", "cka_fold_kernel",
                "cka_sum_kernel", "cka_example_gram_kernel",
                "cka_example_fold_kernel", "wkv6_decay_kernel",
                "wkv6_scan_kernel")
# the passes of one CKA example-route launch, as the profiler names them
EXAMPLE_PASSES = ("cka_example_gram_kernel", "cka_example_fold_kernel",
                  "cka_sum_kernel")
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 on the CUDA
# cores, dense TF32 on the tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# main-path shapes: DeiT-tiny at 224x224 (197 tokens, 3 heads of 64) on a
# 16-image batch; the CKA probe flattens [16, 197, 192] to 3152 x 192
MAIN_ATT = (16, 197, 3, 64)
MAIN_CKA = (16 * 197, 192)
# rwkv6-3b prefill: 4 prompts of 512 tokens, 40 heads of 64
MAIN_WKV = (4, 512, 40, 64)
DECODE_STEPS = 16
# the rwkv6-3b kernel/plain pair and prefill/decode check, run in fp32
# (rwkv_phase says why)
PAIR_TOL = 1e-3
THRESHOLD = 0.01
INFER_BATCH = 16
# a CNN probe: 16 images, each feature map flattened to d = H*W*C (NHWC),
# d >> 16, so every CNN probe takes CKA's example route. MobileNetV2's
# stem map at 128x128 is 64*64*32 = 131072
CNN_PROBE = 16
MBV2_STEM_D = 64 * 64 * 32
# CKA shapes through both routes: ragged row splits and column tiles, the
# route boundary, the X/Y boundary inside a tile
RAGGED = ((200, 300, 300), (520, 192, 192), (100, 1000, 1000),
          (300, 192, 100),
          (192, 192, 192),   # n = d: the example route
          (384, 192, 192),   # n = dx + dy: the feature route
          (3153, 192, 192),  # a ragged last row split
          (300, 200, 100))   # dx + dy = n; X/Y boundary in a tile
# the example route around its 16-row tiles and 16-byte loads: n at and
# past a tile, dx != dy, dy = 1, d % 4 != 0
EXAMPLE_SHAPES = ((1, 2560, 2560), (13, 2560, 2560), (16, 2560, 2560),
                  (17, 2560, 2560), (40, 2560, 2560), (64, 2560, 2560),
                  (65, 2560, 2560), (16, 4096, 2560), (40, 1000, 300),
                  (16, 5000, 1), (16, 131071, 131071), (17, 999, 1001))


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mapped_cudart() -> list:
    """The CUDA runtime libraries mapped into this process: one, torch's,
    when the kernels' libraries share it."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "libcudart" in line.split()[-1]})


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_attention(gen, B, S, Hq, Hkv, hd, *, causal=False, window=0,
                    softcap=0.0) -> float:
    """The wrapper against the plain version; returns its max_abs_err."""
    q = torch.randn((B, S, Hq, hd), generator=gen).cuda()
    k = torch.randn((B, S, Hkv, hd), generator=gen).cuda()
    v = torch.randn((B, S, Hkv, hd), generator=gen).cuda()
    want = att_ops.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    got = att_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=ATT_RTOL, atol=ATT_ATOL)
    err = float((got - want).abs().max())
    print(f"  flash B{B} S{S} Hq{Hq} Hkv{Hkv} hd{hd} causal={causal} "
          f"window={window} softcap={softcap}: max_abs_err {err:.3g}")
    return err


def _cka_inputs(gen, n, dx, dy, offset=0.0):
    """X [n, dx], Y [n, dy] on the card, Y correlated with X; `offset`
    times U(1, 2) added to every column (raw, uncentered maps)."""
    x = torch.randn((n, dx), generator=gen)
    y = 0.3 * x[:, :dy] if dy <= dx else torch.zeros((n, dy))
    y = y + torch.randn((n, dy), generator=gen)
    if offset:
        x = x + offset * (1 + torch.rand(dx, generator=gen))
        y = y + offset * (1 + torch.rand(dy, generator=gen))
    return x.cuda(), y.cuda()


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor 4 bytes past a 16-byte boundary,
    which the example route reads with scalar loads."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


CKA_ROUTES = {"feature": cka_ops._launch_feature,
              "example": cka_ops._launch_example}


def check_cka(gen, n, dx, dy, routes=tuple(CKA_ROUTES), offset=0.0,
              aligned=True) -> float:
    """The wrapper, which must take the route of its rule, and `routes`
    called directly (the example route on the raw inputs, which it
    centers itself, the feature route on centered ones), against the plain
    version; returns the wrapper's max_abs_err. `offset` and `aligned` as
    `_cka_inputs` and `_misaligned` make the inputs."""
    x, y = _cka_inputs(gen, n, dx, dy, offset)
    if not aligned:
        x, y = _misaligned(x), _misaligned(y)
    before = dict(cka_ops.cka_terms.route_launches)
    got = torch.stack(cka_ops.cka_terms(x, y))
    took = [r for r, c in cka_ops.cka_terms.route_launches.items()
            if c != before[r]]
    route = "feature" if cka_ops.feature_route(n, dx, dy) else "example"
    if took != [route]:
        raise AssertionError(f"cka n{n} dx{dx} dy{dy} took {took}, not the "
                             f"{route} route of the rule")
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    hsic, kk, ll = cka_ops.cka_terms_plain(xc, yc)
    want = torch.stack([hsic, kk.sqrt(), ll.sqrt()])
    errs = {}
    for name, out in (("wrapper", got), *(
            (r, _terms(CKA_ROUTES[r], *((x, y) if r == "example"
                                        else (xc, yc)))) for r in routes)):
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=CKA_RTOL, atol=0.0)
        errs[name] = float(((out - want).abs() / want.abs()).max())
    k64, l64 = xc.double() @ xc.double().T, yc.double() @ yc.double().T
    exact = torch.stack([(k64 * l64).sum(), (k64 * k64).sum().sqrt(),
                         (l64 * l64).sum().sqrt()])
    how = (f" offset {offset:g}" if offset else "") + \
        ("" if aligned else " misaligned")
    print(f"  cka n{n} dx{dx} dy{dy}{how}: {route} route; max_rel_err "
          f"{errs['wrapper']:.3g} ("
          + ", ".join(f"{r} form {errs[r]:.3g}" for r in routes)
          + f"); against float64: wrapper {_rel_err(got, exact):.3g}, plain "
          f"{_rel_err(want, exact):.3g}")
    return float((got - want).abs().max())


def _terms(launch, xc, yc) -> torch.Tensor:
    """(hsic, sqrt(kk), sqrt(ll)) of one route's launch, as `cka_terms`
    returns them."""
    hsic, kk, ll = launch(xc, yc)
    return torch.stack([hsic, kk.sqrt(), ll.sqrt()])


def tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits as `cvt.rna.tf32.f32`
    rounds (to nearest, ties away from zero): the operand of one TF32
    product."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def cka_terms64(x, y) -> torch.Tensor:
    """(hsic, kk, ll) in float64, from the feature form."""
    x, y = x.double(), y.double()
    return torch.stack([(y.T @ x).square().sum(), (x.T @ x).square().sum(),
                        (y.T @ y).square().sum()])


def _rel_err(got, want) -> float:
    return float(((got.double() - want) / want).abs().max())


def beyond_tf32(gen, n, dx, dy):
    """X [n, dx], Y [n, dy] of entries +-(1 + 2^-12), rows in +- pairs so
    every column is centered. TF32 rounds each entry to +-1, so one TF32
    product is off by 1 - (1 + 2^-12)^-4 ~ 1e-3 in every term; 3xTF32
    holds the 2^-12 in the small part exactly."""
    half = torch.randn((n // 2, dx + dy), generator=gen).sign()
    z = (torch.cat([half, -half]) * (1 + 2 ** -12)).cuda()
    return z[:, :dx].contiguous(), z[:, dx:].contiguous()


def check_cka_precision(gen) -> None:
    """The feature route's products are 3xTF32, not one TF32 product. At
    the main shape, its relative error against float64 and that of one
    TF32 product (inputs rounded to TF32, the rest exact) are printed on
    Gaussian inputs, where the two are of one size (TF32's rounding
    errors average out over the squared entries, and the kernel's own
    error, most likely from the tensor cores' fp32 accumulation, is of
    that size), and held on `beyond_tf32` inputs, where they are three
    orders apart."""
    n, d = MAIN_CKA
    xc, yc = (cka_ops._prepare(t) for t in _cka_inputs(gen, n, d, d))
    want = cka_terms64(xc, yc)
    gauss = (_rel_err(torch.stack(cka_ops._launch_feature(xc, yc)), want),
             _rel_err(cka_terms64(tf32(xc), tf32(yc)), want))
    x, y = beyond_tf32(gen, n, d, d)
    want = cka_terms64(x, y)
    held = (_rel_err(torch.stack(cka_ops._launch_feature(x, y)), want),
            _rel_err(cka_terms64(tf32(x), tf32(y)), want))
    print(f"  cka feature route against float64, max relative error of "
          f"(hsic, kk, ll) at n{n} d{d}: Gaussian inputs {gauss[0]:.3g} "
          f"(one TF32 product {gauss[1]:.3g}; not held); entries "
          f"+-(1 + 2^-12) {held[0]:.3g} (one TF32 product {held[1]:.3g}; "
          f"limit {TF32X3_RTOL:g})")
    if not held[0] < TF32X3_RTOL < held[1]:
        raise AssertionError(f"the CKA feature route is off by {held[0]:.3g} "
                             f"on inputs TF32 cannot hold, where one TF32 "
                             f"product is off by {held[1]:.3g}: limit "
                             f"{TF32X3_RTOL:g}")


def _wkv_inputs(gen, B, T, H, n, draw="init"):
    """r, k, v standard normal; bonus u at its init scale; log-decay drawn
    like the model's at init (-0.3 to -0.45 per token) or, with draw
    "wide", as -exp(U(-8, 2)) (-7.4 to -3e-4 per token, the range a
    trained RWKV-6's decays take), where a chunk-start factorization
    exp(c_t) exp(-c_s) overflows."""
    r, k, v = (torch.randn((B, T, H, n), generator=gen).cuda()
               for _ in range(3))
    if draw == "init":
        logw = -(0.3 + 0.15 * torch.rand((B, T, H, n), generator=gen))
    else:
        logw = -torch.exp(-8 + 10 * torch.rand((B, T, H, n), generator=gen))
    u = (0.3 * torch.randn((H, n), generator=gen)).cuda()
    return r, k, v, logw.cuda(), u


def check_wkv(gen, B, T, H, n, *, with_s0=False, draw="init") -> float:
    """The wrapper against the plain version; returns its max_abs_err."""
    inputs = _wkv_inputs(gen, B, T, H, n, draw)
    s0 = (0.1 * torch.randn((B, H, n, n), generator=gen)).cuda() \
        if with_s0 else None
    o, s = wkv_ops.wkv(*inputs, s0=s0, return_state=True)
    want_o, want_s = wkv_ops.wkv_plain(*inputs, s0=s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, want_o, rtol=WKV_RTOL, atol=WKV_ATOL)
    torch.testing.assert_close(s, want_s, rtol=WKV_RTOL, atol=WKV_ATOL)
    err = max(float((o - want_o).abs().max()), float((s - want_s).abs().max()))
    print(f"  wkv6 B{B} T{T} H{H} n{n} s0={with_s0} {draw} draw: "
          f"max_abs_err {err:.3g} (o and final state; max |o| "
          f"{float(want_o.abs().max()):.3g})")
    return err


def kernel_phase():
    gen = torch.Generator().manual_seed(1234)
    B, S, H, hd = MAIN_ATT
    att_err = check_attention(gen, B, S, H, H, hd)  # main path
    for S in (100, 197):  # ragged, non-causal
        check_attention(gen, 2, S, 3, 3, 64)
    check_attention(gen, 2, 197, 4, 4, 64, causal=True)
    check_attention(gen, 2, 256, 4, 4, 64, causal=True, window=48,
                    softcap=30.0)
    check_attention(gen, 2, 200, 4, 4, 32, causal=False, window=48)
    check_attention(gen, 2, 192, 8, 2, 64, causal=True)  # GQA
    for hd in (16, 32, 64, 128):
        check_attention(gen, 2, 130, 4, 4, hd)
    q, k, v = (torch.randn(MAIN_ATT, generator=gen).cuda() for _ in range(3))
    first = att_ops.flash_attention(q, k, v, causal=False)
    second = att_ops.flash_attention(q, k, v, causal=False)
    if not torch.equal(first, second):
        raise AssertionError("two flash launches differ")
    print("  flash: two launches agree bit for bit")

    cka_err = check_cka(gen, *MAIN_CKA, MAIN_CKA[1])  # main path
    for n, dx, dy in RAGGED:
        check_cka(gen, n, dx, dy)
    x, _ = _cka_inputs(gen, 520, 192, 192)
    one = float(cka_ops.cka(x, x))
    if abs(one - 1.0) >= 1e-5:
        raise AssertionError(f"CKA(x, x) = {one!r}, not 1 within 1e-5")
    a, b = (cka_ops._prepare(t) for t in _cka_inputs(gen, *MAIN_CKA,
                                                      MAIN_CKA[1]))
    for route, launch in CKA_ROUTES.items():
        first, second = _terms(launch, a, b), _terms(launch, a, b)
        if not torch.equal(first, second):
            raise AssertionError(f"two CKA {route}-form launches differ: "
                                 f"{first} {second}")
    print(f"  cka(x, x) = {one!r}; two launches agree bit for bit on each "
          f"route")
    check_cka_precision(gen)
    # the CNN probes (the main path of the CNN loops): every map of a
    # full-width MobileNetV2 probe pass and ResNet50's largest, example
    # route only (the feature route's Gram would be d x d)
    cnn_err = 0.0
    for d in sorted(set(probe_dims(get_config("mobilenetv2")))
                    | {max(probe_dims(get_config("resnet50")))}):
        cnn_err = max(cnn_err, check_cka(gen, CNN_PROBE, d, d,
                                         routes=("example",)))
    # the example route's edges: row tiles, loads, raw inputs it centers
    for n, dx, dy in EXAMPLE_SHAPES:
        check_cka(gen, n, dx, dy, routes=("example",))
    for n, d in ((16, 4096), (13, 131072)):
        check_cka(gen, n, d, d, routes=("example",), aligned=False)
    for n, d in ((16, MBV2_STEM_D), (13, 2560), (40, 2560)):
        check_cka(gen, n, d, d, routes=("example",), offset=1e3)
    for d in (MBV2_STEM_D, 2 * MBV2_STEM_D):
        a, b = _cka_inputs(gen, CNN_PROBE, d, d, offset=1e3)
        if not torch.equal(_terms(cka_ops._launch_example, a, b),
                           _terms(cka_ops._launch_example, a, b)):
            raise AssertionError(f"two CKA example-form launches differ at "
                                 f"n{CNN_PROBE} d{d}")
    print(f"  cka example route at n{CNN_PROBE} d{MBV2_STEM_D} and "
          f"d{2 * MBV2_STEM_D} (raw inputs): two launches agree bit for bit")

    wkv_err = 0.0
    for draw in ("init", "wide"):
        wkv_err = max(wkv_err, check_wkv(gen, *MAIN_WKV, draw=draw))  # main
        check_wkv(gen, *MAIN_WKV, draw=draw, with_s0=True)
        check_wkv(gen, 2, 1, 4, 64, draw=draw, with_s0=True)  # T = 1
        check_wkv(gen, 1, 50, 4, 16, draw=draw)  # ragged T, head size 16
        check_wkv(gen, 2, 130, 3, 32, draw=draw, with_s0=True)
        for t in (256, 257):  # at and one past a boundary of 8-token tiles
            check_wkv(gen, 1, t, 4, 64, draw=draw, with_s0=True)
    for shape in (MAIN_WKV, (1, *MAIN_WKV[1:])):
        inputs = _wkv_inputs(gen, *shape, "wide")
        first = wkv_ops.wkv(*inputs, return_state=True)
        second = wkv_ops.wkv(*inputs, return_state=True)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"two WKV6 launches differ at {shape}")
    print("  wkv6: two launches agree bit for bit (o and final state), at 4 "
          "prompts and at one")
    return att_err, cka_err, cnn_err, wkv_err


# ---------------------------------------------------------------------------
# phase 3: the slice at full width


def perturbation(params0, seed: int, scale: float):
    """Fixed random directions, drawn with numpy, for every block and the
    head; `at(mult)` returns params0 moved by mult[i] along block i's
    direction (and mult[-1] along the head's)."""
    rng = np.random.default_rng(seed)

    def draw(t):
        host = t.cpu().numpy()
        d = scale * max(float(host.std()), 0.02) * \
            rng.standard_normal(host.shape).astype(np.float32)
        return torch.from_numpy(d).to(t.device)

    dblocks = tree_map(draw, params0["blocks"])
    dhead = tree_map(draw, params0["head"])

    def at(mult):
        blocks = [{g: {k: v + m * dblk[g][k] for k, v in leaves.items()}
                   for g, leaves in blk.items()}
                  for blk, dblk, m in zip(params0["blocks"], dblocks, mult)]
        head = {k: v + mult[-1] * dhead[k] for k, v in params0["head"].items()}
        return {**params0, "blocks": blocks, "head": head}

    return at


def drift(num_blocks, event, first_of_scenario2):
    """Multipliers at data event `event`: the first third of the blocks
    never moves (its units freeze), the middle third moves from scenario
    2 on (its units freeze, then unfreeze at the boundary), the last third
    and the head drift throughout."""
    third = num_blocks // 3
    late = math.sqrt(max(event - first_of_scenario2 + 1, 0))
    always = math.sqrt(event + 1)
    return [0.0 if b < third else late if b < 2 * third else always
            for b in range(num_blocks)] + [always]


def run_slice(model, params0, bench, events, move, *, use_kernel,
              batch_window=0.0, seed=0):
    """Serve every inference event and run SimFreeze's probe on every data
    event, as `repro.runtime.device.DeviceRuntime` does."""
    sched = EventScheduler(events)
    logits_out = []

    def on_served(logits, stream):
        logits_out.append(logits.copy())
        return False

    server = InferenceServer(model, batch_window=batch_window,
                             on_served=on_served)
    calls = {"features": 0, "passes": 0}

    def features(params, batch):
        calls["features"] += 1
        return model.features(params, batch)

    sf = SimFreeze(model.num_freeze_units, features,
                   SimFreezeConfig(cka_threshold=THRESHOLD, freeze_interval=1,
                                   use_kernel=use_kernel))
    ledger, cost = CostLedger(), EdgeCostModel()
    rng = np.random.default_rng(seed)
    data_events = [e for e in events if e.kind == "data"]
    first2 = next(i for i, e in enumerate(data_events) if e.scenario == 2)
    state = {"params": params0, "data": 0}
    plans, histories, variations = [], [], []

    def on_data(ev, boundary):
        server.expire(ev.time)
        sc = bench.scenarios[ev.scenario]
        batch = as_tensor(sc.train_batches[ev.index % len(sc.train_batches)],
                          model.device)
        if boundary and sf.reference_params is not None:
            old = {i: h[-1] for i, h in enumerate(sf.state.cka_history)
                   if sf.state.frozen[i] and h}
            sf.scenario_changed(state["params"], batch)
            calls["passes"] += 1
            variations.extend(abs(sf.state.cka_history[i][0] - o)
                              / max(abs(o), 1e-8) for i, o in old.items())
            plans.append(sf.plan().layers)
            histories.append([list(h) for h in sf.state.cka_history])
        if boundary:
            sf.start_scenario(params0, batch)
        # STAND-IN for the fine-tuning round that the next slice of the
        # port brings: the params move by a seeded numpy perturbation
        state["params"] = move(drift(len(params0["blocks"]), state["data"],
                                     first2))
        state["data"] += 1
        server.publish(state["params"], ev.time)
        frozen = list(sf.state.frozen)
        # the freeze pass's probe FLOPs are charged, as DeviceRuntime.complete
        # charges those of round_finished; a scenario_changed pass adds to
        # cka_flops uncharged, as in the reference
        before = sf.state.cka_flops
        sf.maybe_freeze(state["params"], 1)
        calls["passes"] += 1
        dcka = sf.state.cka_flops - before
        ledger.charge_probe("cka", *cost.compute_cost(dcka))
        variations.extend(abs(h[-1] - h[-2]) / max(abs(h[-2]), 1e-8)
                          for i, h in enumerate(sf.state.cka_history)
                          if not frozen[i] and len(h) >= 2)
        plans.append(sf.plan().layers)
        histories.append([list(h) for h in sf.state.cka_history])

    def on_inference(ev):
        cur = sched.scenario_of(ev.stream)
        sc = bench.scenarios[min(ev.scenario, cur) or ev.scenario]
        test = bench.scenarios[max(cur, 1)].test \
            if ev.scenario <= cur else sc.test
        idx = rng.choice(len(test["labels"]),
                         min(INFER_BATCH, len(test["labels"])), replace=False)
        server.submit(ev.time, {k: v[idx] for k, v in test.items()})

    server.publish(params0, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run(on_data=on_data, on_inference=on_inference)
    server.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for lg in logits_out:
        if not np.isfinite(lg).all() or lg.shape[-1] != model.cfg.num_classes:
            raise AssertionError(f"bad logits: shape {lg.shape}")
    return {"accs": list(server.accs), "logits": logits_out, "plans": plans,
            "histories": histories, "variations": variations,
            "cka_flops": sf.state.cka_flops, "freezes": sf.state.freezes,
            "unfreezes": sf.state.unfreezes, "t_cka": ledger.breakdown["t_cka"],
            "eval_calls": server.eval_calls, "served": server.served,
            "wall_s": wall, **calls}


def loop_data(image_size):
    """The loops' data and timeline, from fixed seeds: 50 classes in 4
    scenarios of 6 batches of 16 images, and 48 requests over the data
    events of scenarios 1-3 (scenario 0 pretrains)."""
    bench = nc_benchmark(num_classes=50, num_scenarios=4, batches=6,
                         batch_size=16, image_size=image_size, seed=0)
    events = [dataclasses.replace(e, scenario=e.scenario + 1)
              for e in build_timeline(num_scenarios=3, batches_per_scenario=6,
                                      inferences_total=48, seed=0)]
    return bench, events


def deit_setup(cfg):
    """The kernel and plain models, and the run's params, data and
    timeline, all from fixed seeds."""
    kmodel = build_model(cfg.replace(use_pallas=True))
    pmodel = build_model(cfg.replace(use_pallas=False))
    params0 = kmodel.init(torch.Generator().manual_seed(0))
    return kmodel, pmodel, (params0, *loop_data(cfg.image_size))


def slice_setup(cfg):
    """`deit_setup` and the perturbation that moves the params."""
    kmodel, pmodel, (params0, bench, events) = deit_setup(cfg)
    move = perturbation(params0, seed=11, scale=0.5)
    return kmodel, pmodel, (params0, bench, events, move)


def slice_phase(cfg):
    kmodel, pmodel, common = slice_setup(cfg)

    zero_launches()
    kern = run_slice(kmodel, *common, use_kernel=True)
    launches = read_launches()

    zero_launches()
    plain = run_slice(pmodel, *common, use_kernel=False)
    if any(read_launches().values()):
        raise AssertionError("the plain run launched a kernel")
    window = run_slice(kmodel, *common, use_kernel=True, batch_window=15.0)

    L = cfg.num_layers
    forwards = kern["eval_calls"] + kern["features"]
    print(f"  kernel run: {kern['served']} requests in {kern['eval_calls']} "
          f"predict calls, {kern['features']} features calls, "
          f"{kern['passes']} probe passes; freezes {kern['freezes']}, "
          f"unfreezes {kern['unfreezes']}")
    print(f"  launches: flash_attention {launches['flash_attention']} "
          f"(expected {L} x {forwards}), cka_terms {launches['cka_terms']} "
          f"(expected {L + 1} x {kern['passes']}; feature route "
          f"{launches['cka_feature']}, example route "
          f"{launches['cka_example']})")
    if launches["flash_attention"] != L * forwards or \
            launches["cka_terms"] != (L + 1) * kern["passes"] or \
            launches["cka_feature"] != launches["cka_terms"] or \
            launches["cka_example"] or \
            not (launches["flash_attention"] and launches["cka_terms"]) or \
            launches["wkv6"]:
        raise AssertionError(f"unexpected launch counts {launches}")
    if kern["accs"] != plain["accs"]:
        raise AssertionError("per-request accuracies differ from the plain run")
    for a, b in zip(kern["logits"], plain["logits"], strict=True):
        np.testing.assert_allclose(a, b, rtol=ATT_RTOL, atol=ATT_ATOL)
    if kern["plans"] != plain["plans"]:
        raise AssertionError("freeze plans differ from the plain run")
    for ha, hb in zip(kern["histories"], plain["histories"], strict=True):
        for x, y in zip(ha, hb, strict=True):
            np.testing.assert_allclose(x, y, rtol=0, atol=CKA_HISTORY_ATOL)
    if kern["cka_flops"] != plain["cka_flops"] or kern["cka_flops"] <= 0:
        raise AssertionError("cka_flops differ from the plain run")
    if window["accs"] != kern["accs"] or \
            window["eval_calls"] >= kern["eval_calls"]:
        raise AssertionError("coalesced serving changed the accuracies")
    margin = float(np.min(np.abs(np.asarray(kern["variations"]) - THRESHOLD)))
    print(f"  plain run agrees: accuracies, {len(kern['plans'])} freeze plans, "
          f"cka_flops {kern['cka_flops']:.6g}, modeled t_cka "
          f"{kern['t_cka']:.6g} s; closest CKA variation to the threshold "
          f"is {margin:.3g} away")
    print(f"  coalesced serving (batch_window 15): {window['eval_calls']} "
          f"predict calls, same accuracies; mean accuracy "
          f"{np.mean(kern['accs']):.4f}")
    print(f"  final plan {kern['plans'][-1]}")
    rps = kern["served"] / kern["wall_s"]
    print(f"  slice wall time: kernels {kern['wall_s']:.3f} s "
          f"({rps:.2f} requests/s, probes included), plain "
          f"{plain['wall_s']:.3f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 3: the ETuner loop at full width


# the ETuner session of the loop: LazyTune, SimFreeze and energy-score
# detection, one pretraining epoch, two replay batches, AdamW at lr 1e-3
# (the runtime's default optimizer)
ETUNER_POLICIES = etuner_stack_spec(
    lazytune_params={"max_batches_needed": 6},
    simfreeze_params={"freeze_interval": 3, "min_history": 2,
                      "cka_threshold": THRESHOLD})
# the reference's `semi_quant` session (tests/test_regression_runtime.py):
# a round on every data batch, no freezing, fake-quant QAT at 8 bits and
# SimSiam on half the batches
IMMEDIATE_POLICIES = etuner_stack_spec(lazytune=False, simfreeze=False,
                                       detect_scenario_changes=False)
SEMI_QUANT_HOOKS = (HookSpec("fake-quant", {"bits": 8}),
                    HookSpec("simsiam", {"fraction": 0.5}))


class _LoopClock(EventScheduler):
    """The fleet's scheduler, marking on the host clock when its event
    loop starts: after the runtime's pretraining, which is timed apart."""

    def run(self, **callbacks):
        torch.cuda.synchronize()
        self.started = time.perf_counter()
        super().run(**callbacks)


def run_etuner(model, bench, events, *, use_kernel,
               policies=ETUNER_POLICIES, hooks=(), **session):
    """The ETuner loop through the port's front door,
    `ContinualRuntime.from_config(...).run(events)`, on the injected
    full-width `model`, the slot's arch (the runtime pretrains from
    `model.init(torch.Generator().manual_seed(0))` on scenario 0, then
    LazyTune triggers rounds under SimFreeze's freeze plans, serving every
    request). `policies` and `hooks` are the slot's; `session` adds
    `RuntimeConfig` fields. Counts the predict and features calls, the
    probe passes and the SimSiam updates, times every train step with
    CUDA events by plan through the runtime's `TrainStepCache`, and
    records any kernel launch made inside a train step."""
    calls = {"predict": 0, "features": 0, "passes": 0, "semi": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    model = dataclasses.replace(
        model, predict=counted("predict", model.predict),
        features=counted("features", model.features))
    rt = ContinualRuntime.from_config(
        RuntimeConfig(slots={"default": SlotConfig(
                          arch=model.cfg.name, policies=policies,
                          hooks=hooks)},
                      seed=0, pretrain_epochs=1, replay_batches=2,
                      use_pallas=use_kernel, **session),
        device=model.device, model=model, benchmark=bench)
    # the controller the config built: a probe pass is one features call
    # and a CKA for every layer; the plan a round ran under is the plan
    # when the round reports back; served logits are kept for the checks
    ctrl = rt.controller
    sf = getattr(ctrl.freeze, "simfreeze", None)
    if sf is not None:
        sf._all_cka = counted("passes", sf._all_cka)
    for h in rt.hooks:
        if isinstance(h, SimSiamHook):
            h._semi_update = counted("semi", h._semi_update)
    round_plans, logits_out = [], []
    round_finished, inference_served = ctrl.round_finished, \
        ctrl.inference_served

    def finished(*args):
        round_plans.append(ctrl.plan.layers)
        return round_finished(*args)

    def served(logits):
        logits_out.append(logits.copy())
        return inference_served(logits)

    ctrl.round_finished, ctrl.inference_served = finished, served
    spans, in_step = {}, []
    raw_step = rt.steps._raw_step

    def checked_step(plan):
        step = raw_step(plan)

        def run(*args):
            before = read_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*args)
            end.record()
            spans.setdefault(plan.layers, []).append((start, end))
            if read_launches() != before:
                in_step.append(plan.layers)
            return out
        return run

    rt.steps._raw_step = checked_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet_mod.EventScheduler = _LoopClock
    try:
        res = rt.run(events)
    finally:
        fleet_mod.EventScheduler = EventScheduler
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    t1 = rt.scheduler.started
    device = rt.fleet.devices[0]
    params = device.primary.executor.params
    if len(round_plans) != res.rounds or not res.rounds:
        raise AssertionError(f"{res.rounds} rounds, {len(round_plans)} "
                             f"reported back")
    for lg in logits_out:
        if not np.isfinite(lg).all() or lg.shape[-1] != model.cfg.num_classes:
            raise AssertionError(f"bad logits: shape {lg.shape}")
    if not all(np.isfinite(t.cpu().numpy()).all()
               for t in tree_leaves(params)):
        raise AssertionError("non-finite params after fine-tuning")
    if len(res.inference_accs) != device.server.served or \
            not np.isfinite(res.total_time_s):
        raise AssertionError("the run result does not match its serving")
    step_ms = {plan: [s.elapsed_time(e) for s, e in sp]
               for plan, sp in spans.items()}
    flops = {plan: rt.steps.flops(LayerFreezePlan(plan),
                                  bench.scenarios[1].train_batches[0])
             for plan in step_ms}
    return {"rounds": res.rounds, "recompiles": res.recompiles,
            "stats": res.controller_stats, "round_plans": round_plans,
            "accs": res.inference_accs, "val_curve": res.val_curve,
            "logits": logits_out, "params": params,
            "served": device.server.served, "predict": calls["predict"],
            "features": calls["features"], "passes": calls["passes"],
            "probes": res.probes, "preemptions": res.preemptions,
            "semi": calls["semi"], "in_step": in_step, "step_ms": step_ms,
            "flops": flops,
            "total_time_s": res.total_time_s,
            "pretrain_s": t1 - t0, "loop_s": t2 - t1}


def etuner_phase(cfg):
    """The kernel run, the plain run, then the kernel run again: the first
    run of the process pays the card's first calls (module loads, GEMM
    heuristics), so times are read from the second and third."""
    kmodel, pmodel, (_, bench, events) = deit_setup(cfg)
    common = (bench, events)
    zero_launches()
    kern = run_etuner(kmodel, *common, use_kernel=True)
    launches = read_launches()
    zero_launches()
    plain = run_etuner(pmodel, *common, use_kernel=False)
    if any(read_launches().values()):
        raise AssertionError("the plain run launched a kernel")
    zero_launches()
    again = run_etuner(kmodel, *common, use_kernel=True)
    if read_launches() != launches:
        raise AssertionError(f"the second kernel run launched "
                             f"{read_launches()}, the first {launches}")
    for key in ("rounds", "recompiles", "stats", "round_plans", "accs",
                "val_curve"):
        if again[key] != kern[key]:
            raise AssertionError(f"{key} differs between two kernel runs")
    if not bitwise_equal(kern, again):
        raise AssertionError("two kernel runs are not bitwise the same")

    L = cfg.num_layers
    forwards = kern["predict"] + kern["features"]
    print(f"  kernel run: {kern['rounds']} rounds, {kern['recompiles']} "
          f"recompiles, {kern['served']} requests; {kern['predict']} predict "
          f"calls (serving and validation), {kern['features']} features "
          f"calls, {kern['passes']} probe passes")
    print(f"  controller stats {kern['stats']}")
    print(f"  freeze plans of the rounds: "
          f"{[''.join('F' if f else '.' for f in p) for p in kern['round_plans']]}")
    print(f"  validation curve {kern['val_curve']}")
    print(f"  launches: flash_attention {launches['flash_attention']} "
          f"(expected {L} x {forwards}), cka_terms {launches['cka_terms']} "
          f"(expected {L + 1} x {kern['passes']}; feature route "
          f"{launches['cka_feature']}); in train steps: "
          f"{len(kern['in_step'])} steps launched a kernel")
    if launches["flash_attention"] != L * forwards or \
            launches["cka_terms"] != (L + 1) * kern["passes"] or \
            launches["cka_feature"] != launches["cka_terms"] or \
            not (launches["flash_attention"] and launches["cka_terms"]) or \
            launches["wkv6"] or kern["in_step"] or plain["in_step"]:
        raise AssertionError(f"unexpected launch counts {launches}")
    for key in ("rounds", "recompiles", "stats", "round_plans", "accs",
                "val_curve", "predict", "features", "passes"):
        if kern[key] != plain[key]:
            raise AssertionError(f"{key} differs from the plain run: "
                                 f"{kern[key]} against {plain[key]}")
    for a, b in zip(kern["logits"], plain["logits"], strict=True):
        np.testing.assert_allclose(a, b, rtol=ATT_RTOL, atol=ATT_ATOL)
    # the train steps launch no kernel, and both runs train the same
    # batches under the same plans, so the params agree to the bit
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(kern["params"]), tree_leaves(plain["params"]),
        strict=True))
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(kern["params"]), tree_leaves(plain["params"]),
            strict=True)):
        raise AssertionError(f"final params differ by {diff:.3g}")
    print(f"  plain run agrees: rounds, recompiles, controller stats, freeze "
          f"plans, accuracies, validation curve; logits within "
          f"{ATT_RTOL}/{ATT_ATOL}; final params bitwise equal; a second "
          f"kernel run is bitwise the first")
    report_loop(L + 2, kern, plain, again)

    zero_launches()
    qos = run_etuner(kmodel, *common, use_kernel=True, boundaries="detector",
                     preemptible=True)
    qos_launches = read_launches()
    forwards = qos["predict"] + qos["features"]
    print(f"  detector boundaries, preemptible rounds (kernel run): "
          f"{qos['rounds']} rounds, {qos['probes']} probes, "
          f"{qos['preemptions']} preemptions, {qos['recompiles']} "
          f"recompiles; controller stats {qos['stats']}; launches "
          f"flash_attention {qos_launches['flash_attention']} (expected "
          f"{L} x {forwards}), cka_terms {qos_launches['cka_terms']} "
          f"(expected {L + 1} x {qos['passes']}); loop wall time "
          f"{qos['loop_s']:.3f} s ({qos['rounds'] / qos['loop_s']:.3f} "
          f"rounds/s)")
    if qos_launches["flash_attention"] != L * forwards or \
            qos_launches["cka_terms"] != (L + 1) * qos["passes"] or \
            qos["in_step"]:
        raise AssertionError(f"unexpected launch counts {qos_launches}")
    return launches


def report_loop(units, kern, plain, again=None) -> None:
    """Each plan's train-step time (CUDA events) and FLOPs, and the loop's
    wall time, of the warm kernel run (`again`, else `kern`) beside the
    others."""
    warm = again or kern
    base = kern["flops"][(False,) * units]
    for plan, ms in warm["step_ms"].items():
        others = f"plain run mean {np.mean(plain['step_ms'][plan]):.3f}"
        if again is not None:
            others += (f", first kernel run "
                       f"{np.mean(kern['step_ms'][plan]):.3f}")
        print(f"  train step, {sum(plan)} of {units} units frozen "
              f"({''.join('F' if f else '.' for f in plan)}): {len(ms)} steps, "
              f"CUDA events mean {np.mean(ms):.3f} ms (min {np.min(ms):.3f}, "
              f"max {np.max(ms):.3f}; {others}); FlopCounterMode "
              f"{kern['flops'][plan]:.6g} FLOPs, ratio to all-active "
              f"{kern['flops'][plan] / base:.4f}")
    runs = (("second kernel run", again), ("plain run", plain),
            ("first kernel run", kern)) if again is not None else \
        (("kernel run", kern), ("plain run", plain))
    for name, run in runs:
        print(f"  loop wall time, {name}: {run['loop_s']:.3f} s "
              f"({run['rounds'] / run['loop_s']:.3f} rounds/s, "
              f"{run['served'] / run['loop_s']:.2f} requests/s); "
              f"pretraining {run['pretrain_s']:.3f} s")
    print(f"  modeled device time (EdgeCostModel) {kern['total_time_s']:.6g} s")


def bitwise_equal(a, b) -> bool:
    """Two runs' served logits and final params agree to the bit."""
    return all(np.array_equal(x, y) for x, y in zip(
        a["logits"], b["logits"], strict=True)) and \
        all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a["params"]), tree_leaves(b["params"]), strict=True))


def probe_dims(cfg) -> list:
    """d = H*W*C of each map of a probe pass of `cfg`'s CNN on a batch of
    CNN_PROBE images, from shapes on the meta device."""
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator())
    images = torch.empty((CNN_PROBE, cfg.image_size, cfg.image_size, 3),
                         device="meta")
    return [f[0].numel() for f in model.features(params, {"images": images})]


def cnn_loop_phase(cfg, *, repeat: bool):
    """The ETuner loop of `etuner_phase` on a CNN at full width: the kernel
    run, the plain run and, with `repeat`, the kernel run again (times
    are read from it). The runs must agree exactly: rounds, recompiles,
    controller stats, plans, validation curve, accuracies, and served
    logits and final params bit for bit (CKA runs in the probes only, and
    the CNN's forward has no kernel). CKA launches once a feature map of a
    probe pass, all on the example route, none inside a train step."""
    model = build_model(cfg)
    bench, events = loop_data(cfg.image_size)
    units = model.num_freeze_units
    zero_launches()
    kern = run_etuner(model, bench, events, use_kernel=True)
    launches = read_launches()
    zero_launches()
    plain = run_etuner(model, bench, events, use_kernel=False)
    if any(read_launches().values()):
        raise AssertionError("the plain run launched a kernel")
    again = None
    if repeat:
        zero_launches()
        again = run_etuner(model, bench, events, use_kernel=True)
        if read_launches() != launches:
            raise AssertionError(f"the second kernel run launched "
                                 f"{read_launches()}, the first {launches}")
    maps = units - 1
    print(f"  kernel run: {kern['rounds']} rounds, {kern['recompiles']} "
          f"recompiles, {kern['served']} requests; {kern['predict']} predict "
          f"calls, {kern['features']} features calls, {kern['passes']} probe "
          f"passes")
    print(f"  controller stats {kern['stats']}")
    plans = ["".join("F" if f else "." for f in p)
             for p in kern["round_plans"]]
    print(f"  freeze plans of the rounds: {plans}")
    print(f"  validation curve {kern['val_curve']}; mean accuracy "
          f"{np.mean(kern['accs']):.4f}")
    print(f"  launches: cka_terms {launches['cka_terms']} (expected {maps} x "
          f"{kern['passes']}; example route {launches['cka_example']}, "
          f"feature route {launches['cka_feature']}); in train steps: "
          f"{len(kern['in_step'])} steps launched a kernel")
    if launches["cka_terms"] != maps * kern["passes"] or \
            launches["cka_example"] != launches["cka_terms"] or \
            not launches["cka_terms"] or launches["flash_attention"] or \
            launches["wkv6"] or kern["in_step"] or plain["in_step"]:
        raise AssertionError(f"unexpected launch counts {launches}")
    for other, name in ((plain, "the plain run"),
                        (again, "a second kernel run")):
        if other is None:
            continue
        for key in ("rounds", "recompiles", "stats", "round_plans", "accs",
                    "val_curve", "predict", "features", "passes"):
            if kern[key] != other[key]:
                raise AssertionError(f"{key} differs from {name}: "
                                     f"{kern[key]} against {other[key]}")
        if not bitwise_equal(kern, other):
            diff = max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(kern["params"]), tree_leaves(other["params"])))
            raise AssertionError(f"{name} is not bitwise the kernel run: "
                                 f"final params differ by {diff:.3g}")
    print("  plain run" + (" and second kernel run" if repeat else "")
          + " agree: rounds, recompiles, controller stats, freeze plans, "
          "accuracies, validation curve; served logits and final params "
          "bitwise equal")
    report_loop(units, kern, plain, again)
    return launches


def hooks_phase(cfg):
    """The reference's `semi_quant` session on the full-width CNN of
    `cfg`: immediate rounds, fake-quant QAT at 8 bits, SimSiam on half
    the batches, once."""
    model = build_model(cfg)
    bench, events = loop_data(cfg.image_size)
    run = run_etuner(model, bench, events, use_kernel=True,
                     policies=IMMEDIATE_POLICIES, hooks=SEMI_QUANT_HOOKS)
    steps = sum(len(ms) for ms in run["step_ms"].values())
    print(f"  {run['rounds']} rounds, {run['recompiles']} recompiles, "
          f"{run['semi']} SimSiam updates, {steps} supervised steps; mean "
          f"accuracy {np.mean(run['accs']):.4f} over "
          f"{run['served']} requests; loop wall time {run['loop_s']:.3f} s "
          f"({run['rounds'] / run['loop_s']:.3f} rounds/s)")
    if not run["semi"] or not run["rounds"] or run["passes"]:
        raise AssertionError(f"the hooks session ran {run['rounds']} rounds, "
                             f"{run['semi']} SimSiam updates, "
                             f"{run['passes']} probe passes")


# ---------------------------------------------------------------------------
# phase 3: the compiled hot path at full width


# the loops' size as a workload preset's scale: 3 scenarios of 6 batches
# of 16 images, 48 requests a stream (qos: its priority-2 stream 96 and
# half the batches, its bulk stream 24 and twice the batches)
WORKLOAD_SCALE = dict(num_scenarios=3, batches_per_scenario=6,
                      inferences=48, batch_size=16)
COMPILED_SESSIONS = (("deit-tiny", "single-poisson", False),
                     ("deit-tiny", "qos", True),
                     ("mobilenetv2", "single-poisson", False))
# the runtime-API calls by which the host starts work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")


def workload_benches(spec, cfg) -> dict:
    """`runtime.config.materialize_stream_benchmarks` at the model's image
    size, with the loops' 50 classes and 16-image batches."""
    return {i: REGISTRY[ss.benchmark](
        num_classes=50, num_scenarios=spec.num_scenarios + 1,
        batches=max(ss.batches_per_scenario, 2), batch_size=16,
        image_size=cfg.image_size, seed=13 * i)
        for i, ss in enumerate(spec.streams)}


class _Captures:
    """Every CUDA graph captured while it is installed: the graph, the
    host clock its capture took (warm-up run included) and the kernel
    wrappers' counts the capture added. A capture adds two of each launch
    it records: one from the warm-up run, which the card runs, and one
    from the capture, which the card runs at every replay."""

    def __init__(self):
        self.graphs = []
        self._orig = train_loop.CapturedCall._capture

    def __enter__(self):
        spy = self

        def capture(call, *args):
            torch.cuda.synchronize()
            t0, before = time.perf_counter(), read_launches()
            spy._orig(call, *args)
            torch.cuda.synchronize()
            after = read_launches()
            spy.graphs.append((call, time.perf_counter() - t0,
                               {k: after[k] - before[k] for k in after}))

        train_loop.CapturedCall._capture = capture
        return self

    def __exit__(self, *exc):
        train_loop.CapturedCall._capture = self._orig

    def mark(self) -> tuple:
        """Where a run starts: the graphs so far and their replays."""
        return len(self.graphs), [g.replays for g, _, _ in self.graphs]

    def card_launches(self, name: str, mark: tuple) -> int:
        """Launches of kernel `name` the card ran from graphs since
        `mark`: each new graph's warm-up run, and every replay of every
        graph, new or captured before."""
        n0, replays0 = mark
        total = 0
        for i, (g, _, counts) in enumerate(self.graphs):
            per = counts[name] // 2
            total += per * ((1 + g.replays) if i >= n0
                            else g.replays - replays0[i])
        return total


CAPTURES = _Captures()


def run_workload(model, workload, benches, *, compiled, segment=True,
                 preemptible=False):
    """One session of `workload` through the port's front door on the
    injected full-width `model`, with the loops' ETuner policies and the
    kernels (`use_pallas`). Times every train step (eager) or fused call
    (compiled) with CUDA events by plan, the loop's wall time after
    pretraining, the captures, and peak device memory."""
    cfg = RuntimeConfig(
        slots={"cv": SlotConfig(arch=model.cfg.name,
                                policies=ETUNER_POLICIES)},
        workload=workload, workload_scale=dict(WORKLOAD_SCALE), seed=0,
        pretrain_epochs=1, replay_batches=2, use_pallas=True,
        preemptible=preemptible, compiled=compiled)
    rt = ContinualRuntime.from_config(cfg, device=model.device, model=model,
                                      stream_benchmarks=benches)
    rt.segment = segment
    spans, plans = {}, []
    if compiled:
        fused = rt.steps.fused_call

        def timed_fused(plan, *args):
            captures = len(CAPTURES.graphs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fused(plan, *args)
            end.record()
            # (start, end, bucket, batches, captured)
            spans.setdefault(plan.layers, []).append(
                (start, end, out[2]["loss"].shape[0], len(args[2]),
                 len(CAPTURES.graphs) > captures))
            return out

        rt.steps.fused_call = timed_fused
    else:
        raw_step = rt.steps._raw_step

        def timed_step(plan):
            step = raw_step(plan)

            def run(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args)
                end.record()
                spans.setdefault(plan.layers, []).append(
                    (start, end, 1, 1, False))
                return out
            return run

        rt.steps._raw_step = timed_step
    execute_round = FineTuneExecutor.execute_round

    def spy_round(ex, plan, *a, **k):
        if ex.buffers.get(k.get("stream", 0)):
            plans.append(plan.layers)
        return execute_round(ex, plan, *a, **k)

    FineTuneExecutor.execute_round = spy_round
    fleet_mod.EventScheduler = _LoopClock
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark = CAPTURES.mark()
    t0 = time.perf_counter()
    try:
        res = rt.run()
    finally:
        fleet_mod.EventScheduler = EventScheduler
        FineTuneExecutor.execute_round = execute_round
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    params = rt.fleet.devices[0].primary.executor.params
    if not res.rounds or len(plans) != res.rounds or \
            len(res.inference_accs) != sum(e.kind == "inference"
                                           for e in rt.session_events):
        raise AssertionError(f"{res.rounds} rounds, {len(plans)} plans, "
                             f"{len(res.inference_accs)} requests")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)) \
            or not np.isfinite(res.total_time_s):
        raise AssertionError("non-finite params or ledger")
    steps = {plan: [(s.elapsed_time(e), b, n, c) for s, e, b, n, c in sp]
             for plan, sp in spans.items()}
    return {"res": res, "plans": plans, "params": params, "steps": steps,
            "launches": read_launches(),
            "captured": CAPTURES.graphs[mark[0]:],
            "card_flash": CAPTURES.card_launches("flash_attention", mark),
            "loop_s": t2 - rt.scheduler.started,
            "pretrain_s": rt.scheduler.started - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def same_session(a, b) -> list:
    """What differs between two runs of one session (empty: nothing)."""
    ra, rb = a["res"], b["res"]
    out = [k for k in ("rounds", "recompiles", "preemptions",
                       "controller_stats", "inference_accs", "val_curve",
                       "total_time_s", "total_energy_j", "compute_tflops",
                       "per_stream", "per_model")
           if getattr(ra, k) != getattr(rb, k)]
    if a["plans"] != b["plans"]:
        out.append("plans")
    if not all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a["params"]), tree_leaves(b["params"]),
            strict=True)):
        out.append("final params")
    return out


def host_launches(run, per: int) -> dict:
    """Runtime-API launch calls the host makes, and kernels the card runs,
    for `per` train steps of `run` (under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    calls = sum(e.count for e in rows if e.key in LAUNCH_CALLS)
    kernels = sum(e.count for e in rows
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    flash = sum(e.count for e in rows if "flash_fwd_kernel" in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA)
    cka = sum(e.count for e in rows if "cka_" in e.key and "gram" in e.key
              and e.device_type == torch.autograd.DeviceType.CUDA)
    return {"calls": calls / per, "kernels": kernels / per, "flash": flash,
            "cka": cka}


def step_launches(model, bench) -> dict:
    """Host launch calls per all-active train step, eager against a
    bucket-8 graph replay, and flash/CKA kernels seen on the card in one
    graphed predict and one graphed probe pass with its CKAs."""
    opt_cfg = AdamWConfig(lr=1e-3)
    params = model.init(torch.Generator().manual_seed(0))
    state = make_optimizer_state(model, opt_cfg, params)
    plan = LayerFreezePlan((False,) * model.num_freeze_units)
    cache = TrainStepCache(model, opt_cfg)
    batches = bench.scenarios[1].train_batches[:6]
    step = cache.get(plan)
    device_batch = as_tensor(batches[0], model.device)

    def eager(n):
        p, s = params, state
        for _ in range(n):
            p, s, _ = step(p, s, device_batch)

    eager(1)
    cache.fused_call(plan, params, state, batches[:5])  # capture bucket 8
    out = {"eager": host_launches(lambda: eager(2), 2),
           "graph": host_launches(lambda: cache.fused_call(
               plan, params, state, batches[:5]), 8)}
    graphed = compiled_model(model)
    sf = SimFreeze(model.num_freeze_units, graphed.features,
                   SimFreezeConfig(use_kernel=True))
    probe = as_tensor(bench.scenarios[1].train_batches[0], model.device)
    sf.start_scenario(params, probe)  # captures the features graph
    graphed.predict(params, probe)  # captures the predict graph
    sf._all_cka(params)
    out["predict"] = host_launches(lambda: graphed.predict(params, probe), 1)
    out["probe"] = host_launches(lambda: sf._all_cka(params), 1)
    return out


def compiled_phase() -> dict:
    """Each session of `COMPILED_SESSIONS` at full width four ways:
    compiled, compiled with `segment=False`, eager (`compiled=False`) and
    compiled again (every graph already captured: the warm compiled run).
    All four must give the same rounds, plans, recompiles, preemptions,
    accuracies, validation curve and ledger totals, and bitwise equal
    final params. Returns the flash and CKA launches the card ran, by
    session."""
    CAPTURES.graphs.clear()
    models = {"deit-tiny": build_model(get_config("deit-tiny").replace(
        use_pallas=True)), "mobilenetv2": build_model(get_config(
            "mobilenetv2"))}
    scale = {k: v for k, v in WORKLOAD_SCALE.items() if k != "batch_size"}
    card = {}
    for arch, workload, preemptible in COMPILED_SESSIONS:
        model = models[arch]
        benches = workload_benches(presets(seed=0, **scale)[workload],
                                   model.cfg)
        name = f"{arch} {workload}" + (" preemptible" if preemptible else "")
        runs = {}
        for label, kw in (("compiled", dict(compiled=True)),
                          ("compiled, segment=False",
                           dict(compiled=True, segment=False)),
                          ("eager", dict(compiled=False)),
                          ("compiled again", dict(compiled=True))):
            runs[label] = run_workload(model, workload, benches,
                                       preemptible=preemptible, **kw)
        first = runs["compiled"]
        res = first["res"]
        print(f"  {name}: {res.rounds} rounds, {len(set(first['plans']))} "
              f"plans, {res.recompiles} recompiles, {res.preemptions} "
              f"preemptions, {len(res.inference_accs)} requests; controller "
              f"stats {res.controller_stats}")
        plans = ["".join("F" if f else "." for f in p)
                 for p in first["plans"]]
        print(f"    freeze plans: {plans}")
        for label, run in runs.items():
            diff = same_session(first, run)
            if diff:
                raise AssertionError(f"{name}: the {label} run differs from "
                                     f"the compiled run in {diff}")
        if preemptible and not res.preemptions:
            raise AssertionError(f"{name}: no round was preempted")
        print("    compiled, compiled segment=False, eager and compiled "
              "again agree exactly: rounds, plans, recompiles, "
              "preemptions, accuracies, validation curve, ledger totals; "
              "final params bitwise equal")
        eager = runs["eager"]
        L = model.cfg.num_layers
        flash = first["card_flash"]
        card[name] = {"flash_attention": flash,
                      "cka_terms": first["launches"]["cka_terms"]}
        print(f"    launches on the card, compiled run: flash_attention "
              f"{flash} (each new graph's warm-up run and every replay), "
              f"cka_terms "
              f"{first['launches']['cka_terms']} (eager, between replays); "
              f"eager run: flash_attention "
              f"{eager['launches']['flash_attention']}, cka_terms "
              f"{eager['launches']['cka_terms']}")
        if eager["launches"]["cka_terms"] != first["launches"]["cka_terms"] \
                or (L and (not flash or eager["launches"]["flash_attention"]
                           % L or flash % L)):
            raise AssertionError(f"{name}: unexpected launch counts")
        captures = first["captured"]
        print(f"    captures: {len(captures)} new graphs in "
              f"{sum(t for _, t, _ in captures):.3f} s of host time "
              f"(warm-up runs included)")
        for plan in eager["steps"]:
            ms_eager = [ms for ms, _, _, _ in eager["steps"][plan]]
            line = (f"    plan {''.join('F' if f else '.' for f in plan)}: "
                    f"eager {np.mean(ms_eager):.3f} ms a step "
                    f"({len(ms_eager)} steps)")
            for label in ("compiled again", "compiled"):
                calls = [c for c in runs[label]["steps"].get(plan, ())
                         if not c[3]]
                if calls:
                    per_step = [ms / b for ms, b, _, _ in calls]
                    per_batch = sum(ms for ms, _, _, _ in calls) / sum(
                        n for _, _, n, _ in calls)
                    line += (f"; {label} {np.mean(per_step):.3f} ms a graph "
                             f"step, {per_batch:.3f} ms a batch ({len(calls)} "
                             f"replays, buckets "
                             f"{sorted({b for _, b, _, _ in calls})})")
            print(line)
        for label, run in runs.items():
            print(f"    {label}: loop {run['loop_s']:.3f} s "
                  f"({run['res'].rounds / run['loop_s']:.3f} rounds/s), "
                  f"pretraining {run['pretrain_s']:.3f} s, peak device "
                  f"memory {run['peak_gb']:.2f} GB allocated, "
                  f"{run['reserved_gb']:.2f} GB reserved")
        if workload == "single-poisson":
            counts = step_launches(model, benches[0])
            eager_c, graph_c = counts["eager"], counts["graph"]
            print(f"    host launch calls a train step: eager "
                  f"{eager_c['calls']:.1f} ({eager_c['kernels']:.1f} "
                  f"kernels on the card), bucket-8 graph "
                  f"{graph_c['calls']:.2f} ({graph_c['kernels']:.1f} "
                  f"kernels on the card)")
            print(f"    on the card (torch.profiler): a graphed predict ran "
                  f"{counts['predict']['flash']} flash kernels (L = {L}), a "
                  f"graphed probe pass {counts['probe']['flash']} flash and "
                  f"{counts['probe']['cka']} CKA gram kernels "
                  f"({model.num_freeze_units - 1} maps)")
            if counts["predict"]["flash"] != L or \
                    counts["probe"]["flash"] != L or \
                    counts["probe"]["cka"] != model.num_freeze_units - 1 or \
                    counts["graph"]["calls"] >= counts["eager"]["calls"]:
                raise AssertionError(f"{name}: unexpected counts {counts}")
    return card


def zero_launches() -> None:
    att_ops.flash_attention.launches = cka_ops.cka_terms.launches = 0
    cka_ops.cka_terms.route_launches = {"feature": 0, "example": 0}
    wkv_ops.wkv.launches = 0


def read_launches() -> dict:
    return {"flash_attention": att_ops.flash_attention.launches,
            "cka_terms": cka_ops.cka_terms.launches,
            **{f"cka_{route}": count for route, count
               in cka_ops.cka_terms.route_launches.items()},
            "wkv6": wkv_ops.wkv.launches}


def timed(fn, spans):
    """`fn` with a pair of CUDA events recorded around every call."""
    def call(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        spans.append((start, end))
        return out
    return call


def serve(model, params, prompts):
    """One `ServeEngine.generate` call: tokens [B, steps], the logits that
    chose them [B, steps, V], and the kernels it launched."""
    zero_launches()
    tokens, logits = ServeEngine(model, max_len=prompts.shape[1]
                                 + DECODE_STEPS).generate(
        params, prompts, steps=DECODE_STEPS, return_logits=True)
    torch.cuda.synchronize()
    if not np.isfinite(logits).all() or \
            logits.shape != (*prompts.shape[:1], DECODE_STEPS,
                             model.cfg.vocab_size):
        raise AssertionError(f"bad logits: shape {logits.shape}")
    return tokens, logits, read_launches()


def agree_on_tokens(kern, plain, plain_logits):
    """Steps at which the two runs must pick the same token: those where
    the plain run's top-two logit margin exceeds MARGIN, in each row up to
    the first step where the runs, at a closer margin, picked differently
    (after it their inputs differ). Raises on a disagreement; returns
    (steps compared, steps whose margin was too close)."""
    top2 = np.sort(plain_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    compared = close = 0
    for b in range(kern.shape[0]):
        for t in range(kern.shape[1]):
            if margin[b, t] <= MARGIN:
                close += 1
                if kern[b, t] != plain[b, t]:
                    break
                continue
            if kern[b, t] != plain[b, t]:
                raise AssertionError(
                    f"row {b} step {t}: token {kern[b, t]} against the plain "
                    f"run's {plain[b, t]} at margin {margin[b, t]:.3g}")
            compared += 1
    return compared, close


def lm_close(name, got, want, tol) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    print(f"  {name}: max_abs_err {err:.4g} (limit rtol = atol = {tol:g}; "
          f"max |logit| {np.abs(want).max():.4g})")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def rwkv_model(cfg, **kw):
    """The model of `cfg` (with `kw` replaced) and its params, drawn on the
    card from seed 0."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg.replace(**kw))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"  {cfg.name} {model.cfg.param_dtype}: "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.4g}e9 params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
          f"drawn in {time.perf_counter() - t0:.2f} s")
    return model, params


def consistency(model, params, prompts):
    """Logits of a decode of the last prompt token after a prefill of the
    others: they must be those of the full prefill (the final state the
    WKV route hands over is the decode cache)."""
    tokens = torch.as_tensor(prompts, device=model.device)
    _, cache = model.prefill(params, {"tokens": tokens[:, :-1]})
    dec, _ = model.decode(params, tokens[:, -1:], cache, tokens.shape[1] - 1)
    return dec.float().cpu().numpy()


def rwkv_phase(cfg):
    """rwkv6-3b serving at full width through `ServeEngine.generate`.

    The bf16 kernel run is the main path: its launches and timings are
    the ones reported. The checks against the plain run (chunked form at
    chunk 32) and of prefill/decode consistency run in fp32 within 1e-3:
    in bf16 a one-ulp flip of an activation's rounding compounds over the
    32 layers, and both bf16 differences exceed the 3e-2 limit (printed
    beside it, not held; PERF.md)."""
    L = cfg.num_layers
    B, S = MAIN_WKV[:2]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    kmodel, params = rwkv_model(cfg, use_pallas=True)
    kern_tok, kern_logits, launches = serve(kmodel, params, prompts)
    print(f"  kernel run: {launches}")
    if launches != {"flash_attention": 0, "cka_terms": 0, "cka_feature": 0,
                    "cka_example": 0, "wkv6": L}:
        raise AssertionError(f"expected {L} wkv6 launches, one per layer of "
                             f"the prefill; got {launches}")
    spans = {"prefill": [], "decode": []}
    tmodel = dataclasses.replace(
        kmodel, prefill=timed(kmodel.prefill, spans["prefill"]),
        decode=timed(kmodel.decode, spans["decode"]))
    again, _, _ = serve(tmodel, params, prompts)
    if not np.array_equal(again, kern_tok):
        raise AssertionError("a repeat of the kernel run chose other tokens")
    prefill_s = sum(a.elapsed_time(b) for a, b in spans["prefill"]) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in spans["decode"]) / 1e3
    print(f"  kernel run timed (CUDA events around each call): prefill "
          f"{prefill_s * 1e3:.2f} ms ({B * S / prefill_s:.0f} tokens/s), "
          f"decode {decode_s * 1e3 / DECODE_STEPS:.2f} ms per step "
          f"({B * DECODE_STEPS / decode_s:.1f} tokens/s)")
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False, ssm_chunk=32))
    plain_tok, plain_logits, plain_launches = serve(pmodel, params, prompts)
    if any(plain_launches.values()):
        raise AssertionError(f"the plain run launched {plain_launches}")
    bf16_pair = float(np.abs(kern_logits[:, 0] - plain_logits[:, 0]).max())
    bf16_dec = float(np.abs(consistency(kmodel, params, prompts)
                            - kern_logits[:, 0]).max())
    print(f"  bf16, not held: prefill logits kernel against plain max_abs_err "
          f"{bf16_pair:.4g}, decode after prefill against prefill "
          f"{bf16_dec:.4g} (limit {LM_TOL:g}); "
          f"{int((kern_tok == plain_tok).sum())} of {kern_tok.size} tokens "
          f"equal")
    del params
    torch.cuda.empty_cache()

    kmodel, params = rwkv_model(cfg, use_pallas=True, dtype="float32",
                                param_dtype="float32")
    kern_tok, kern_logits, _ = serve(kmodel, params, prompts)
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False, ssm_chunk=32))
    plain_tok, plain_logits, plain_launches = serve(pmodel, params, prompts)
    if any(plain_launches.values()):
        raise AssertionError(f"the plain run launched {plain_launches}")
    lm_close("fp32 prefill logits, kernel against plain (chunk 32)",
             kern_logits[:, 0], plain_logits[:, 0], PAIR_TOL)
    compared, close = agree_on_tokens(kern_tok, plain_tok, plain_logits)
    print(f"  fp32 tokens: the runs agree at all {compared} steps whose "
          f"margin exceeds {MARGIN:g} ({close} steps closer; "
          f"{int((kern_tok == plain_tok).sum())} of {kern_tok.size} equal)")
    lm_close(f"fp32 decode of token {S} after a {S - 1}-token prefill, "
             f"against the {S}-token prefill",
             consistency(kmodel, params, prompts),
             kern_logits[:, 0], PAIR_TOL)
    del params
    torch.cuda.empty_cache()
    return launches["wkv6"]


# ---------------------------------------------------------------------------
# phase 4: timing


def time_ms(fn, iters=50, warmup=5) -> float:
    """Eager: CUDA events around `iters` calls. Where the host takes
    longer to launch a call than the card to run it, this is the host's
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=20, replays=10) -> float:
    """The card's time for one call: `calls` calls captured in a CUDA
    graph, the graph replayed `replays` times between CUDA events. Free of
    the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def timing_phase():
    gen = torch.Generator().manual_seed(99)
    B, S, H, hd = MAIN_ATT
    q, k, v = (torch.randn((B, S, H, hd), generator=gen).cuda()
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel = lambda: att_ops.flash_attention(  # noqa: E731
        q, k, v, causal=False)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    att = {
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: att_ops.attention_plain(q, k, v,
                                                            causal=False)),
        "library_ms": time_ms(sdpa),
        "device_ms": device_ms(kernel),
        "library_device_ms": device_ms(sdpa),
    }
    flops = 4.0 * B * H * S * S * hd
    nbytes = 4.0 * 4 * B * S * H * hd
    att.update(bound(flops, nbytes, tensor_cores=True))

    n, d = MAIN_CKA
    x, y = _cka_inputs(gen, n, d, d)
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    feature = lambda: cka_ops._launch_feature(xc, yc)  # noqa: E731
    example = lambda: cka_ops._launch_example(xc, yc)  # noqa: E731
    cka = {
        "ms": time_ms(feature),
        "plain_ms": time_ms(lambda: cka_ops.cka_terms_plain(xc, yc)),
        "library_ms": None,
        "device_ms": device_ms(feature),
        "example_route_ms": time_ms(example),
        "example_route_device_ms": device_ms(example),
    }
    # the least work, which the feature route does: Y^T X and the upper
    # triangles of X^T X and Y^T Y
    flops = 2.0 * n * (d * d + d * (d + 1))
    nbytes = 4.0 * n * (d + d) + 4 * 3
    cka.update(bound(flops, nbytes, tensor_cores=True))
    # the example route: the upper triangle of both n x n Grams, 3xTF32
    design = bound(2.0 * (d + d) * n * (n + 1) / 2, nbytes,
                   tensor_cores=True)
    feature_ms = time_ms(lambda: cka_feature_form(xc, yc, use_kernel=False))
    print("  eager: CUDA events around 50 eager calls (ms; the host's time "
          "where launching is slower than the card); device: CUDA graphs "
          "(device_ms)")
    for name, t in (("flash_attention", att), ("cka_terms", cka)):
        lib = "n/a" if t["library_ms"] is None else \
            f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f})"
        print(f"  {name}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, library "
              f"{lib} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['bound_kind']}; on the fp32 CUDA cores "
              f"{t['bound_fp32_ms']:.4f} ms)")
    print(f"  cka_terms: the example route {cka['example_route_ms']:.4f} ms "
          f"(device {cka['example_route_device_ms']:.4f}, the torch "
          f"centering of its {-(-n // cka_ops.EXAMPLE_ROWS)} row tiles "
          f"included; its design's own limit {design['bound_ms']:.4f} ms, "
          f"{design['bound_by']}, 3xTF32); the plain feature form that "
          f"core/cka.py takes without the kernel {feature_ms:.4f} ms")

    cka["cnn"] = cnn_cka_timing(gen)

    B, T, H, n = MAIN_WKV
    r, k, v, logw, u = _wkv_inputs(gen, B, T, H, n)
    kernel = lambda: wkv_ops.wkv(r, k, v, logw, u,  # noqa: E731
                                 return_state=True)
    wkv = {
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: wkv_ops.wkv_plain(r, k, v, logw, u),
                            iters=3, warmup=1),
        "library_ms": None,
        "device_ms": device_ms(kernel, calls=5),
    }
    # r, k, v, logw read and o written once, u read, the final state
    # written; ~5n^2 operations per token and head: r.S (2n^2), the decay
    # of S and the outer product k^T v added to it (3n^2)
    nbytes = 4.0 * (5 * B * T * H * n + H * n + B * H * n * n)
    wkv.update(bound(5.0 * n * n * B * T * H, nbytes))
    chunked_ms = time_ms(lambda: wkv_chunked(r, k, v, logw, u, chunk=32),
                         iters=10, warmup=2)
    print(f"  wkv6: kernel {wkv['ms']:.4f} ms (device "
          f"{wkv['device_ms']:.4f}), plain "
          f"{wkv['plain_ms']:.4f} ms, library none, bound "
          f"{wkv['bound_ms']:.4f} ms "
          f"({wkv['bound_by']}); the chunked form at chunk 32 "
          f"{chunked_ms:.4f} ms")
    wkv["device_ms_by_pass"] = pass_device_ms(
        kernel, ("wkv6_decay_kernel", "wkv6_scan_kernel"), calls=5)
    print("  wkv6 device ms by pass (torch.profiler, 5 calls): " + (
        ", ".join(f"{k} {t:.4f}" for k, t in wkv["device_ms_by_pass"].items())
        or "not measured (the profiler saw no device time)"))
    return att, cka, wkv


def cnn_cka_timing(gen) -> dict:
    """CKA's example route at the CNN probe shapes, on raw (uncentered)
    maps: one launch at MobileNetV2's stem map (n = 16, d = 131072) and a
    whole full-width probe pass of MobileNetV2 and of ResNet50 (one
    launch a map). Each is timed as the kernels (`_launch_example`), as
    the wrapper the loop calls (`cka_terms`: the same launch, two square
    roots and its checks) and as the plain version of the same function
    (`_prepare`, then `cka_terms_plain`), eager (`ms`) and on the card
    (`device_ms`), beside the bound of the least work (`example_bound`),
    with the card's time in each of the route's three passes under
    torch.profiler. At the stem also one `core.cka.cka(use_kernel=True)`
    call, which centers the maps in torch before the wrapper."""
    out = {}
    for arch in ("mobilenetv2", "resnet50"):
        dims = probe_dims(get_config(arch))
        maps = [_cka_inputs(gen, CNN_PROBE, d, d) for d in dims]
        runs = {"": cka_ops._launch_example, "wrapper_": cka_ops.cka_terms,
                "plain_": lambda x, y: cka_ops.cka_terms_plain(
                    cka_ops._prepare(x), cka_ops._prepare(y))}
        whole = dict(example_bound(dims), launches=len(dims))
        for key, run in runs.items():
            def one_pass(run=run):
                for x, y in maps:
                    run(x, y)
            whole[f"{key}ms"] = time_ms(one_pass, iters=10, warmup=2)
            whole[f"{key}device_ms"] = device_ms(one_pass, calls=2,
                                                 replays=5)
        whole["device_ms_by_pass"] = pass_device_ms(
            lambda: [cka_ops._launch_example(x, y) for x, y in maps],
            EXAMPLE_PASSES, calls=5)
        out[arch] = whole
        report_cnn_cka(f"a {arch} probe pass ({len(dims)} launches, d "
                       f"{min(dims)}-{max(dims)}, {sum(dims)} in all)", whole)
    stem = _cka_inputs(gen, CNN_PROBE, MBV2_STEM_D, MBV2_STEM_D)
    one = dict(example_bound([MBV2_STEM_D]), launches=1)
    for key, run in {"": lambda: cka_ops._launch_example(*stem),
                     "wrapper_": lambda: cka_ops.cka_terms(*stem),
                     "plain_": lambda: cka_ops.cka_terms_plain(
                         *(cka_ops._prepare(t) for t in stem)),
                     "core_cka_": lambda: core_cka(*stem, use_kernel=True)
                     }.items():
        one[f"{key}ms"] = time_ms(run)
        one[f"{key}device_ms"] = device_ms(run)
    one["device_ms_by_pass"] = pass_device_ms(
        lambda: cka_ops._launch_example(*stem), EXAMPLE_PASSES, calls=20)
    report_cnn_cka(f"one launch at n{CNN_PROBE} d{MBV2_STEM_D} (the "
                   f"MobileNetV2 stem)", one)
    print(f"  core.cka.cka(use_kernel=True) at the stem, which centers in "
          f"torch first: {one['core_cka_ms']:.4f} ms (device "
          f"{one['core_cka_device_ms']:.4f}) against the wrapper's "
          f"{one['wrapper_ms']:.4f} (device {one['wrapper_device_ms']:.4f})")
    return {"stem": one, "pass": out["mobilenetv2"],
            "resnet50_pass": out["resnet50"]}


def report_cnn_cka(name, t) -> None:
    by_pass = ", ".join(f"{k} {v:.4f}" for k, v in
                        t["device_ms_by_pass"].items()) or \
        "not measured (the profiler saw no device time)"
    print(f"  cka_terms example route, {name}: kernels {t['ms']:.4f} ms "
          f"(device {t['device_ms']:.4f}), wrapper {t['wrapper_ms']:.4f} "
          f"(device {t['wrapper_device_ms']:.4f}), plain {t['plain_ms']:.4f} "
          f"(device {t['plain_device_ms']:.4f}), bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}; device {t['device_ms'] / t['bound_ms']:.2f}x "
          f"the bound); device ms by pass (torch.profiler, summed over a "
          f"call's launches): {by_pass}")


def cudnn_deterministic_cost() -> dict:
    """What `resolve_device`'s deterministic cuDNN costs: an all-active
    full-width train step of each CNN, batch of 16 on the card, with
    cuDNN held to deterministic algorithms and free to take its default
    ones, in turns (on, off, on, off): the mean CUDA-event time of 10
    steps (the host's pace) and the card's busy time a step under
    torch.profiler (3 steps)."""
    out = {}
    for name in ("mobilenetv2", "resnet50"):
        model = build_model(get_config(name))
        params = model.init(torch.Generator().manual_seed(0))
        opt_cfg = AdamWConfig(lr=1e-3)
        state = make_optimizer_state(model, opt_cfg, params)
        step = TrainStepCache(model, opt_cfg).get(
            LayerFreezePlan((False,) * model.num_freeze_units))
        batch = as_tensor(loop_data(model.cfg.image_size)[0]
                          .scenarios[1].train_batches[0], model.device)
        times = {True: [], False: []}
        busy = {True: [], False: []}
        for det in (True, False, True, False):
            torch.backends.cudnn.deterministic = det
            step(params, state, batch)  # warm-up: algorithm choice
            times[det].append(time_ms(lambda: step(params, state, batch),
                                      iters=10, warmup=1))
            busy[det].append(busy_device_ms(
                lambda: step(params, state, batch), calls=3))
        torch.backends.cudnn.deterministic = True
        out[name] = {"deterministic_ms": float(np.mean(times[True])),
                     "default_ms": float(np.mean(times[False])),
                     "deterministic_device_ms": float(np.mean(busy[True])),
                     "default_device_ms": float(np.mean(busy[False]))}
        print(f"  {name} all-active train step, 2 turns each: cuDNN "
              f"deterministic {[round(t, 3) for t in times[True]]} ms of "
              f"CUDA events, {[round(t, 3) for t in busy[True]]} ms busy on "
              f"the card; default algorithms "
              f"{[round(t, 3) for t in times[False]]} ms, "
              f"{[round(t, 3) for t in busy[False]]} ms busy")
    return out


def busy_device_ms(run, calls: int) -> float:
    """The card's busy time a call of `run` (its kernels and copies,
    summed) over `calls` calls under torch.profiler; nan when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / calls if us else float("nan")


def example_bound(dims) -> dict:
    """The least time for the CKA terms of CNN_PROBE examples at feature
    dims `dims` (one X and one Y of d columns each): each input read once,
    three floats written a launch, against the example form's products,
    the upper triangles of XX^T and YY^T (2d n(n+1)/2 FMAs each) and their
    n(n+1)/2 entry products, as 3xTF32 as the kernel takes them."""
    n = CNN_PROBE
    tri = n * (n + 1) / 2
    flops = sum(2 * 2.0 * d * tri + 3 * 2 * tri for d in dims)
    nbytes = sum(4.0 * n * 2 * d + 4 * 3 for d in dims)
    return bound(flops, nbytes, tensor_cores=True)


def pass_device_ms(run, names, calls: int) -> dict:
    """The card's mean time a call in each of the kernels `names` (every
    kernel whose name holds it, summed), over `calls` calls of `run` under
    torch.profiler; a kernel the profiler records no device time for is
    left out."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    times = {name: sum(e.self_device_time_total for e in events
                       if name in e.key) / 1e3 / calls for name in names}
    return {name: t for name, t in times.items() if t > 0}


def profile_phase(deit, rwkv) -> None:
    """One more kernel run of each slice under torch.profiler: the
    device's busy share of the run's wall time and the kernels that fill
    it. For rwkv6-3b, one `ServeEngine.generate` call in bf16. Last, what
    deterministic cuDNN costs the CNNs' train step."""
    gen = torch.Generator().manual_seed(99)
    qt, kt, vt = (torch.randn(MAIN_ATT, generator=gen).cuda().transpose(1, 2)
                  .contiguous() for _ in range(3))
    F.scaled_dot_product_attention(qt, kt, vt)  # warm-up
    report_profile("10 x F.scaled_dot_product_attention fp32 [16,3,197,64]",
                   lambda: [F.scaled_dot_product_attention(qt, kt, vt)
                            for _ in range(10)])
    kmodel, _, common = slice_setup(deit)
    report_profile(deit.name, lambda: run_slice(kmodel, *common,
                                                use_kernel=True))
    kmodel, _, (params0, bench, events) = deit_setup(deit)
    report_profile(f"{deit.name} ETuner loop",
                   lambda: run_etuner(kmodel, bench, events,
                                      use_kernel=True))
    scale = {k: v for k, v in WORKLOAD_SCALE.items() if k != "batch_size"}
    benches = workload_benches(presets(seed=0, **scale)["single-poisson"],
                               kmodel.cfg)
    with CAPTURES:
        run_workload(kmodel, "single-poisson", benches, compiled=True)
    report_profile(f"{deit.name} single-poisson, compiled (graphs "
                   f"captured)", lambda: run_workload(
                       kmodel, "single-poisson", benches, compiled=True))
    report_profile(f"{deit.name} single-poisson, eager",
                   lambda: run_workload(kmodel, "single-poisson", benches,
                                        compiled=False))
    mbv2 = build_model(get_config("mobilenetv2"))
    mbv2_data = loop_data(mbv2.cfg.image_size)
    run_etuner(mbv2, *mbv2_data, use_kernel=True)  # warm-up
    report_profile("mobilenetv2 ETuner loop",
                   lambda: run_etuner(mbv2, *mbv2_data, use_kernel=True))
    opt_cfg = AdamWConfig(lr=1e-3)
    step = TrainStepCache(kmodel, opt_cfg).get(
        LayerFreezePlan((False,) * kmodel.num_freeze_units))
    batch = as_tensor(bench.scenarios[1].train_batches[0], kmodel.device)

    def steps(n):
        params, state = params0, make_optimizer_state(kmodel, opt_cfg,
                                                      params0)
        for _ in range(n):
            params, state, _ = step(params, state, batch)

    steps(2)  # warm-up outside the profiled window
    report_profile(f"{deit.name} 5 all-active train steps (batch on the "
                   f"card)", lambda: steps(5))
    kmodel, params = rwkv_model(rwkv, use_pallas=True)
    prompts = np.random.default_rng(0).integers(
        0, rwkv.vocab_size, MAIN_WKV[:2]).astype(np.int32)
    serve(kmodel, params, prompts)  # warm-up outside the profiled window
    report_profile(rwkv.name, lambda: serve(kmodel, params, prompts))
    cudnn_deterministic_cost()


def report_profile(name, run) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): operator rows repeat the
    # time of the kernels they launched
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print(f"  {name}: the profiler recorded no device time: busy share "
              f"not measured")
        return
    print(f"  {name} under the profiler: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / wall:.1f}% of "
          f"wall), {sum(r[2] for r in rows)} device kernels and copies")
    ours = {k: sum(r[0] for r in rows if k in r[1]) for k in PORT_KERNELS}
    ours = {k: us for k, us in ours.items() if us}
    if ours:
        print(f"    the port's kernels: {sum(ours.values()) / 1e3:.3f} ms, "
              f"{100 * sum(ours.values()) / busy_us:.2f}% of device time ("
              + ", ".join(f"{k} {100 * us / busy_us:.2f}%"
                          for k, us in ours.items()) + ")")
    # the top rows, and the port's own kernels wherever they rank
    for rank, (us, key, count) in enumerate(rows):
        if rank < 8 or any(k in key for k in PORT_KERNELS):
            print(f"    {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% "
                  f"x{count:<5d} {us / count / 1e3:8.4f} ms each  "
                  f"{key[:90]}")


def cka_record(cka) -> dict:
    """The CKA kernel's record on the MobileNetV2 loop, whose probes take
    the example route: a launch's mean over one full-width probe pass
    (`pass` holds the pass, `stem` its largest launch, `resnet50_pass`
    ResNet50's pass)."""
    cnn = cka["cnn"]
    whole, k = cnn["pass"], cnn["pass"]["launches"]
    return {"ms": whole["ms"] / k, "device_ms": whole["device_ms"] / k,
            "plain_ms": whole["plain_ms"] / k, "library_ms": None,
            "bound_ms": whole["bound_ms"] / k, "bound_by": whole["bound_by"],
            "pass": whole, "stem": cnn["stem"],
            "resnet50_pass": cnn["resnet50_pass"]}


def bound(flops: float, nbytes: float, tensor_cores: bool = False) -> dict:
    """The least time for `flops` fp32-accurate operations on `nbytes`
    bytes at the published peaks, two ways: fp32 FMAs on the CUDA cores,
    and 3xTF32 on the tensor cores (three TF32 products for each fp32
    one). `bound_ms` is the second for a kernel that runs 3xTF32
    (`tensor_cores`), else the first."""
    t_bytes = nbytes / PEAK_BYTES
    t_fp32 = flops / PEAK_FP32_FLOPS
    t_tc = 3 * flops / PEAK_TF32_FLOPS
    t_ops = t_tc if tensor_cores else t_fp32
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_kind": "3xTF32 tensor cores" if tensor_cores
            else "fp32 CUDA cores",
            "bound_fp32_ms": max(t_fp32, t_bytes) * 1e3,
            "bound_3xtf32_ms": max(t_tc, t_bytes) * 1e3}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run phase 5 (torch.profiler)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    card = card_line()
    print(f"card: {card}; driver {card_line('driver_version')}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build(KERNELS)
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    for name in KERNELS:
        build.load(name)
    print(f"  CUDA runtime mapped: {mapped_cudart()}")

    print("phase 2: kernels against their plain versions")
    att_err, cka_err, cnn_err, wkv_err = kernel_phase()
    print("phase 3: DeiT-tiny serving and SimFreeze probes at full width")
    launches = slice_phase(get_config("deit-tiny"))
    print("phase 3: the ETuner loop on DeiT-tiny at full width")
    loop_launches = etuner_phase(get_config("deit-tiny"))
    print("phase 3: the ETuner loop on MobileNetV2 at full width")
    mbv2_launches = cnn_loop_phase(get_config("mobilenetv2"), repeat=True)
    print("phase 3: the ETuner loop on ResNet50 at full width")
    resnet_launches = cnn_loop_phase(get_config("resnet50"), repeat=False)
    print("phase 3: the round hooks (fake-quant 8 bits, SimSiam 0.5) on "
          "MobileNetV2 at full width")
    hooks_phase(get_config("mobilenetv2"))
    print("phase 3: the compiled hot path at full width (CUDA graphs)")
    with CAPTURES:
        compiled_launches = compiled_phase()
    print("phase 3: rwkv6-3b serving at full width and depth")
    rwkv = get_config("rwkv6-3b")
    wkv_launches = rwkv_phase(rwkv)
    print("phase 4: timing at the main-path shapes (CUDA events)")
    att, cka, wkv = timing_phase()
    cka_feature = {k: v for k, v in cka.items() if k != "cnn"}
    if args.profile:
        print("phase 5: where the slices' time goes (torch.profiler)")
        profile_phase(get_config("deit-tiny"), rwkv)

    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:80",
         "launches": loop_launches["flash_attention"],
         "launches_by_path": {
             "etuner_loop": loop_launches["flash_attention"],
             "serving_and_probes": launches["flash_attention"],
             **{f"compiled {name}": n["flash_attention"]
                for name, n in compiled_launches.items()
                if n["flash_attention"]}},
         "max_abs_err": att_err, **att},
        {"name": "cka_terms", "route": "cuda",
         "source": "src/repro_torch/csrc/cka_terms.cu",
         "replaces": "src/repro/kernels/cka/kernel.py:56",
         "launches": mbv2_launches["cka_terms"],
         "launches_by_path": {
             "cnn_loop_mobilenetv2": mbv2_launches["cka_terms"],
             "cnn_loop_resnet50": resnet_launches["cka_terms"],
             "etuner_loop": loop_launches["cka_terms"],
             "serving_and_probes": launches["cka_terms"],
             **{f"compiled {name}": n["cka_terms"]
                for name, n in compiled_launches.items()}},
         "launches_by_route": {
             route: sum(p[f"cka_{route}"] for p in (
                 mbv2_launches, resnet_launches, loop_launches, launches))
             for route in ("feature", "example")},
         "max_abs_err": cnn_err, **cka_record(cka),
         "feature_route": {"max_abs_err": cka_err, **cka_feature}},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv/kernel.py:58",
         "launches": wkv_launches,
         "launches_by_path": {"rwkv6_serving": wkv_launches},
         "max_abs_err": wkv_err, **wkv},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
