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
   at head sizes 16, 32 and 64; flash attention at head dims 16-256,
   at gemma2-2b's heads (8 query and 4 kv heads of 256, causal, softcap
   50, with and without a window of 96) and granite's MQA (48 query heads
   over one kv head of 128), and at bert-base's shapes
   (the mixed loop's [16, 32, 12, 64], serving's [8, 512, 12, 64] and a
   ragged [4, 77, 12, 64]) and CKA's example route at its probe shape
   (n = 512, d = 768) and a ragged n = 500, also held to float64; and two
   launches that agree bit for bit
   for flash attention, both CKA routes (the example route also at
   n = 16, d = 131072 and 262144) and WKV6 (at 4 prompts and at one);
3. the MoE and mamba LMs, first, since the later phases keep ~20 GiB on
   the card: qwen3-moe-30b-a3b serving at full width and depth
   (`moe_phase`: 48 layers, d=2048, 32 query and 4 kv heads of 128, a
   128-expert top-8 MoE FFN of 768 on every layer, bf16, 3.0532e10
   params drawn on the card from seed 0, count held) on 4 prompts of 512
   tokens for 16 greedy steps, with the flash kernel on its prefill (48
   launches, causal, GQA; no CKA or WKV6 launch), timed, with its peak
   memory, a repeat choosing the same tokens, and plain (no launch); each
   run records its MoE routing and prints the (token, expert) pairs
   dropped over capacity and whether kernel and plain dropped the same;
   the bf16 pair is not held, as its runs route differently; then the
   pair in fp32 at full width with depth cut to 8 layers, held within
   1e-3 on the rows both runs routed alike and on every row with the
   kernel run on the plain run's routing; then jamba
   (`mamba_phase`): its Mamba-1 block alone at full width (d 8192,
   d_inner 16384, state 16) in fp32 on 4 x 512 tokens (4 chunks),
   timed, its first 256 positions against a 256-token prefill and the
   decode of token 256 after a 255-token prefill against that prefill's
   last position, within 1e-3 (the bf16 gaps printed), and the reduced
   jamba (8 layers: 7 mamba, one attention, MoE every other layer)
   served, one flash launch a prefill, its fp32 kernel/plain pair within
   1e-3;
   then LM training (`train_lm_phase`) through the train_lm example's
   step builder (`repro_torch.examples.train_lm.make_step`: `grads_of`
   then AdamW at lr 3e-3 on its cosine schedule) on its synthetic Markov
   batches: gemma2-2b at full width and depth in bf16 (`remat="full"`,
   the config's) on 4 x 512 tokens, 3 steps all active (no kernel
   launch: every forward needs a backward), then 3 under the example's
   half-prefix plan (6 of 13 groups and the embedding frozen), whose 12
   frozen layers take flash (exactly 12 launches a step); each step's
   loss, CUDA-event time and tokens/s, each plan's peak memory, one step
   split into its gradients and AdamW's update, the peak memory of the
   forward and backward under remat "full" and "none" and of a whole step
   without remat; the bf16 gap between the kernel and plain routes,
   printed; then one async `CheckpointManager.save` of the whole state
   (15.7 GB, into a temporary directory, the free space printed first)
   while the uninterrupted run takes its next step, `restore_latest`
   into fresh tensors, every leaf bitwise the saved one, and the same
   step from the restored state, whose loss must be bitwise the
   uninterrupted one's (the caller's blocked seconds, the background
   write and the restore printed); then the pair in fp32 at full width
   with 8 of the 26 layers (2 of 4 groups frozen, 4 flash launches a
   step), loss and every gradient leaf within 1e-3; then rwkv6-3b at full
   width with 4 of its 32 layers on 4 x 32 tokens (one chunk, where
   ROADMAP C.4's clamp does not bite): an all-active step that launches
   nothing and does not raise, a half-prefix step with 2 WKV6 launches,
   and its fp32 pair within 1e-3;
   then the slice phase at full width: DeiT-tiny (`get_config("deit-tiny")`,
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
   runtime's `TrainStepCache` steps), its FLOPs (the whole step by XLA's
   rules, `runtime/flops.py`: XLA's count of the reference's step less
   the work XLA's fusion recomputes, ROADMAP C.8) and
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
   then the paper's baselines (`baselines_phase`): Table V's methods
   (LazyTune, Egeria, SlimFit, RigL, Ekya and ETuner) and Table VII's
   `static4` on full-width MobileNetV2 at the loops' size, each through
   the front door with its controller injected (the parameters of
   `benchmarks/common.py::make_controller`; RigL's model wrapped), with
   the kernels and plain: the two runs bitwise equal (served logits,
   final params, plans) and CKA launched once a map of a SimFreeze probe
   pass, on the example route; Egeria's probes take plain CKA, as in the
   reference, and launch nothing. It prints each method's rounds, plans,
   accuracy, modeled time and energy (Ekya's with its profiling charge),
   CKA launches and loop time;
   then the paper's harness through its entry points (`harness_phase`):
   Table II's four methods through `repro_torch.harness.common.run_method`
   on full-width MobileNetV2 (20 freeze units) on `run_method`'s own `nc`
   stream at its defaults with the kernels, and `etuner` again plain (its
   row equal to the kernel row to the bit; CKA launched only under the
   SimFreeze methods; the card's busy share over the kernel `etuner` run
   from torch.profiler); Table IV's `etuner` row on reduced bert-base
   with the kernels and plain (equal rows, flash launched); the workloads
   sweep (`harness.workloads.sweep`) at `--quick` scale on `two-stream`
   and `qos` for immed and etuner, compiled, under the kernels, its
   document valid and the priority-weighted `qos` cell favoring the
   priority-2 stream (fewer rounds, lower p95); and the quickstart with
   its sanity check. It prints each row, the launches, the busy share and
   the phase's wall time;
   then the compiled hot path (`compiled_phase`): DeiT-tiny (flash
   attention on; depth cut to `COMPILED_DEIT_LAYERS` of its 12 layers,
   so the fleet fits the script's time) on the `single-poisson` and
   preemptible `qos` workload presets and MobileNetV2 on
   `single-poisson`, through
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
   then bert-base serving at full width (`bert_serving_phase`: 12 layers,
   d=768, vocab 30522, seeded params; 20news batches of 8 requests at its
   512 positions, with the kernel and plain: logits within attention's
   tolerance, maps within it relative to each map's largest entry, 12
   flash launches a call); then the two-slot
   `mixed` preset at full width (`mixed_phase`: MobileNetV2 at 128x128
   with 50 classes for the cv stream beside bert-base with 20 classes for
   the 20news stream, in one `ModelPool` injected into
   `ContinualRuntime.from_config`, each slot with the loops' ETuner
   policies and its own controller, at the loops' size), compiled,
   compiled with `segment=False`, eager, compiled again and eager with
   the plain paths, all exactly equal with both slots' final params
   bitwise equal; the eager kernel run launches flash attention 12 times
   a bert predict or features call and none in a train step, CKA 13
   times a bert probe pass and 19 times a MobileNetV2 one, all on the
   example route; it prints per-slot step times by plan, rounds/s, swaps
   and peak memory, then runs compiled under a budget that holds one
   slot at a time (swaps charged, the budget honoured);
   then the multi-device fleet (`fleet_phase`) on full-width MobileNetV2:
   24 of the `fleet` preset's 120 light streams (3 scenarios of 3
   batches of 16, 12 requests each) on three devices
   (`fleet_devices(3, seed=0, speed_spread=0.4)`) under least-loaded
   routing with merges every 25 s of the timeline; 12 of them on the
   same three and a fourth device five times slower under static
   routing, which the straggler tracker evicts; and `two-stream` on two
   devices with a 40 J battery (thermal cap 26 C) under the battery
   throttle policy. Each runs compiled, compiled with `segment=False`,
   eager and eager plain (least-loaded also compiled again, warm), all
   exactly equal (the result with every device's attribution, plans,
   merges, deferrals, every device's final params bitwise); it prints
   merges, syncs, evictions, deferrals, each device's DVFS time and CKA
   launches, rounds/s, requests/s and peak memory;
   then live telemetry (`telemetry_phase`): the least-loaded session
   once more, compiled, on the same model and streams with
   `TelemetrySpec(enabled=True, trace_jsonl=..., chrome_trace=...)` into
   a temporary directory: bitwise its untraced compiled run (results,
   plans, merges, every device's params) with the same CKA launches; the
   metrics reconcile with the ledger below 1e-9 in all nine (dimension,
   field) entries, each device's spans over `obs.DEVICE_TIME_CATS` sum to
   its ledger time within 1e-6, one round span a round; the JSONL sink
   reads back as the run's events and the Chrome trace loads with one
   track a device, a stream and the fleet. It prints the events by
   category, the counters' totals, the gauges and the loop's rounds/s
   traced against the untraced warm run (the host's cost of tracing);
   then the battery session with a Chrome trace, bitwise its untraced
   run, whose trace must carry both devices' temperature and
   state-of-charge counter tracks, gauge events and throttle marks;
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
   then gemma2-2b serving at full width and depth (`lm_phase`:
   `get_config("gemma2-2b")`, 26 layers, d=2304, 8 query and 4 kv heads
   of 256, bf16, 2.61e9 params from a seeded CUDA generator) on the same
   4 prompts of 512 tokens for 16 greedy steps, with the flash kernel on
   its prefill (`use_pallas`: 26 launches, causal, window 4096 on the
   local layers, softcap 50, GQA; no CKA or WKV6 launch), timed, and
   plain (no launch); the same pair in fp32 (10.5 GB), held as rwkv6's
   is, and one fp32 prompt of 8192 tokens, past attn_chunk (the plain
   path is the blockwise one) and past the local layers' window, kernel
   against plain within 1e-3 (26 launches);
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
   its two passes (the decay pass and the scan); flash attention at
   bert-base's two shapes beside SDPA and CKA's example route at its
   probe shape (`bert_timing`); flash attention at gemma2-2b's prefill
   shapes (`gemma_timing`: [4, 512, 8/4, 256] causal with softcap 50,
   and one 8192-token prompt with and without the 4096 window) on bf16
   inputs, as the main path passes them, beside the bound of the
   unmasked pairs' work in bf16 and SDPA's causal time without the
   softcap, a different function (no PyTorch call has the softcap), and
   the fp32 function (fp32 inputs) beside its 3xTF32 bound; flash at
   qwen3-moe-30b-a3b's prefill shape (`qwen3_timing`: [4, 512, 32/4, 128]
   causal) on bf16 inputs against `bf16_bound`, beside SDPA
   (`is_causal`, `enable_gqa`), which computes the same function there
   and is held to the plain version within 3e-2;
   the DeiT-tiny slice's requests per second and rwkv6-3b's and
   gemma2-2b's prefill and decode tokens per second;
5. only with --profile: one more kernel run of each slice under
   torch.profiler (the DeiT-tiny slice, the ETuner loops on DeiT-tiny and
   MobileNetV2, the DeiT-tiny `single-poisson` session and the `mixed`
   session compiled, their graphs captured, and eager, one rwkv6-3b
   `generate`), for
   the device's busy share of its wall time, the kernels that fill it
   and the port's kernels' share of it, one SDPA call at the flash
   main-path shape, for the name of the kernel PyTorch runs there, and
   the cost of deterministic cuDNN:
   a full-width CNN train step with `resolve_device`'s deterministic
   algorithms and with cuDNN's default ones, in turns.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. A kernel's `launches` there is the
count of its newest path (CKA: the MobileNetV2 loop; flash attention: the
eager mixed loop, whose shape [16, 32, 12, 64] its times there are, with
serving's shape under `bert_serving` and DeiT-tiny's under `deit_tiny`;
WKV6: rwkv6-3b serving), and `launches_by_path` has every path's count
(gemma2-2b's serving and 8192-token prefills under `gemma2_serving` and
`gemma2_long`, its shapes' times under `gemma2`; qwen3-moe's bf16 and
fp32 prefills and the reduced jamba's under `qwen3_moe_serving`,
`qwen3_moe_fp32` and `jamba_reduced`, qwen3's shape's times, its serving
run and the jamba runs under `qwen3_moe`; gemma2-2b's bf16 training run's
launches, all in its half-prefix steps, under `gemma2_train`, its fp32
pair's under `gemma2_train_fp32` and the training run's numbers under
`gemma2`'s `training_run`; WKV6's in rwkv6-3b's half-prefix step under
`rwkv6_train`). CKA's times there are those of that path, a launch's mean
over a MobileNetV2 probe pass (with the pass, the stem launch and
ResNet50's pass in full); its DeiT-tiny feature-route numbers are under
`feature_route`, its bert-base probe shape's under `bert_probe`.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import tree_leaves, tree_map  # noqa: E402
from repro_torch.baselines import (  # noqa: E402
    make_controller, profiling_charge)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.cka import cka as core_cka  # noqa: E402
from repro_torch.core.cka import cka_feature_form  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.freeze_plan import LayerFreezePlan  # noqa: E402
from repro_torch.core.policies import (  # noqa: E402
    PolicySpec, etuner_stack_spec)
from repro_torch.core.simfreeze import SimFreeze, SimFreezeConfig  # noqa: E402
from repro_torch.data.arrivals import build_timeline  # noqa: E402
from repro_torch.data.streams import REGISTRY, nc_benchmark  # noqa: E402
from repro_torch.distributed.straggler import StragglerConfig  # noqa: E402
from repro_torch.env import EnvSpec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention import ops as att_ops  # noqa: E402
from repro_torch.kernels.cka import ops as cka_ops  # noqa: E402
from repro_torch.kernels.rwkv import ops as wkv_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import TelemetrySpec  # noqa: E402
from repro_torch.examples import quickstart, train_lm  # noqa: E402
from repro_torch.harness import common as harness_common  # noqa: E402
from repro_torch.harness import workloads as harness_workloads  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update, cosine_schedule)
from repro_torch.runtime import config as config_mod  # noqa: E402
from repro_torch.runtime import fleet as fleet_mod  # noqa: E402
from repro_torch.runtime.config import (  # noqa: E402
    DeviceConfig, HookSpec, RuntimeConfig, SlotConfig)
from repro_torch.runtime.continual import ContinualRuntime  # noqa: E402
from repro_torch.runtime.costmodel import EdgeCostModel  # noqa: E402
from repro_torch.runtime.device import DeviceRuntime  # noqa: E402
from repro_torch.runtime import flops as flops_mod  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.executor import (  # noqa: E402
    FineTuneExecutor, SimSiamHook)
from repro_torch.runtime.inference import InferenceServer  # noqa: E402
from repro_torch.runtime.ledger import CostLedger  # noqa: E402
from repro_torch.runtime.modelpool import ModelPool, ModelSlot  # noqa: E402
from repro_torch.runtime.scheduler import EventScheduler  # noqa: E402
from repro_torch.runtime.serve import ServeEngine  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainStepCache, as_tensor, compiled_model, grads_of,
    make_optimizer_state)
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
# cores, dense TF32 and bf16 on the tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# main-path shapes: DeiT-tiny at 224x224 (197 tokens, 3 heads of 64) on a
# 16-image batch; the CKA probe flattens [16, 197, 192] to 3152 x 192
MAIN_ATT = (16, 197, 3, 64)
MAIN_CKA = (16 * 197, 192)
# rwkv6-3b prefill: 4 prompts of 512 tokens, 40 heads of 64
MAIN_WKV = (4, 512, 40, 64)
DECODE_STEPS = 16
# gemma2-2b prefill: 4 prompts of 512 tokens, 8 query heads of 256 over 4
# kv heads, causal, softcap 50 (B, S, Hq, Hkv, hd); one prompt of 8192
# tokens, past attn_chunk (2048: the plain path is the blockwise one) and
# past the 4096 window of the 13 local layers
GEMMA_ATT = (4, 512, 8, 4, 256)
GEMMA_LONG = 8192
GEMMA_SOFTCAP = 50.0
GEMMA_WINDOW = 4096
# qwen3-moe-30b-a3b prefill: 4 prompts of 512 tokens, 32 query heads of 128
# over 4 kv heads, causal (B, S, Hq, Hkv, hd); its 48 layers' params in
# bf16 (the count of the reference's init); the fp32 kernel/plain pair at
# full width with its depth cut to 8 layers (48 would take 122 GB)
QWEN3_ATT = (4, 512, 32, 4, 128)
QWEN3_PARAMS = 3.0532e10
QWEN3_FP32_LAYERS = 8
# jamba's mamba block alone at full width: a prefill of 4 x 512 tokens (4
# chunks of 128); the decode check's lengths, 255 + 1 against 256, the
# nearest to 512 that the chunks split (ROADMAP C.11)
JAMBA_BLOCK = (4, 512)
JAMBA_DECODE_AT = 256
# LM training (`train_lm_phase`): gemma2-2b at full width and depth in bf16
# on the train_lm example's synthetic batches of 4 x 512 tokens, steps all
# active, then under the half-prefix plan (6 of 13 groups, 12 layers, and
# the embedding), whose forwards take flash; its fp32 kernel/plain pair at
# full width with depth cut to 8 layers (4 groups, 2 frozen); rwkv6-3b at
# full width with 4 of its 32 layers on 24 tokens, one chunk of the
# chunked form, short enough that ROADMAP C.4's clamp does not bite (the
# CPU tests hold it against JAX at 16)
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = (3, 3)
TRAIN_FP32_LAYERS = 8
RWKV_TRAIN = (4, 24)
# the rwkv6-3b kernel/plain pair and prefill/decode check, run in fp32
# (rwkv_phase says why)
PAIR_TOL = 1e-3
# a gradient leaf is held at PAIR_TOL x its largest |g| plus this, so that
# a leaf that is zero in both runs (a frozen one) passes
GRAD_FLOOR = 1e-9
THRESHOLD = 0.01
INFER_BATCH = 16
# bert-base (12 heads of 64, d = 768): the mixed loop's 20news batches of
# 16 x 32 tokens, serving at its 512 positions, a ragged length; a probe
# map [16, 32, 768] flattens to 512 x 768 (dx + dy > n: the example
# route) and a ragged n beside it
BERT_LOOP_ATT = (16, 32, 12, 64)
BERT_SERVE_ATT = (8, 512, 12, 64)
BERT_RAGGED_ATT = (4, 77, 12, 64)
BERT_CKA = (16 * 32, 768)
BERT_RAGGED_CKA = (500, 768)
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
              aligned=True, hold64=False) -> float:
    """The wrapper, which must take the route of its rule, and `routes`
    called directly (the example route on the raw inputs, which it
    centers itself, the feature route on centered ones), against the plain
    version; returns the wrapper's max_abs_err. `offset` and `aligned` as
    `_cka_inputs` and `_misaligned` make the inputs. With `hold64` the
    wrapper is also held to float64 within CKA's tolerance."""
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
    off64 = _rel_err(got, exact)
    if hold64 and not off64 < CKA_RTOL:
        raise AssertionError(f"cka n{n} dx{dx} dy{dy}: {off64:.3g} off "
                             f"float64, limit {CKA_RTOL:g}")
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
    for hd in att_ops.HEAD_DIMS:
        check_attention(gen, 2, 130, 4, 4, hd)
    # the LMs: gemma2-2b's heads (8 q / 4 kv of 256, causal, softcap 50),
    # with a window; granite's MQA (48 q heads over one kv head of 128)
    lm_att_err = max(
        check_attention(gen, 2, 256, 8, 4, 256, causal=True,
                        softcap=GEMMA_SOFTCAP),
        check_attention(gen, 2, 256, 8, 4, 256, causal=True, window=96,
                        softcap=GEMMA_SOFTCAP),
        check_attention(gen, 2, 256, 48, 1, 128, causal=True))
    # qwen3-moe-30b-a3b's prefill: 32 q / 4 kv heads of 128, causal
    qwen3_att_err = check_attention(gen, *QWEN3_ATT, causal=True)
    q, k, v = (torch.randn(MAIN_ATT, generator=gen).cuda() for _ in range(3))
    first = att_ops.flash_attention(q, k, v, causal=False)
    second = att_ops.flash_attention(q, k, v, causal=False)
    if not torch.equal(first, second):
        raise AssertionError("two flash launches differ")
    print("  flash: two launches agree bit for bit")
    # bert-base: the mixed loop's shape, serving's, a ragged length
    bert_att_err = max(check_attention(gen, B, S, H, H, hd)
                       for B, S, H, hd in (BERT_LOOP_ATT, BERT_SERVE_ATT,
                                           BERT_RAGGED_ATT))

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
    # bert-base's probe maps (the mixed loop) and a ragged n: the example
    # route, against the plain version and float64
    bert_cka_err = max(check_cka(gen, n, d, d, routes=("example",),
                                 hold64=True)
                       for n, d in (BERT_CKA, BERT_RAGGED_CKA))

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
    return (att_err, cka_err, cnn_err, wkv_err, bert_att_err, bert_cka_err,
            lm_att_err, qwen3_att_err)


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
              f"max {np.max(ms):.3f}; {others}); the whole step "
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
#: DeiT-tiny's depth in the compiled phase, cut from 12 so the whole
#: script, with the fleet phase, stays near half its time limit; the
#: DeiT-tiny serving and loop phases keep all 12 layers
COMPILED_DEIT_LAYERS = 6
COMPILED_SESSIONS = (("deit-tiny", "single-poisson", False),
                     ("deit-tiny", "qos", True),
                     ("mobilenetv2", "single-poisson", False))
# the runtime-API calls by which the host starts work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync")


def workload_benches(spec, cfg) -> dict:
    """`runtime.config.materialize_stream_benchmarks` at the model's image
    size, with the loops' 50 classes and 16-image batches; a 20news
    stream gets bert-base's 20 classes in sequences of 32 tokens."""
    out = {}
    for i, ss in enumerate(spec.streams):
        kw = dict(num_scenarios=spec.num_scenarios + 1,
                  batches=max(ss.batches_per_scenario, 2), batch_size=16,
                  seed=13 * i)
        if ss.benchmark == "20news":
            out[i] = text_bench(get_config("bert-base"), seq_len=32, **kw)
        else:
            out[i] = REGISTRY[ss.benchmark](
                num_classes=50, image_size=cfg.image_size, **kw)
    return out


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
    out["predict"] = fullest_trace(lambda: graphed.predict(params, probe))
    out["probe"] = fullest_trace(lambda: sf._all_cka(params))
    return out


def fullest_trace(run, tries: int = 3) -> dict:
    """`host_launches(run, 1)` of the trace, of `tries`, that holds the
    most flash and CKA kernels. A trace can miss a kernel's record (one
    trace of a graphed predict held 10 of its 12 flash kernels, in one
    of seven runs of this check on an H100), and none adds one, so the
    fullest trace is the one the exact counts are held to."""
    return max((host_launches(run, 1) for _ in range(tries)),
               key=lambda c: (c["flash"], c["cka"]))


def compiled_phase() -> dict:
    """Each session of `COMPILED_SESSIONS` at full width (DeiT-tiny at
    `COMPILED_DEIT_LAYERS` layers) four ways:
    compiled, compiled with `segment=False`, eager (`compiled=False`) and
    compiled again (every graph already captured: the warm compiled run).
    All four must give the same rounds, plans, recompiles, preemptions,
    accuracies, validation curve and ledger totals, and bitwise equal
    final params. Returns the flash and CKA launches the card ran, by
    session."""
    CAPTURES.graphs.clear()
    models = {"deit-tiny": build_model(get_config("deit-tiny").replace(
        use_pallas=True, num_layers=COMPILED_DEIT_LAYERS)),
        "mobilenetv2": build_model(get_config("mobilenetv2"))}
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


# ---------------------------------------------------------------------------
# phase 3: bert-base serving at full width


def text_bench(cfg, *, num_scenarios, batches, batch_size, seq_len, seed):
    """The 20news stream for bert-base `cfg`: its classes split evenly over
    the scenarios."""
    return REGISTRY["20news"](num_classes=cfg.num_classes,
                              num_scenarios=num_scenarios, batches=batches,
                              batch_size=batch_size, seq_len=seq_len,
                              seed=seed)


def bert_serving_phase() -> dict:
    """Full-width bert-base (`get_config("bert-base")`, 12 layers, d=768,
    vocab 30522, 20 classes) with params from a seeded `torch.Generator`,
    serving 20news batches of 8 requests at its 512 positions and one
    `features` call, with the kernel (`use_pallas`) and with the plain
    attention: logits within attention's tolerance, maps within it
    relative to each map's largest entry, 12 flash launches a call, no
    CKA. Returns the launches and the kernel run's
    requests per second beside the plain run's."""
    cfg = get_config("bert-base")
    kmodel = build_model(cfg.replace(use_pallas=True))
    pmodel = build_model(cfg)
    params = kmodel.init(torch.Generator().manual_seed(0))
    B, S = BERT_SERVE_ATT[:2]
    bench = text_bench(cfg, num_scenarios=4, batches=4, batch_size=B,
                       seq_len=S, seed=7)
    batches = [as_tensor(b, kmodel.device)
               for b in bench.scenarios[1].train_batches]
    zero_launches()
    got = [kmodel.predict(params, b) for b in batches]
    got_maps = kmodel.features(params, batches[0])
    launches = read_launches()
    want = [pmodel.predict(params, b) for b in batches]
    want_maps = pmodel.features(params, batches[0])
    torch.cuda.synchronize()
    L = cfg.num_layers
    calls = len(batches) + 1
    print(f"  {len(batches)} predict calls on [{B}, {S}] tokens and one "
          f"features call ({len(got_maps)} maps): launches flash_attention "
          f"{launches['flash_attention']} (expected {L} x {calls}), "
          f"cka_terms {launches['cka_terms']}")
    if launches["flash_attention"] != L * calls or launches["cka_terms"] \
            or launches["wkv6"] or len(got_maps) != L + 1:
        raise AssertionError(f"unexpected launch counts {launches}")
    err = 0.0
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=ATT_RTOL, atol=ATT_ATOL)
        err = max(err, float((a - b).abs().max()))
    # the maps leave a LayerNorm each (entries up to ~10, after 12 blocks
    # of kernel against plain attention): held at attention's tolerance
    # relative to each map's largest entry
    map_err = 0.0
    for a, b in zip(got_maps, want_maps, strict=True):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=ATT_RTOL,
                                   atol=ATT_ATOL * scale)
        map_err = max(map_err, float((a - b).abs().max()) / scale)
    if not all(bool(torch.isfinite(t).all()) for t in got + got_maps) or \
            got[0].shape != (B, cfg.num_classes):
        raise AssertionError(f"bert-base logits of shape "
                             f"{tuple(got[0].shape)}, or not finite")
    kern_ms = time_ms(lambda: kmodel.predict(params, batches[0]), iters=10,
                      warmup=2)
    plain_ms = time_ms(lambda: pmodel.predict(params, batches[0]), iters=10,
                       warmup=2)
    print(f"  kernel and plain runs agree: logits within "
          f"{ATT_RTOL}/{ATT_ATOL} (max_abs_err {err:.3g}), maps within "
          f"{ATT_RTOL}/{ATT_ATOL} of each map's largest entry (max_abs_err "
          f"{map_err:.3g} of it); a predict call "
          f"{kern_ms:.3f} ms with the kernel ({B * 1e3 / kern_ms:.1f} "
          f"requests/s), {plain_ms:.3f} ms plain ({B * 1e3 / plain_ms:.1f})")
    return {"launches": launches["flash_attention"], "max_abs_err": err,
            "predict_ms": kern_ms, "plain_predict_ms": plain_ms}


# ---------------------------------------------------------------------------
# phase 3: the two-slot `mixed` session at full width


def mixed_models(use_kernel: bool) -> dict:
    """The `mixed` preset's slots at full width: MobileNetV2 (128x128, 50
    classes) for the cv stream, bert-base (20 classes) for the nlp one,
    the attention kernel on with `use_kernel`."""
    return {"cv": build_model(get_config("mobilenetv2")),
            "nlp": build_model(get_config("bert-base").replace(
                use_pallas=use_kernel))}


class _SlotSteps:
    """While installed, times every train step (eager) or fused call
    (compiled) of every `TrainStepCache` with CUDA events, by (model,
    plan), and records the eager steps that launched a port kernel."""

    def __init__(self, compiled: bool):
        self.compiled = compiled
        self.spans: dict = {}
        self.in_step: list = []
        self._raw = TrainStepCache._raw_step
        self._fused = TrainStepCache.fused_call

    def _span(self, cache, plan, start, end, steps):
        key = (cache.model.cfg.name, plan.layers)
        self.spans.setdefault(key, []).append((start, end, steps))

    def __enter__(self):
        spy = self

        def fused_call(cache, plan, params, opt_state, batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = spy._fused(cache, plan, params, opt_state, batches)
            end.record()
            spy._span(cache, plan, start, end, len(batches))
            return out

        def raw_step(cache, plan):
            step = spy._raw(cache, plan)

            def run(*args):
                before = read_launches()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args)
                end.record()
                spy._span(cache, plan, start, end, 1)
                if read_launches() != before:
                    spy.in_step.append((cache.model.cfg.name, plan.layers))
                return out
            return run

        if self.compiled:
            TrainStepCache.fused_call = fused_call
        else:
            TrainStepCache._raw_step = raw_step
        return self

    def __exit__(self, *exc):
        TrainStepCache._raw_step = self._raw
        TrainStepCache.fused_call = self._fused

    def ms(self) -> dict:
        """(model, plan) -> (ms a batch, batches)."""
        out = {}
        for key, sp in self.spans.items():
            n = sum(k for _, _, k in sp)
            out[key] = (sum(s.elapsed_time(e) for s, e, _ in sp) / n, n)
        return out


def run_mixed(models, benches, *, compiled, segment=True, budget=0.0,
              use_kernel=True):
    """One `mixed` session through the port's front door with an injected
    two-slot `ModelPool` of the full-width `models`, the loops' ETuner
    policies per slot (each slot's controller from the config's policy
    stack, as a config-built pool gets it), the kernels with
    `use_kernel`, at `WORKLOAD_SCALE`. Eager runs count each slot's
    predict and features calls; every run counts each slot's probe
    passes, times its train steps by plan and reads its swaps, loop wall
    time and peak device memory."""
    cfg = RuntimeConfig(
        slots={m: SlotConfig(arch=models[m].cfg.name,
                             policies=ETUNER_POLICIES) for m in models},
        workload="mixed", workload_scale=dict(WORKLOAD_SCALE), seed=0,
        pretrain_epochs=1, replay_batches=2, use_pallas=use_kernel,
        compiled=compiled, memory_budget_mb=budget)
    calls = {m: {"predict": 0, "features": 0, "passes": 0} for m in models}

    def counted(slot, name, fn):
        def call(*args):
            calls[slot][name] += 1
            return fn(*args)
        return call

    slot_models = {}
    for m, model in models.items():
        if compiled:
            model = compiled_model(model)
        else:
            model = dataclasses.replace(
                model, predict=counted(m, "predict", model.predict),
                features=counted(m, "features", model.features))
        slot_models[m] = model
    pool = ModelPool([ModelSlot(m, slot_models[m], benches[i])
                      for i, m in enumerate(models)],
                     memory_budget_mb=budget)

    def controller(name):
        ctrl = config_mod._slot_policies(cfg, cfg.slots[name]).build(
            pool.slot(name).model)
        sf = getattr(ctrl.freeze, "simfreeze", None)
        if sf is not None:
            sf._all_cka = counted(name, "passes", sf._all_cka)
        return ctrl

    rt = ContinualRuntime.from_config(
        cfg, device=models["cv"].device, model_pool=pool,
        stream_benchmarks=benches, controller_factory=controller)
    rt.segment = segment
    plans = []
    execute_round = FineTuneExecutor.execute_round

    def spy_round(ex, plan, *a, **k):
        if ex.buffers.get(k.get("stream", 0)):
            plans.append((ex.model_name, plan.layers))
        return execute_round(ex, plan, *a, **k)

    FineTuneExecutor.execute_round = spy_round
    fleet_mod.EventScheduler = _LoopClock
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark = CAPTURES.mark()
    t0 = time.perf_counter()
    try:
        with _SlotSteps(compiled) as steps:
            res = rt.run()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step_ms = steps.ms()
    finally:
        fleet_mod.EventScheduler = EventScheduler
        FineTuneExecutor.execute_round = execute_round
    device = rt.fleet.devices[0]
    params = {m: device.slots[m].executor.params for m in models}
    if sorted(res.per_model) != sorted(models) or len(plans) != res.rounds \
            or not all(res.per_model[m]["rounds"]
                       and res.per_model[m]["inferences"] for m in models) \
            or len(res.inference_accs) != sum(
                e.kind == "inference" for e in rt.session_events):
        raise AssertionError(f"{res.rounds} rounds, {len(plans)} plans, "
                             f"per slot {res.per_model}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)) \
            or not np.isfinite(res.total_time_s):
        raise AssertionError("non-finite params or ledger")
    return {"res": res, "plans": plans, "params": params, "calls": calls,
            "launches": read_launches(), "in_step": steps.in_step,
            "step_ms": step_ms, "pool": pool,
            "card_flash": CAPTURES.card_launches("flash_attention", mark),
            "captured": CAPTURES.graphs[mark[0]:],
            "loop_s": t2 - rt.scheduler.started,
            "pretrain_s": rt.scheduler.started - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def mixed_phase() -> dict:
    """The `mixed` preset at full width, MobileNetV2 beside bert-base on
    one card, unbudgeted: compiled, compiled with `segment=False`, eager,
    compiled again (all four exactly equal: rounds, plans, recompiles,
    swaps, accuracies, validation curve, ledger totals, per-slot
    attribution; both slots' final params bitwise equal) and eager with
    the plain paths (bitwise the eager kernel run); then compiled under a
    budget that holds one slot at a time (the pool swaps and charges
    it). The eager kernel run launches flash attention 12 times a bert
    predict or features call and CKA once a map of a probe pass (13 on
    bert, 19 on MobileNetV2), all on the example route, none inside a
    train step. Returns the launches by path."""
    scale = {k: v for k, v in WORKLOAD_SCALE.items() if k != "batch_size"}
    spec = presets(seed=0, **scale)["mixed"]
    kmodels, pmodels = mixed_models(True), mixed_models(False)
    pmodels["cv"] = kmodels["cv"]
    benches = workload_benches(spec, kmodels["cv"].cfg)
    if benches[1].modality != "text":
        raise AssertionError("the mixed preset's second stream is not text")
    runs = {}
    for label, kw in (("compiled", dict(compiled=True)),
                      ("compiled, segment=False",
                       dict(compiled=True, segment=False)),
                      ("eager", dict(compiled=False)),
                      ("compiled again", dict(compiled=True))):
        runs[label] = run_mixed(kmodels, benches, **kw)
    plain = run_mixed(pmodels, benches, compiled=False, use_kernel=False)
    first, eager = runs["compiled"], runs["eager"]
    res = first["res"]
    per = {m: (int(v["rounds"]), int(v["inferences"]))
           for m, v in res.per_model.items()}
    print(f"  {res.rounds} rounds, {res.recompiles} recompiles, {res.swaps} "
          f"swaps, {len(res.inference_accs)} requests; (rounds, requests) "
          f"by slot {per}; controller stats {res.controller_stats}")
    for m in kmodels:
        plans = ["".join("F" if f else "." for f in p)
                 for slot, p in first["plans"] if slot == m]
        print(f"    {m} freeze plans: {plans}")
    for label, run in (*runs.items(), ("plain", plain)):
        diff = same_session(first, run)
        if run is not first and run["res"].swaps != res.swaps:
            diff.append("swaps")
        if diff:
            raise AssertionError(f"mixed: the {label} run differs from the "
                                 f"compiled run in {diff}")
    print("    compiled, compiled segment=False, eager, compiled again and "
          "the plain eager run agree exactly: rounds, plans, recompiles, "
          "swaps, accuracies, validation curve, ledger totals, per-slot "
          "attribution; both slots' final params bitwise equal")
    launches, calls = eager["launches"], eager["calls"]
    L = kmodels["nlp"].cfg.num_layers
    maps = {m: kmodels[m].num_freeze_units - 1 for m in kmodels}
    forwards = calls["nlp"]["predict"] + calls["nlp"]["features"]
    want_cka = sum(maps[m] * calls[m]["passes"] for m in kmodels)
    print(f"    eager run: bert {calls['nlp']['predict']} predict and "
          f"{calls['nlp']['features']} features calls, "
          f"{calls['nlp']['passes']} probe passes; MobileNetV2 "
          f"{calls['cv']['passes']} probe passes; launches flash_attention "
          f"{launches['flash_attention']} (expected {L} x {forwards}), "
          f"cka_terms {launches['cka_terms']} (expected {maps['nlp']} x "
          f"{calls['nlp']['passes']} + {maps['cv']} x "
          f"{calls['cv']['passes']}; example route "
          f"{launches['cka_example']}); in train steps: "
          f"{len(eager['in_step'])} steps launched a kernel")
    if launches["flash_attention"] != L * forwards or not forwards or \
            launches["cka_terms"] != want_cka or \
            not calls["nlp"]["passes"] or not calls["cv"]["passes"] or \
            launches["cka_example"] != launches["cka_terms"] or \
            launches["wkv6"] or eager["in_step"] or plain["in_step"] or \
            any(plain["launches"].values()):
        raise AssertionError(f"mixed: unexpected launch counts {launches}, "
                             f"plain run {plain['launches']}")
    flash = first["card_flash"]
    print(f"    compiled run: flash_attention {flash} on the card inside "
          f"graphs (captures x replays), cka_terms "
          f"{first['launches']['cka_terms']} (eager, between replays); "
          f"{len(first['captured'])} captures in "
          f"{sum(t for _, t, _ in first['captured']):.3f} s of host time")
    if not flash or flash % L or \
            first["launches"]["cka_terms"] != launches["cka_terms"]:
        raise AssertionError("mixed: unexpected compiled launch counts")
    for (name, plan), (ms, n) in sorted(eager["step_ms"].items()):
        line = (f"    {name} plan {''.join('F' if f else '.' for f in plan)}"
                f": eager {ms:.3f} ms a step ({n} steps)")
        for label in ("compiled again", "compiled"):
            got = runs[label]["step_ms"].get((name, plan))
            if got:
                line += f"; {label} {got[0]:.3f} ms a batch ({got[1]} batches)"
        print(line)
    for label, run in (*runs.items(), ("plain eager", plain)):
        print(f"    {label}: loop {run['loop_s']:.3f} s "
              f"({run['res'].rounds / run['loop_s']:.3f} rounds/s), "
              f"pretraining {run['pretrain_s']:.3f} s, {run['res'].swaps} "
              f"swaps, peak device memory {run['peak_gb']:.2f} GB "
              f"allocated, {run['reserved_gb']:.2f} GB reserved")
    mem = {m: eager["pool"].memory_of(m) for m in kmodels}
    budget = max(mem.values()) + min(mem.values()) / 2
    tight = run_mixed(kmodels, benches, compiled=True, budget=budget)
    tres = tight["res"]
    swaps = {m: int(v["swaps"]) for m, v in tres.per_model.items()}
    print(f"    budget {budget:.1f} MB (slots {mem['cv']:.1f} and "
          f"{mem['nlp']:.1f} MB, params and optimizer state), compiled: "
          f"{tres.rounds} rounds, {tres.swaps} swaps {swaps}, t_swap "
          f"{tres.breakdown.get('t_swap', 0.0):.4g} s, e_swap "
          f"{tres.breakdown.get('e_swap', 0.0):.4g} J; modeled time "
          f"{tres.total_time_s:.6g} s against {res.total_time_s:.6g} s "
          f"unbudgeted; loop {tight['loop_s']:.3f} s "
          f"({tres.rounds / tight['loop_s']:.3f} rounds/s)")
    if res.swaps or not tres.swaps or sum(swaps.values()) != tres.swaps \
            or not tres.breakdown.get("t_swap") \
            or not tres.breakdown.get("e_swap") \
            or tight["pool"].resident_mb > budget \
            or not tres.total_time_s > res.total_time_s:
        raise AssertionError(f"mixed: the budget did not swap as it must: "
                             f"{tres.swaps} swaps, {tres.breakdown}")
    return {"flash_eager": launches["flash_attention"],
            "cka_eager": launches["cka_terms"], "flash_card": flash}


# ---------------------------------------------------------------------------
# phase 3: the paper's baselines (Table V) at full width


#: Table V's methods and Table VII's `static4`
TABLE_V = ("lazytune", "egeria", "slimfit", "rigl", "ekya", "etuner",
           "static4")


class _Probes:
    """While installed, counts SimFreeze probe passes (one features call
    and a CKA for every map), whichever controller runs them."""

    def __init__(self):
        self.passes = 0
        self._orig = SimFreeze._all_cka

    def __enter__(self):
        spy = self

        def all_cka(sf, *args):
            spy.passes += 1
            return spy._orig(sf, *args)

        SimFreeze._all_cka = all_cka
        return self

    def __exit__(self, *exc):
        SimFreeze._all_cka = self._orig


def run_method(model, bench, events, method: str, *, use_kernel: bool):
    """One Table V method on the loops' data through the port's front
    door (`run_method` of `benchmarks/common.py`: the controller
    injected, RigL's model wrapped; one pretraining epoch, as the loops),
    with the kernels (`use_pallas`) or plain. Records every round's plan,
    the served logits, the probe passes and Ekya's post-run profiling
    charge."""
    ctrl = make_controller(model, method, use_kernel=use_kernel)
    rt = ContinualRuntime.from_config(
        RuntimeConfig(slots={"default": SlotConfig(arch=model.cfg.name)},
                      seed=0, pretrain_epochs=1, replay_batches=2,
                      use_pallas=use_kernel),
        device=model.device,
        model=ctrl.wrap_model() if method == "rigl" else model,
        benchmark=bench, controller=ctrl)
    plans, logits_out = [], []
    inference_served = ctrl.inference_served

    def served(logits):
        logits_out.append(logits.copy())
        return inference_served(logits)

    ctrl.inference_served = served
    execute_round = FineTuneExecutor.execute_round

    def spy_round(ex, plan, *a, **k):
        if ex.buffers.get(k.get("stream", 0)):
            plans.append(plan.layers)
        return execute_round(ex, plan, *a, **k)

    FineTuneExecutor.execute_round = spy_round
    fleet_mod.EventScheduler = _LoopClock
    try:
        with _Probes() as probes:
            res = rt.run(events)
    finally:
        fleet_mod.EventScheduler = EventScheduler
        FineTuneExecutor.execute_round = execute_round
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - rt.scheduler.started
    params = rt.fleet.devices[0].primary.executor.params
    if not res.rounds or len(plans) != res.rounds or \
            len(logits_out) != len(res.inference_accs) or \
            not all(np.isfinite(lg).all() for lg in logits_out) or \
            not all(bool(torch.isfinite(t).all())
                    for t in tree_leaves(params)):
        raise AssertionError(f"{method}: {res.rounds} rounds, {len(plans)} "
                             f"plans, {len(logits_out)} logits")
    time_s, energy_j = profiling_charge(ctrl, res.rounds, res.total_time_s,
                                        res.total_energy_j)
    profile = getattr(ctrl, "profile_rounds", 0)
    return {"res": res, "plans": plans, "logits": logits_out,
            "params": params, "passes": probes.passes, "ctrl": ctrl,
            "profile_rounds": profile, "time_s": time_s,
            "energy_j": energy_j, "loop_s": loop_s}


def same_method(a, b) -> list:
    """What differs between two runs of one method (empty: nothing)."""
    ra, rb = a["res"], b["res"]
    out = [k for k in ("rounds", "recompiles", "controller_stats",
                       "inference_accs", "val_curve", "total_time_s",
                       "total_energy_j", "compute_tflops")
           if getattr(ra, k) != getattr(rb, k)]
    out += [k for k in ("plans", "passes", "profile_rounds") if a[k] != b[k]]
    if not bitwise_equal(a, b):
        out.append("served logits or final params")
    return out


def baselines_phase() -> dict:
    """Table V's methods and `static4` on full-width MobileNetV2 at the
    loops' size, each with the kernels and plain: the two runs bitwise
    equal (final params, served logits, plans). CKA launches once a
    feature map of a SimFreeze probe pass, on the example route; Egeria's
    probes take plain CKA (as in the reference) and launch nothing.
    Returns the CKA launches of each method's kernel run."""
    model = build_model(get_config("mobilenetv2"))
    bench, events = loop_data(model.cfg.image_size)
    maps = model.num_freeze_units - 1
    out = {}
    for method in TABLE_V:
        zero_launches()
        kern = run_method(model, bench, events, method, use_kernel=True)
        launches = read_launches()
        zero_launches()
        plain = run_method(model, bench, events, method, use_kernel=False)
        if any(read_launches().values()):
            raise AssertionError(f"{method}: the plain run launched a kernel")
        diff = same_method(kern, plain)
        if diff:
            raise AssertionError(f"{method}: the plain run differs in {diff}")
        res, ctrl = kern["res"], kern["ctrl"]
        egeria = sum(len(h) for h in getattr(ctrl, "_hist", ()))
        frozen = ["".join("F" if f else "." for f in p)
                  for p in dict.fromkeys(kern["plans"])]
        print(f"  {method}: {res.rounds} rounds, {res.recompiles} "
              f"recompiles, plans {frozen}; mean accuracy "
              f"{np.mean(res.inference_accs):.4f}; modeled "
              f"{kern['time_s']:.6g} s, {kern['energy_j']:.6g} J"
              + (f" ({kern['profile_rounds']} profiling rounds charged)"
                 if method == "ekya" else "")
              + f"; CKA launches {launches['cka_terms']} ({kern['passes']} "
              f"probe passes x {maps} maps; example route "
              f"{launches['cka_example']})"
              + (f", {egeria} plain CKA probes" if method == "egeria" else "")
              + f"; loop {kern['loop_s']:.3f} s "
              f"({res.rounds / kern['loop_s']:.3f} rounds/s), plain "
              f"{plain['loop_s']:.3f} s")
        if launches["cka_terms"] != maps * kern["passes"] or \
                launches["cka_example"] != launches["cka_terms"] or \
                launches["flash_attention"] or launches["wkv6"] or \
                (method == "etuner") != bool(launches["cka_terms"]) or \
                (method == "egeria" and not egeria):
            raise AssertionError(f"{method}: unexpected launches {launches}")
        if method == "rigl":
            entries = ctrl.traced_masks.items()
            dens = [float(m.float().mean()) for m in tree_leaves(ctrl.masks)
                    if m.dim() >= 2]
            print(f"    RigL masks: mean density of the kernels "
                  f"{np.mean(dens):.4f}; the masks its programs read "
                  f"(C.9): {[(k[0], m is not None) for k, m in entries]}")
            # eager: the train steps' one entry, traced in pretraining,
            # before the masks existed
            if not 0.35 < np.mean(dens) < 0.65 or \
                    any(m is not None for m in ctrl.traced_masks.values()):
                raise AssertionError("RigL: unexpected masks")
        out[method] = launches["cka_terms"]
    print("  every method's plain run agrees with its kernel run: rounds, "
          "plans, stats, accuracies, validation curve, ledger; served "
          "logits and final params bitwise equal")
    return out


# ---------------------------------------------------------------------------
# phase 3: the paper's harness (Tables II and IV, the workloads sweep, the
# quickstart) through its own entry points


#: Table II's four methods
TABLE_II = ("immed", "lazytune", "simfreeze", "etuner")
#: the sweep's cells on the card: presets and methods, at --quick scale
HARNESS_SWEEP = (("two-stream", "qos"), ("immed", "etuner"))


def busy_run(fn):
    """`fn()` under torch.profiler: (its result, the wall seconds, the
    seconds the card was busy with its kernels and copies; nan when the
    profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    # the raw device events: `key_averages()` first builds a Python
    # object for every event of the run, which a whole session makes slow
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA)
    return out, wall, ns / 1e9 if ns else float("nan")


def flop_count_times() -> None:
    """Host time of one whole-step FLOP count (`TrainStepCache.flops`, on
    meta tensors) at full width, batch 16: with the op memo of
    `runtime/flops.py` emptied first (a process's first count of the
    model), for a freshly built model's count of the same plan, and for
    another plan (half the units frozen)."""
    for arch in ("mobilenetv2", "deit-tiny"):
        cfg = get_config(arch)
        n = cfg.image_size
        batch = {"images": np.zeros((16, n, n, 3), np.float32),
                 "labels": np.zeros(16, np.int32)}
        units = build_model(cfg).num_freeze_units
        half = LayerFreezePlan((True,) * (units // 2)
                               + (False,) * (units - units // 2))
        active = LayerFreezePlan((False,) * units)
        flops_mod._MEMO.clear()
        times = []
        for plan in (active, active, half):
            cache = TrainStepCache(build_model(cfg), AdamWConfig(lr=1e-3))
            t = time.perf_counter()
            cache.flops(plan, batch)
            times.append(time.perf_counter() - t)
        print(f"  whole-step FLOP count, {arch} at full width (host): "
              f"{times[0]:.3f} s first, {times[1]:.3f} s for a new model, "
              f"{times[2]:.3f} s for another plan")


def print_row(name: str, row: dict, launches: dict, wall: float) -> None:
    print(f"  {name} {row['arch']}/{row['bench']}/{row['method']}: acc "
          f"{row['acc']:.6f}, modeled {row['time_s']:.6g} s, "
          f"{row['energy_j']:.6g} J, {row['tflops']:.6g} TFLOPs, "
          f"{row['rounds']:.0f} rounds; launches: CKA "
          f"{launches['cka_terms']} (example route "
          f"{launches['cka_example']}), flash "
          f"{launches['flash_attention']}; wall {wall:.2f} s")


def harness_phase() -> dict:
    """The paper's harness on the card, through its entry points
    (`repro_torch.harness`, `repro_torch.examples.quickstart`):

    - Table II's four methods through `harness.common.run_method` on
      full-width MobileNetV2 (`model_cfg=get_config("mobilenetv2")`, 20
      freeze units) on `run_method`'s own `nc` stream at its defaults,
      with the kernels (`use_pallas`); then `etuner` plain: its row
      equal to the kernel row to the bit. CKA launches only under the
      SimFreeze methods; the card's busy share over the kernel `etuner`
      run, which runs under torch.profiler.
    - Table IV's `etuner` row on reduced bert-base (its 4 scenarios of 8
      batches) with the kernels and plain: the rows equal to the bit,
      flash launched in its forwards.
    - The workloads sweep at `--quick` scale on `two-stream` and `qos`
      for immed and etuner, compiled, under the kernels: its document
      passes `validate_bench(min_workloads=2)`, and in the preemptible
      priority-weighted `qos` cell the priority-2 stream runs fewer
      rounds with a lower p95 than the bulk stream.
    - The quickstart, with its sanity check.

    Returns the phase's launches by path."""
    t_phase = time.perf_counter()
    flop_count_times()
    cfg = get_config("mobilenetv2")
    assert build_model(cfg).num_freeze_units == 20
    rows, launches, walls, out = {}, {}, {}, {}
    for method in TABLE_II:
        zero_launches()
        t = time.perf_counter()
        run = functools.partial(harness_common.run_method, "mobilenetv2",
                                "nc", method, model_cfg=cfg, use_pallas=True)
        if method == "etuner":  # under torch.profiler, for its busy share
            rows[method], wall, busy = busy_run(run)
            print(f"  Table II etuner (kernels) under torch.profiler: the "
                  f"card busy {busy:.3f} s, {busy / wall:.4f} of the "
                  f"run's {wall:.3f} s wall")
        else:
            rows[method] = run()
        walls[method] = time.perf_counter() - t
        launches[method] = read_launches()
        print_row("Table II", rows[method], launches[method], walls[method])
        freezes = method in ("simfreeze", "etuner")
        if bool(launches[method]["cka_terms"]) != freezes or \
                launches[method]["flash_attention"] or \
                launches[method]["wkv6"]:
            raise AssertionError(f"Table II {method}: unexpected launches "
                                 f"{launches[method]}")
    zero_launches()
    t = time.perf_counter()
    plain = harness_common.run_method("mobilenetv2", "nc", "etuner",
                                      model_cfg=cfg, use_pallas=False)
    print_row("Table II plain", plain, read_launches(),
              time.perf_counter() - t)
    if any(read_launches().values()) or plain != rows["etuner"]:
        raise AssertionError(f"Table II etuner: the plain row {plain} is not "
                             f"the kernel row {rows['etuner']}")
    out["table2"] = {m: n["cka_terms"] for m, n in launches.items()}

    bert = {}
    for use_pallas in (True, False):
        zero_launches()
        t = time.perf_counter()
        bert[use_pallas] = harness_common.run_method(
            "bert-base", "20news", "etuner", scenarios=4, batches=8,
            use_pallas=use_pallas)
        bert_launches = read_launches()
        print_row("Table IV" + ("" if use_pallas else " plain"),
                  bert[use_pallas], bert_launches, time.perf_counter() - t)
        if use_pallas:
            out["table4"] = bert_launches["flash_attention"]
            if not bert_launches["flash_attention"]:
                raise AssertionError("Table IV: flash never launched")
        elif any(bert_launches.values()):
            raise AssertionError("Table IV: the plain run launched a kernel")
    if bert[True] != bert[False]:
        raise AssertionError(f"Table IV etuner: kernel row {bert[True]} and "
                             f"plain row {bert[False]} differ")

    zero_launches()
    t = time.perf_counter()
    with CAPTURES:
        mark = CAPTURES.mark()
        names, methods = HARNESS_SWEEP
        doc = harness_workloads.sweep(quick=True, workload_names=names,
                                      methods=methods, use_pallas=True)
        sweep_launches = read_launches()
        in_graphs = CAPTURES.card_launches("flash_attention", mark)
    errors = harness_workloads.validate_bench(doc, min_workloads=2,
                                              methods=methods)
    if errors:
        raise AssertionError(f"the sweep's document is invalid: {errors}")
    cell = next(c for c in doc["cells"] if c["workload"] == "qos"
                and c["preemptible"]
                and c["trigger_policy"] == "priority-weighted")
    per = cell["per_stream"]
    prio = {sid: doc["workloads"]["qos"]["streams"][int(sid)]["priority"]
            for sid in per}
    hi, lo = max(prio, key=prio.get), min(prio, key=prio.get)
    if prio[hi] != 2:
        raise AssertionError(f"qos: stream priorities {prio}")
    print(f"  sweep: {len(doc['cells'])} cells on {sorted(doc['workloads'])}"
          f" in {time.perf_counter() - t:.1f} s, the document valid; CKA "
          f"launches {sweep_launches['cka_terms']}, flash "
          f"{sweep_launches['flash_attention']} eager and {in_graphs} in "
          f"graphs; qos/etuner/pw (preemptible): stream {hi} "
          f"{per[hi]['rounds']:.0f} rounds, p95 {per[hi]['latency_p95']:.4f}"
          f" s; stream {lo} {per[lo]['rounds']:.0f} rounds, p95 "
          f"{per[lo]['latency_p95']:.4f} s")
    if not (per[hi]["rounds"] < per[lo]["rounds"]
            and per[hi]["latency_p95"] < per[lo]["latency_p95"]):
        raise AssertionError("the priority-weighted trigger did not favor "
                             "the priority-2 stream")
    out["sweep"] = sweep_launches["cka_terms"]

    t = time.perf_counter()
    results = quickstart.main([])
    failed = quickstart.sanity(results)
    if failed:
        raise AssertionError(f"quickstart: {failed}")
    (imm, _), (et, et_rt) = results["Immediate"], results["ETuner"]
    print(f"  quickstart in {time.perf_counter() - t:.1f} s: ETuner "
          f"{et.total_time_s:.6g} s / {et.total_energy_j:.6g} J against "
          f"Immediate's {imm.total_time_s:.6g} s / {imm.total_energy_j:.6g}"
          f" J, {et_rt.controller.stats()['freezes']} freezes, "
          f"{et.recompiles} recompiles: the sanity check holds")
    print(f"  harness phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 3: the multi-device fleet and its environment at full width


BATTERY_J = 40.0


def fleet_sessions() -> dict:
    """The fleet sessions: the `fleet` preset's light camera streams on
    three heterogeneous devices under least-loaded routing with merges
    every 25 s of the timeline; on the same three and a device five times
    slower, which the straggler tracker evicts; `two-stream` on two
    devices on a finite battery under the battery throttle policy.
    `streams` cuts the preset's 120 streams (`FLEET_STREAMS`); `warm`
    adds a second compiled run, whose loop is the fleet's throughput."""
    three = fleet_mod.fleet_devices(3, seed=0, speed_spread=0.4)
    battery = EnvSpec(battery_capacity_j=BATTERY_J, thermal_cap_c=26.0)
    return {
        "least-loaded": dict(workload="fleet", devices=three,
                             streams=FLEET_STREAMS["least-loaded"],
                             routing="least-loaded", aggregate_every=25.0,
                             warm=True),
        "straggler": dict(
            workload="fleet",
            devices=three + (DeviceConfig("slow", speed_scale=0.2),),
            streams=FLEET_STREAMS["straggler"],
            routing="static", aggregate_every=10.0,
            straggler=StragglerConfig(min_samples=1, slow_factor=1.5,
                                      evict_after=2)),
        "battery": dict(workload="two-stream",
                        devices=(DeviceConfig("dev0", env=battery),
                                 DeviceConfig("dev1", env=battery)),
                        routing="static", aggregate_every=50.0,
                        throttle=True)}


#: the `fleet` preset's streams, cut from its 120 to what the script's
#: time allows: every session runs four or five ways for its equality
#: checks, two of them eager at ~3 rounds/s. Each stream is a light
#: camera stream at the loops' knobs: 3 scenarios of 3 batches of 16, 12
#: requests. Least-loaded routing and the merges are the throughput
#: cell; the straggler session needs only enough streams to load the
#: slow device before its eviction.
FLEET_STREAMS = {"least-loaded": 24, "straggler": 12}


class _DeviceLaunches:
    """While installed, adds the CKA launches made inside each fleet
    device's handlers to that device's count."""

    HANDLERS = ("on_data", "on_inference", "on_probe", "on_scenario_change",
                "settle", "trailing_flush")

    def __init__(self):
        self.by_device: dict = {}
        self._depth = 0
        self._orig = {n: getattr(DeviceRuntime, n) for n in self.HANDLERS}

    def __enter__(self):
        spy = self
        for name, orig in self._orig.items():
            def handler(dev, *args, _orig=orig, **kw):
                if spy._depth:
                    return _orig(dev, *args, **kw)
                spy._depth += 1
                before = cka_ops.cka_terms.launches
                try:
                    return _orig(dev, *args, **kw)
                finally:
                    spy._depth -= 1
                    spy.by_device[dev.name] = spy.by_device.get(
                        dev.name, 0) + cka_ops.cka_terms.launches - before
            setattr(DeviceRuntime, name, handler)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(DeviceRuntime, name, orig)


def run_fleet(model, name, benches, *, compiled, segment=True,
              use_kernel=True, telemetry=None):
    """One fleet session of `fleet_sessions` through the port's front
    door on the injected full-width `model`, with the loops' ETuner
    policies (and the battery throttle where the session has one), and
    `telemetry` (a `TelemetrySpec`; off by default). Records the plans,
    the merges the fleet made, the deferrals, each device's CKA launches
    and final params, the loop's wall time and peak device memory."""
    s = fleet_sessions()[name]
    policies = dataclasses.replace(
        ETUNER_POLICIES, throttle=PolicySpec("battery")) \
        if s.get("throttle") else ETUNER_POLICIES
    scale = dict(WORKLOAD_SCALE)
    if s["workload"] == "fleet":
        scale["fleet_streams"] = s["streams"]
    cfg = RuntimeConfig(
        slots={"cv": SlotConfig(arch=model.cfg.name, policies=policies)},
        workload=s["workload"], workload_scale=scale, seed=0,
        pretrain_epochs=1, replay_batches=2, use_pallas=use_kernel,
        compiled=compiled, devices=s["devices"], routing=s["routing"],
        aggregate_every=s["aggregate_every"],
        telemetry=telemetry or TelemetrySpec())
    rt = ContinualRuntime.from_config(cfg, device=model.device, model=model,
                                      stream_benchmarks=benches)
    rt.segment = segment
    rt.straggler_config = s.get("straggler")
    plans, merges = [], []
    execute_round = FineTuneExecutor.execute_round
    merge = fleet_mod.DeviceFleet._merge

    def spy_round(ex, plan, *a, **k):
        if ex.buffers.get(k.get("stream", 0)):
            plans.append((ex.device_name, plan.layers))
        return execute_round(ex, plan, *a, **k)

    def spy_merge(fleet, ts):
        before = fleet.ledger.syncs
        merge(fleet, ts)
        if fleet.ledger.syncs > before:
            merges.append(ts)

    FineTuneExecutor.execute_round = spy_round
    fleet_mod.DeviceFleet._merge = spy_merge
    fleet_mod.EventScheduler = _LoopClock
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with _Probes() as probes, _DeviceLaunches() as per_device:
            res = rt.run()
    finally:
        fleet_mod.EventScheduler = EventScheduler
        fleet_mod.DeviceFleet._merge = merge
        FineTuneExecutor.execute_round = execute_round
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fl = rt.fleet
    params = {d.name: d.primary.executor.params for d in fl.devices}
    ctrls = {id(c): c for c in fl.controllers.values()}.values()
    deferrals = sum(c.throttle.stats().get("throttle_deferred", 0)
                    for c in ctrls)
    if not res.rounds or len(plans) != res.rounds or \
            len(res.inference_accs) != sum(e.kind == "inference"
                                           for e in rt.session_events):
        raise AssertionError(f"{name}: {res.rounds} rounds, {len(plans)} "
                             f"plans, {len(res.inference_accs)} requests")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)) \
            or not np.isfinite(res.total_time_s):
        raise AssertionError(f"{name}: non-finite params or ledger")
    for dim in (res.per_stream, res.per_model, res.per_device):
        for key, total in (("time_s", res.total_time_s),
                           ("energy_j", res.total_energy_j)):
            if not math.isclose(sum(v[key] for v in dim.values()), total,
                                rel_tol=1e-9):
                raise AssertionError(f"{name}: {key} attributions do not "
                                     f"sum to the total")
    return {"res": res, "plans": plans, "merges": merges, "params": params,
            "deferrals": deferrals, "passes": probes.passes,
            "launches": read_launches(), "cka_by_device": per_device.by_device,
            "assignment": dict(fl.assignment), "telemetry": rt.telemetry,
            "loop_s": t2 - rt.scheduler.started,
            "pretrain_s": rt.scheduler.started - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def same_fleet(a, b) -> list:
    """What differs between two runs of one fleet session (empty:
    nothing): the run result with every attribution, the plans, merges,
    deferrals, probe passes, stream assignment and every device's final
    params, bit for bit."""
    ra, rb = a["res"], b["res"]
    out = [k for k in ("rounds", "recompiles", "syncs", "swaps",
                       "preemptions", "probes", "controller_stats",
                       "inference_accs", "val_curve", "total_time_s",
                       "total_energy_j", "compute_tflops", "per_stream",
                       "per_model", "per_device")
           if getattr(ra, k) != getattr(rb, k)]
    out += [k for k in ("plans", "merges", "deferrals", "passes",
                        "assignment") if a[k] != b[k]]
    if not all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a["params"]), tree_leaves(b["params"]),
            strict=True)):
        out.append("final params")
    return out


def fleet_phase() -> tuple:
    """Each session of `fleet_sessions` on full-width MobileNetV2, four
    ways: compiled, compiled with `segment=False`, eager and eager with
    the plain paths, and compiled again (warm) where the session says so.
    All exactly equal (the run result with every device's attribution,
    plans, merges, deferrals, every device's final params bitwise); the
    kernel runs launch CKA once a map of a probe pass on the example
    route, on the devices that ran the rounds. Returns each session's CKA
    launches by device, and for `telemetry_phase` the model and each
    session's streams and compiled runs."""
    model = build_model(get_config("mobilenetv2"))
    maps = model.num_freeze_units - 1
    base = {k: v for k, v in WORKLOAD_SCALE.items() if k != "batch_size"}
    # the preset's stream i does not depend on the stream count, so every
    # fleet session takes a prefix of one set of streams (~1 s of host
    # time a stream to draw)
    fleet = workload_benches(presets(
        seed=0, fleet_streams=max(FLEET_STREAMS.values()),
        **base)["fleet"], model.cfg)
    out, kept = {}, {"model": model}
    for name, s in fleet_sessions().items():
        if s["workload"] == "fleet":
            benches = {i: fleet[i] for i in range(s["streams"])}
        else:
            benches = workload_benches(
                presets(seed=0, **base)[s["workload"]], model.cfg)
        ways = [("compiled", dict(compiled=True)),
                ("compiled, segment=False",
                 dict(compiled=True, segment=False)),
                ("eager", dict(compiled=False))]
        if s.get("warm"):
            ways.append(("compiled again", dict(compiled=True)))
        ways.append(("plain eager", dict(compiled=False, use_kernel=False)))
        runs = {label: run_fleet(model, name, benches, **kw)
                for label, kw in ways}
        first = runs["compiled"]
        for label, run in runs.items():
            diff = same_fleet(first, run)
            if diff:
                raise AssertionError(f"fleet {name}: the {label} run "
                                     f"differs from the compiled run in "
                                     f"{diff}")
        if any(runs["plain eager"]["launches"].values()):
            raise AssertionError(f"fleet {name}: the plain run launched "
                                 f"a kernel")
        res, launches = first["res"], first["launches"]
        by_device = first["cka_by_device"]
        devices = res.per_device
        print(f"  {name}: {len(devices)} devices "
              f"{[d.name for d in s['devices']]}, {len(benches)} streams, "
              f"{res.rounds} rounds, {len(first['merges'])} merges "
              f"(t = {first['merges']}), {res.syncs} syncs, "
              f"{sum(v['evicted'] for v in devices.values()):.0f} "
              f"evictions, {first['deferrals']} deferrals; "
              f"{len(res.inference_accs)} requests, mean accuracy "
              f"{np.mean(res.inference_accs):.4f}; modeled "
              f"{res.total_time_s:.6g} s, {res.total_energy_j:.6g} J")
        for dev, cell in devices.items():
            print(f"    {dev}: streams {cell['streams']:.0f}, rounds "
                  f"{cell['rounds']:.0f}, syncs {cell['syncs']:.0f}, "
                  f"evicted {cell['evicted']:.0f}, battery dead "
                  f"{cell['battery_dead']:.0f}, DVFS time "
                  f"{cell['throttle_s']:.6g} s, energy "
                  f"{cell['energy_j']:.6g} J, utilization "
                  f"{cell['utilization']:.4f}; CKA launches "
                  f"{by_device.get(dev, 0)}")
        print(f"    CKA launches {launches['cka_terms']} ({first['passes']} "
              f"probe passes x {maps} maps; example route "
              f"{launches['cka_example']}), the same in every kernel run")
        for label, run in runs.items():
            print(f"    {label}: loop {run['loop_s']:.3f} s "
                  f"({run['res'].rounds / run['loop_s']:.3f} rounds/s, "
                  f"{len(res.inference_accs) / run['loop_s']:.2f} "
                  f"requests/s), pretraining {run['pretrain_s']:.3f} s, "
                  f"peak device memory {run['peak_gb']:.2f} GB")
        if launches["cka_terms"] != maps * first["passes"] or \
                not launches["cka_terms"] or \
                launches["cka_example"] != launches["cka_terms"] or \
                sum(by_device.values()) != launches["cka_terms"] or \
                any(run["launches"] != launches
                    for label, run in runs.items() if label != "plain eager"):
            raise AssertionError(f"fleet {name}: unexpected launches "
                                 f"{launches}, by device {by_device}")
        if name == "least-loaded" and (len(first["merges"]) < 2 or any(
                not v["syncs"] for v in devices.values())):
            raise AssertionError("fleet: fewer than two merges")
        if name == "straggler" and (not devices["slow"]["evicted"] or
                                    devices["slow"]["streams"] or sum(
                                        v["streams"] for v in
                                        devices.values()) != len(benches)):
            raise AssertionError("fleet: the slow device was not evicted")
        if name == "battery":
            engaged = first["deferrals"] or any(
                v["throttle_s"] or v["battery_dead"] or v["evicted"]
                for v in devices.values())
            if not engaged or any(v["energy_j"] > BATTERY_J + 1e-6
                                  for v in devices.values()):
                raise AssertionError("fleet: the battery did not throttle "
                                     "within its budget")
        out[name] = by_device
        kept[name] = dict(benches=benches, runs={
            label: runs[label] for label in ("compiled", "compiled again")
            if label in runs})
    print("  compiled, compiled segment=False, eager, plain eager (and "
          "compiled again) agree exactly in every session: results, every "
          "device's attribution, plans, merges, deferrals; every device's "
          "final params bitwise equal")
    return out, kept


# ---------------------------------------------------------------------------
# phase 3: live telemetry on the fleet


def counter_totals(snapshot: dict) -> dict:
    """Each counter's total over one of its label dimensions (a charge
    bumps its stream's, its model's and its device's counters alike, so
    summing every key would count it three times)."""
    keys: dict = {}
    for key, value in snapshot["counters"].items():
        name, _, labels = key.partition("{")
        dim = labels.split("=")[0] if labels else ""
        keys.setdefault(name, {}).setdefault(dim, []).append(value)
    out = {}
    for name, dims in sorted(keys.items()):
        dim = next(d for d in ("device", "kind", "stream", "model", "")
                   if d in dims)
        out[name] = sum(dims[dim])
    return out


def check_traced(name: str, off: dict, traced: dict) -> dict:
    """A traced run of a fleet session against its untraced run: the
    results, plans, merges, deferrals and every device's params bitwise,
    the CKA launches equal; the metrics reconcile with the ledger below
    1e-9 in every dimension, and each device's spans over the
    device-time categories sum to its time within 1e-6. Returns the
    snapshot."""
    diff = same_fleet(off, traced)
    if diff:
        raise AssertionError(f"telemetry {name}: the traced run differs "
                             f"from the untraced one in {diff}")
    if traced["launches"] != off["launches"] or \
            traced["cka_by_device"] != off["cka_by_device"]:
        raise AssertionError(f"telemetry {name}: launches "
                             f"{traced['launches']} against "
                             f"{off['launches']} untraced")
    res, tel = traced["res"], traced["telemetry"]
    snap = tel.snapshot(res)
    rec = snap["reconciliation"]
    if len(rec) != 9 or max(rec.values()) >= 1e-9:
        raise AssertionError(f"telemetry {name}: reconciliation {rec}")
    spans = obs.device_time(tel.tracer.events)
    for dev, cell in res.per_device.items():
        if abs(spans.get(dev, 0.0) - cell["time_s"]) > 1e-6:
            raise AssertionError(f"telemetry {name}: {dev}'s spans sum to "
                                 f"{spans.get(dev, 0.0)} s, its ledger "
                                 f"time is {cell['time_s']} s")
    rounds = sum(e.cat == "round" for e in tel.tracer.events)
    if rounds != res.rounds:
        raise AssertionError(f"telemetry {name}: {rounds} round spans for "
                             f"{res.rounds} rounds")
    return snap


def telemetry_phase(kept: dict) -> dict:
    """The least-loaded fleet session of `fleet_phase` (its streams,
    its model) compiled with live telemetry and both sinks, held to that
    phase's untraced compiled run (`check_traced`); both sinks load with
    the port's loaders, with one Chrome track a device and a stream and
    one for the fleet. Prints the events by category, the counters'
    totals and the loop's warm rounds/s traced against untraced: the
    host's cost of tracing, against that phase's warm run and against
    one more untraced run right after the traced one (bitwise it too).
    Then the battery session with a Chrome trace: its temperature
    and state-of-charge counters, gauge events and throttle marks.
    Returns each traced session's CKA launches by device."""
    model = kept["model"]
    with tempfile.TemporaryDirectory() as tmp:
        jsonl, chrome = f"{tmp}/fleet.jsonl", f"{tmp}/fleet.json"
        s = kept["least-loaded"]
        traced = run_fleet(model, "least-loaded", s["benches"],
                           compiled=True, telemetry=TelemetrySpec(
                               enabled=True, trace_jsonl=jsonl,
                               chrome_trace=chrome))
        snap = check_traced("least-loaded", s["runs"]["compiled"], traced)
        res, events = traced["res"], traced["telemetry"].tracer.events
        if obs.read_jsonl(jsonl) != events:
            raise AssertionError("telemetry: the JSONL sink does not read "
                                 "back as the run's events")
        doc = obs.load_chrome_trace(chrome)
        tracks = obs.chrome_tracks(doc)
        want = {"devices": sorted(res.per_device),
                "streams": sorted(["fleet"] + [f"stream {i}" for i in
                                               range(len(s["benches"]))])}
        if tracks != want:
            raise AssertionError(f"telemetry: Chrome tracks {tracks}")
        cats: dict = {}
        for e in events:
            cats[e.cat] = cats.get(e.cat, 0) + 1
        walls = sum(e.args["wall_ms"] for e in events if e.cat == "round")
        warm = s["runs"]["compiled again"]
        after = run_fleet(model, "least-loaded", s["benches"], compiled=True)
        check_traced("least-loaded", after, traced)
        print(f"  least-loaded traced: {len(events)} events "
              f"{dict(sorted(cats.items()))}; JSONL "
              f"{Path(jsonl).stat().st_size} bytes, Chrome trace "
              f"{Path(chrome).stat().st_size} bytes, "
              f"{len(doc['traceEvents'])} records on "
              f"{len(tracks['devices'])} device and "
              f"{len(tracks['streams'])} stream tracks")
        print(f"    counters' totals: {counter_totals(snap)}")
        print(f"    gauges: {snap['gauges']}")
        print(f"    reconciliation (max over the 9 entries) "
              f"{max(snap['reconciliation'].values()):.3g}; device-time "
              f"spans equal each device's ledger time within 1e-6; "
              f"{traced['launches']['cka_terms']} CKA launches (example "
              f"route {traced['launches']['cka_example']}), as untraced")
        print(f"    loop traced {traced['loop_s']:.3f} s "
              f"({res.rounds / traced['loop_s']:.3f} rounds/s) against "
              f"untraced {after['loop_s']:.3f} s "
              f"({res.rounds / after['loop_s']:.3f} rounds/s) right after "
              f"it and {warm['loop_s']:.3f} s "
              f"({res.rounds / warm['loop_s']:.3f} rounds/s) in the fleet "
              f"phase; round spans' wall_ms (the host's time of the "
              f"launches) sum to {walls:.1f} ms")
        b = kept["battery"]
        trace = f"{tmp}/battery.json"
        battery = run_fleet(model, "battery", b["benches"], compiled=True,
                            telemetry=TelemetrySpec(chrome_trace=trace))
        check_traced("battery", b["runs"]["compiled"], battery)
        doc = obs.load_chrome_trace(trace)
        counters = {r["name"] for r in doc["traceEvents"]
                    if r.get("ph") == "C"}
        evs = obs.events_from_chrome(doc)
        gauges = sum(e.cat == "gauge" for e in evs)
        throttles = sum(e.cat == "throttle" for e in evs)
        if not {"temperature_c/dev0", "soc/dev0", "temperature_c/dev1",
                "soc/dev1"} <= counters or not gauges or not throttles:
            raise AssertionError(f"telemetry battery: counters {counters}, "
                                 f"{gauges} gauge and {throttles} throttle "
                                 f"events")
        print(f"  battery traced: {len(doc['traceEvents'])} Chrome records, "
              f"counter tracks {sorted(counters)}, {gauges} gauge events, "
              f"{throttles} throttle marks; bitwise the untraced run")
    return {"least-loaded": traced["cka_by_device"],
            "battery": battery["cka_by_device"]}


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


def lm_model(cfg, **kw):
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
    WKV route hands over is the decode cache; attention caches are
    extended by one row first, as `ServeEngine` extends them)."""
    tokens = torch.as_tensor(prompts, device=model.device)
    _, cache = model.prefill(params, {"tokens": tokens[:, :-1]})
    cache = ServeEngine(model)._extend_cache(cache, tokens.shape[1])
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

    kmodel, params = lm_model(cfg, use_pallas=True)
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

    kmodel, params = lm_model(cfg, use_pallas=True, dtype="float32",
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


def lm_phase(cfg):
    """gemma2-2b serving at full width and depth through
    `ServeEngine.generate`, the flash kernel on its prefill.

    As in `rwkv_phase`, the bf16 kernel run is the main path (its launches
    and timings are the ones reported), and the checks against the plain
    run run in fp32 within 1e-3: the kernel attends in fp32 where the
    plain path rounds scores' inputs and probabilities to bf16, so the
    bf16 gap is printed beside the 3e-2 limit, not held. Then one prompt
    of 8192 tokens in fp32, kernel against plain (`_attend_blockwise`,
    since it is past attn_chunk), which the 4096 window of the local
    layers masks in part."""
    L = cfg.num_layers
    B, S = GEMMA_ATT[:2]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = {"flash_attention": L, "cka_terms": 0, "cka_feature": 0,
            "cka_example": 0, "wkv6": 0}

    kmodel, params = lm_model(cfg, use_pallas=True)
    kern_tok, kern_logits, launches = serve(kmodel, params, prompts)
    print(f"  kernel run: {launches}")
    if launches != want:
        raise AssertionError(f"expected {L} flash launches, one per layer of "
                             f"the prefill, and no other; got {launches}")
    spans = {"prefill": [], "decode": []}
    tmodel = dataclasses.replace(
        kmodel, prefill=timed(kmodel.prefill, spans["prefill"]),
        decode=timed(kmodel.decode, spans["decode"]))
    again, _, _ = serve(tmodel, params, prompts)
    if not np.array_equal(again, kern_tok):
        raise AssertionError("a repeat of the kernel run chose other tokens")
    prefill_s = sum(a.elapsed_time(b) for a, b in spans["prefill"]) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in spans["decode"]) / 1e3
    timing = {"prefill_ms": prefill_s * 1e3,
              "prefill_tokens_per_s": B * S / prefill_s,
              "decode_ms_per_step": decode_s * 1e3 / DECODE_STEPS,
              "decode_tokens_per_s": B * DECODE_STEPS / decode_s}
    print(f"  kernel run timed (CUDA events around each call): prefill "
          f"{timing['prefill_ms']:.2f} ms "
          f"({timing['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{timing['decode_ms_per_step']:.2f} ms per step "
          f"({timing['decode_tokens_per_s']:.1f} tokens/s)")
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
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

    kmodel, params = lm_model(cfg, use_pallas=True, dtype="float32",
                              param_dtype="float32")
    kern_tok, kern_logits, _ = serve(kmodel, params, prompts)
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
    plain_tok, plain_logits, plain_launches = serve(pmodel, params, prompts)
    if any(plain_launches.values()):
        raise AssertionError(f"the plain run launched {plain_launches}")
    lm_close("fp32 prefill logits, kernel against plain",
             kern_logits[:, 0], plain_logits[:, 0], PAIR_TOL)
    compared, close = agree_on_tokens(kern_tok, plain_tok, plain_logits)
    print(f"  fp32 tokens: the runs agree at all {compared} steps whose "
          f"margin exceeds {MARGIN:g} ({close} steps closer; "
          f"{int((kern_tok == plain_tok).sum())} of {kern_tok.size} equal)")
    lm_close(f"fp32 decode of token {S} after a {S - 1}-token prefill, "
             f"against the {S}-token prefill",
             consistency(kmodel, params, prompts),
             kern_logits[:, 0], PAIR_TOL)

    long = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, GEMMA_LONG)), device="cuda")}
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got, _ = kmodel.prefill(params, long)
    end.record()
    torch.cuda.synchronize()
    long_launches = read_launches()
    if long_launches != want:
        raise AssertionError(f"the {GEMMA_LONG}-token prefill launched "
                             f"{long_launches}")
    timing["long_prefill_ms"] = start.elapsed_time(end)
    ref, _ = pmodel.prefill(params, long)
    if not torch.isfinite(got).all() or got.shape != (1, cfg.vocab_size):
        raise AssertionError(f"bad logits: shape {tuple(got.shape)}")
    lm_close(f"fp32 prefill logits of one {GEMMA_LONG}-token prompt, kernel "
             f"against plain (blockwise; window {cfg.sliding_window} on the "
             f"local layers)", got.cpu().numpy(), ref.cpu().numpy(),
             PAIR_TOL)
    print(f"  the {GEMMA_LONG}-token fp32 kernel prefill: "
          f"{timing['long_prefill_ms']:.1f} ms (CUDA events, one call), "
          f"{long_launches['flash_attention']} flash launches")
    del params
    torch.cuda.empty_cache()
    return {"serving": launches["flash_attention"],
            "long": long_launches["flash_attention"], **timing}


class _Routes:
    """While active, records every MoE layer's routing (`moe.route`): its
    outputs, the (token, expert) pairs it kept (`moe.kept_pairs`, a
    [T, E] bool) and the number of pairs it routed (T x K), all kept on
    the card until read, so it adds no sync to the run. Given the record
    of another run (`replay`), it returns that run's routing call by call
    instead of routing: the MoE dispatch and gates are then the other
    run's, and only what comes before the router differs."""

    def __init__(self, replay: "_Routes | None" = None):
        self.replay = replay

    def __enter__(self):
        self.outs, self.calls = [], []
        self._route = moe_mod.route
        moe_mod.route = self._record
        return self

    def __exit__(self, *exc):
        moe_mod.route = self._route

    def _record(self, p, cfg, xt, capacity):
        if self.replay is None:
            out = self._route(p, cfg, xt, capacity)
        else:
            out = self.replay.outs[len(self.outs)]
            if out[0].shape[0] != xt.shape[0] or \
                    out[2].shape != (cfg.num_experts, capacity):
                raise AssertionError(
                    f"replayed routing of {out[0].shape[0]} tokens and "
                    f"{tuple(out[2].shape)} slots at a call of "
                    f"{xt.shape[0]} tokens and capacity {capacity}")
        self.outs.append(out)
        self.calls.append((moe_mod.kept_pairs(out[2], out[3], xt.shape[0]),
                           xt.shape[0] * cfg.experts_per_token))
        return out

    def dropped(self, min_tokens: int) -> int:
        """Routed pairs past an expert's capacity, over the calls of at
        least `min_tokens` tokens (the prefills' layers)."""
        return sum(routed - int(kept.sum()) for kept, routed in self.calls
                   if kept.shape[0] >= min_tokens)


def route_rows(kern: _Routes, plain: _Routes, B: int):
    """Rows of the batch whose tokens the two runs routed alike at every
    layer (kept the same (token, expert) pairs), and whether all did."""
    if len(kern.calls) != len(plain.calls):
        raise AssertionError(f"{len(kern.calls)} MoE calls against "
                             f"{len(plain.calls)}")
    same = torch.ones(B, dtype=torch.bool)
    for (a, _), (b, _) in zip(kern.calls, plain.calls):
        same &= (a == b).reshape(B, -1).all(dim=1).cpu()
    rows = [b for b in range(B) if bool(same[b])]
    return rows, len(rows) == B


def report_routes(name, kern: _Routes, plain: _Routes, B: int, S: int):
    rows, alike = route_rows(kern, plain, B)
    print(f"  {name}: (token, expert) pairs dropped over capacity in the "
          f"prefill, kernel run {kern.dropped(B * S)}, plain run "
          f"{plain.dropped(B * S)}; the runs kept "
          f"{'the same pairs' if alike else 'other pairs in some rows'} "
          f"(rows routed alike: {rows}); decode routes every pair (C = T)")
    return rows


def hold_moe_pair(name, kmodel, params, prompts, want) -> dict:
    """The fp32 kernel/plain pair of an MoE LM, held within PAIR_TOL.

    The kernel run and the plain run route freely; a gate at an expert's
    capacity boundary may flip between them, and then that row's logits
    part by more than rounding, so the pair is held on the rows both runs
    routed alike. Then the kernel run again on the plain run's routing
    (`_Routes(replay=...)`), so that flash is the only difference: that
    pair is held on every row, and a kernel fault cannot leave the gate
    by flipping the routes of the rows it spoils."""
    B, S = prompts.shape
    with _Routes() as kroutes:
        kern_tok, kern_logits, launches = serve(kmodel, params, prompts)
    if launches != want:
        raise AssertionError(f"{name}: the fp32 kernel run launched "
                             f"{launches}, not {want}")
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
    with _Routes() as proutes:
        plain_tok, plain_logits, plain_launches = serve(pmodel, params,
                                                        prompts)
    if any(plain_launches.values()):
        raise AssertionError(f"{name}: the plain run launched "
                             f"{plain_launches}")
    rows = report_routes(f"{name}, fp32", kroutes, proutes, B, S)
    if rows:
        lm_close(f"{name}, fp32 prefill logits, kernel against plain, "
                 f"rows routed alike {rows}", kern_logits[rows, 0],
                 plain_logits[rows, 0], PAIR_TOL)
        compared, close = agree_on_tokens(kern_tok[rows], plain_tok[rows],
                                          plain_logits[rows])
        print(f"  {name}, fp32 tokens: the runs agree at all {compared} "
              f"steps whose margin exceeds {MARGIN:g} ({close} steps "
              f"closer; {int((kern_tok == plain_tok).sum())} of "
              f"{kern_tok.size} equal)")
    with _Routes(replay=proutes) as rroutes:
        rep_tok, rep_logits, rep_launches = serve(kmodel, params, prompts)
    if rep_launches != want or len(rroutes.outs) != len(proutes.outs):
        raise AssertionError(f"{name}: the replayed kernel run launched "
                             f"{rep_launches} over {len(rroutes.outs)} MoE "
                             f"calls, not {want} over {len(proutes.outs)}")
    lm_close(f"{name}, fp32 prefill logits, kernel on the plain run's "
             f"routing against plain, all {B} rows", rep_logits[:, 0],
             plain_logits[:, 0], PAIR_TOL)
    compared, close = agree_on_tokens(rep_tok, plain_tok, plain_logits)
    print(f"  {name}, fp32 tokens on the plain run's routing: the runs "
          f"agree at all {compared} steps whose margin exceeds {MARGIN:g} "
          f"({close} steps closer)")
    return {"launches": launches["flash_attention"],
            "dropped": [kroutes.dropped(B * S), proutes.dropped(B * S)],
            "rows_routed_alike": rows}


def moe_phase(cfg):
    """qwen3-moe-30b-a3b serving at full width and depth through
    `ServeEngine.generate`: 48 layers, each a GQA attention and a
    128-expert top-8 MoE FFN, the flash kernel on the prefill.

    As in `lm_phase`, the bf16 kernel run is the main path (launches,
    timings, peak memory), and the kernel/plain pair is held in fp32
    within 1e-3, here at full width with depth cut to
    `QWEN3_FP32_LAYERS` (fp32 at 48 layers would take 122 GB), by
    `hold_moe_pair`: on the rows both runs routed alike, and on every row
    with the kernel run on the plain run's routing. The bf16 runs route
    differently in every row, so their gap is printed, with and without
    the plain run's routing, and not held."""
    L = cfg.num_layers
    B, S = QWEN3_ATT[:2]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = {"flash_attention": L, "cka_terms": 0, "cka_feature": 0,
            "cka_example": 0, "wkv6": 0}
    torch.cuda.reset_peak_memory_stats()
    kmodel, params = lm_model(cfg, use_pallas=True)
    count = sum(t.numel() for t in tree_leaves(params))
    if abs(count / QWEN3_PARAMS - 1) > 5e-5:
        raise AssertionError(f"{count} params, not {QWEN3_PARAMS:g}")
    with _Routes() as kroutes:
        kern_tok, kern_logits, launches = serve(kmodel, params, prompts)
    print(f"  kernel run: {launches}")
    if launches != want:
        raise AssertionError(f"expected {L} flash launches, one per layer of "
                             f"the prefill, and no other; got {launches}")
    spans = {"prefill": [], "decode": []}
    tmodel = dataclasses.replace(
        kmodel, prefill=timed(kmodel.prefill, spans["prefill"]),
        decode=timed(kmodel.decode, spans["decode"]))
    again, _, _ = serve(tmodel, params, prompts)
    if not np.array_equal(again, kern_tok):
        raise AssertionError("a repeat of the kernel run chose other tokens")
    prefill_s = sum(a.elapsed_time(b) for a, b in spans["prefill"]) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in spans["decode"]) / 1e3
    timing = {"params": count,
              "prefill_ms": prefill_s * 1e3,
              "prefill_tokens_per_s": B * S / prefill_s,
              "decode_ms_per_step": decode_s * 1e3 / DECODE_STEPS,
              "decode_tokens_per_s": B * DECODE_STEPS / decode_s,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"  kernel run timed (CUDA events around each call): prefill "
          f"{timing['prefill_ms']:.2f} ms "
          f"({timing['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{timing['decode_ms_per_step']:.2f} ms per step "
          f"({timing['decode_tokens_per_s']:.1f} tokens/s); the repeat "
          f"chose the same tokens; peak memory "
          f"{timing['peak_memory_gb']:.2f} GB")
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
    with _Routes() as proutes:
        plain_tok, plain_logits, plain_launches = serve(pmodel, params,
                                                        prompts)
    if any(plain_launches.values()):
        raise AssertionError(f"the plain run launched {plain_launches}")
    report_routes("bf16", kroutes, proutes, B, S)
    timing["dropped_bf16"] = [kroutes.dropped(B * S), proutes.dropped(B * S)]
    bf16_pair = float(np.abs(kern_logits[:, 0] - plain_logits[:, 0]).max())
    with _Routes(replay=proutes):
        _, rep_logits, _ = serve(kmodel, params, prompts)
    bf16_replay = float(np.abs(rep_logits[:, 0] - plain_logits[:, 0]).max())
    timing["bf16_pair"] = [bf16_pair, bf16_replay]
    print(f"  bf16, not held (the two runs route differently, so the held "
          f"pair is the fp32 one below): prefill logits kernel against "
          f"plain max_abs_err {bf16_pair:.4g}, and {bf16_replay:.4g} with "
          f"the kernel run on the plain run's routing (limit {LM_TOL:g}); "
          f"{int((kern_tok == plain_tok).sum())} of {kern_tok.size} tokens "
          f"equal")
    del params, kroutes, proutes
    torch.cuda.empty_cache()

    fp32 = cfg.replace(num_layers=QWEN3_FP32_LAYERS)
    kmodel, params = lm_model(fp32, use_pallas=True, dtype="float32",
                              param_dtype="float32")
    pair = hold_moe_pair(f"qwen3-moe, {QWEN3_FP32_LAYERS} layers", kmodel,
                         params, prompts,
                         {**want, "flash_attention": QWEN3_FP32_LAYERS})
    timing["dropped_fp32"] = pair["dropped"]
    timing["fp32_rows_routed_alike"] = pair["rows_routed_alike"]
    del params
    torch.cuda.empty_cache()
    return {"serving": launches["flash_attention"],
            "fp32": pair["launches"], **timing}


def mamba_phase():
    """jamba's Mamba-1 block alone at full width, then the reduced jamba
    served whole.

    (a) `get_config("jamba-1.5-large-398b")`'s block (d 8192, d_inner
    16384, state 16, dt_rank 512) in fp32 from a seeded CUDA generator:
    a prefill of 4 x 512 tokens (4 chunks of 128, timed), whose first 256
    positions must be those of a 256-token prefill (2 chunks) within
    1e-3, and the decode of token 256 after a 255-token prefill (one
    chunk of 255), which must give the 256-token prefill's last position
    within 1e-3; the same gap in bf16 is printed beside it, not held.
    (b) the reduced jamba (8 layers, one group: 7 mamba layers and the
    attention layer at offset 4, MoE every other layer) through
    `ServeEngine.generate` on 4 prompts of 512 tokens: the bf16 kernel run
    launches flash once a prefill (hd 16) and nothing else, the plain run
    nothing; the same pair in fp32 within 1e-3, by `hold_moe_pair`."""
    cfg = get_config("jamba-1.5-large-398b").replace(dtype="float32",
                                                     param_dtype="float32")
    B, S = JAMBA_BLOCK
    n = JAMBA_DECODE_AT
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype, param_dtype=dtype)
        p = mamba_mod.init_mamba(
            torch.Generator(device="cuda").manual_seed(0), c)
        x = torch.randn((B, S, c.d_model), generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda").to(
            getattr(torch, dtype))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        full, _ = mamba_mod.mamba_train(p, c, x)
        end.record()
        torch.cuda.synchronize()
        head, _ = mamba_mod.mamba_train(p, c, x[:, :n])
        _, state = mamba_mod.mamba_train(p, c, x[:, :n - 1],
                                         return_state=True)
        dec, _ = mamba_mod.mamba_decode(p, c, x[:, n - 1:n], state)
        if not torch.isfinite(full).all() or full.shape != x.shape:
            raise AssertionError(f"bad block output {tuple(full.shape)}")
        params = sum(t.numel() * t.element_size() for t in p.values())
        print(f"  jamba's mamba block, {dtype}: {params / 1e9:.3f} GB of "
              f"params; prefill of {B} x {S} tokens "
              f"{start.elapsed_time(end):.2f} ms (CUDA events, one call), "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        got = {"chunks": (full[:, :n].float().cpu().numpy(),
                          head.float().cpu().numpy()),
               "decode": (dec[:, 0].float().cpu().numpy(),
                          head[:, -1].float().cpu().numpy())}
        if dtype == "float32":
            out["block_prefill_ms"] = start.elapsed_time(end)
            lm_close(f"fp32 block: the first {n} positions of the {S}-token "
                     f"prefill against a {n}-token prefill", *got["chunks"],
                     PAIR_TOL)
            lm_close(f"fp32 block: decode of token {n} after a "
                     f"{n - 1}-token prefill against the {n}-token "
                     f"prefill's last position", *got["decode"], PAIR_TOL)
        else:
            gaps = [float(np.abs(a - b).max()) for a, b in got.values()]
            print(f"  bf16 block, not held: {n} positions {gaps[0]:.4g}, "
                  f"decode after prefill {gaps[1]:.4g} (limit {LM_TOL:g})")
        del p, x, full, head, dec, state
        torch.cuda.empty_cache()

    cfg = get_reduced("jamba-1.5-large-398b")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = {"flash_attention": 1, "cka_terms": 0, "cka_feature": 0,
            "cka_example": 0, "wkv6": 0}
    kmodel, params = lm_model(cfg, use_pallas=True)
    _, _, launches = serve(kmodel, params, prompts)
    print(f"  reduced jamba, bf16 kernel run: {launches}")
    if launches != want:
        raise AssertionError(f"expected one flash launch a prefill, on the "
                             f"attention layer; got {launches}")
    kmodel, params = lm_model(cfg, use_pallas=True, dtype="float32",
                              param_dtype="float32")
    hold_moe_pair("reduced jamba", kmodel, params, prompts, want)
    del params
    torch.cuda.empty_cache()
    return {"jamba_reduced": launches["flash_attention"], **out}


def flash_only(n: int) -> dict:
    return {"flash_attention": n, "cka_terms": 0, "cka_feature": 0,
            "cka_example": 0, "wkv6": 0}


def wkv_only(n: int) -> dict:
    return {**flash_only(0), "wkv6": n}


def lr_at(step: int, total: int) -> float:
    """The train_lm example's learning-rate scale at `step` of `total`."""
    return cosine_schedule(step, warmup=train_lm.WARMUP, total=total)


def train_steps(model, held: list, plan, batches, first, total, want):
    """Steps `first`, `first` + 1, ... of the train_lm example's step
    builder under `plan`, one a batch, from and into `held` = [params,
    state] (held here alone, so that a step's peak memory is its own: the
    state it reads and the one it writes), each timed with CUDA events
    and its launches held to `want`. Returns (losses, ms)."""
    step = train_lm.make_step(model, train_lm.OPT_CFG, plan)
    params, state = held
    held.clear()
    losses, ms = [], []
    for i, batch in enumerate(batches, start=first):
        zero_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss = step(params, state, batch, lr_at(i, total))
        end.record()
        torch.cuda.synchronize()
        if read_launches() != want:
            raise AssertionError(f"step {i} under {plan}: expected "
                                 f"{want}, got {read_launches()}")
        if not torch.isfinite(loss):
            raise AssertionError(f"step {i}: loss {float(loss)}")
        losses.append(float(loss))
        ms.append(start.elapsed_time(end))
    held.extend([params, state])
    return losses, ms


def step_split(model, params, state, plan, batch) -> dict:
    """One step under `plan` split in two, each timed with CUDA events:
    the loss and its gradients (`grads_of`), then AdamW's update."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    _, _, grads = grads_of(model.loss, params, batch, plan)
    events[1].record()
    res = adamw_update(grads, state, params, train_lm.OPT_CFG,
                       lr_scale=1.0)
    events[2].record()
    torch.cuda.synchronize()
    del grads, res
    split = {"grads_ms": events[0].elapsed_time(events[1]),
             "adamw_ms": events[1].elapsed_time(events[2])}
    print(f"  one half-prefix step split: loss and gradients "
          f"{split['grads_ms']:.2f} ms, AdamW's update {split['adamw_ms']:.2f} "
          f"ms (CUDA events)")
    return split


def leaf_gaps(kern, plain) -> list:
    """For each gradient leaf of a kernel run's (loss, metrics, grads) and a
    plain run's: (the largest |gap|, the plain leaf's largest |g|)."""
    return [(float((a.float() - b.float()).abs().max()),
             float(b.float().abs().max()))
            for a, b in zip(tree_leaves(kern[2]), tree_leaves(plain[2]))]


def hold_grads(name, kern, plain, tol, relative=True) -> float:
    """A kernel run's (loss, metrics, grads) against a plain run's: the
    loss within rtol = atol = `tol`; with `relative`, every gradient leaf
    within `tol` x the plain leaf's largest |g| plus GRAD_FLOOR, as the
    CPU tests hold them, else every entry within rtol = atol = `tol`
    (rwkv6: `train_lm_phase` says why). Returns the largest absolute
    gap, the loss's included."""
    loss_err = abs(float(kern[0]) - float(plain[0]))
    if loss_err > tol * (1 + abs(float(plain[0]))):
        raise AssertionError(f"{name}: loss {float(kern[0])!r} against "
                             f"{float(plain[0])!r}")
    gaps = leaf_gaps(kern, plain)
    for i, ((gap, top), a, b) in enumerate(zip(gaps, tree_leaves(kern[2]),
                                               tree_leaves(plain[2]))):
        if relative and gap > tol * top + GRAD_FLOOR:
            raise AssertionError(f"{name}: gradient leaf {i} differs by "
                                 f"{gap:.4g}, its largest |g| {top:.4g}")
        if not relative:
            torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                       msg=f"{name}: gradient leaf {i}")
    gap, top = max(gaps, key=lambda g: g[0] / max(g[1], 1e-30))
    held = (f"{tol:g} x its largest |g| + {GRAD_FLOOR:g}" if relative
            else f"rtol = atol = {tol:g}")
    print(f"  {name}: loss {float(kern[0]):.6f}, max_abs_err {loss_err:.4g}; "
          f"every gradient leaf within {held}: largest relative gap "
          f"{gap / max(top, 1e-30):.4g} (gap {gap:.4g}, largest |g| "
          f"{top:.4g}), largest absolute gap {max(g for g, _ in gaps):.4g}, "
          f"over {len(gaps)} leaves")
    return max(max(g for g, _ in gaps), loss_err)


def hold_features(name, kmodel, pmodel, params, batch, tol) -> float:
    """Every layer's output (`model.features`, no grad, so the kernel
    route takes every layer) of the kernel model against the plain one,
    each within `tol` x the plain output's largest |x|. Returns the
    largest of those relative gaps."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(kmodel.features(params, batch),
                                   pmodel.features(params, batch))):
        rel = float((a - b).abs().max()) / float(b.abs().max())
        if rel > tol:
            raise AssertionError(f"{name}: layer {i}'s output differs by "
                                 f"{rel:.4g} of its largest |x|")
        worst = max(worst, rel)
    print(f"  {name}: every layer's output within {tol:g} of its largest "
          f"|x|, largest gap {worst:.4g} of it")
    return worst


def grads_gap(kern, plain) -> tuple:
    """(|loss gap|, the largest leaf gap relative to the leaf's max |g|)."""
    rel = max(gap / max(top, 1e-30) for gap, top in leaf_gaps(kern, plain))
    return abs(float(kern[0]) - float(plain[0])), rel


def checkpoint_round_trip(step_fn, holder: list, batch, lr, at) -> dict:
    """One async `CheckpointManager.save` of (params, state) (`holder`,
    which this empties, so that the card holds one state at a time) into
    a fresh temporary directory, the uninterrupted run's next step while
    it writes, `restore_latest` into fresh tensors (every leaf bitwise the
    saved one) and the same step from the restored state, whose loss
    must be bitwise the uninterrupted one's. The directory is removed."""
    params, state = holder
    holder.clear()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves((params, state)))
        free = shutil.disk_usage(tmp).free
        print(f"  checkpoint of (params, AdamW state): {nbytes / 1e9:.2f} GB "
              f"into {tmp}, {free / 1e9:.1f} GB free there")
        mgr = CheckpointManager(tmp, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(at, (params, state))
        blocked = time.perf_counter() - t0
        _, _, loss = step_fn(params, state, batch, lr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mgr.wait()
        waited = time.perf_counter() - t1
        t2 = time.perf_counter()
        restored, got_step = mgr.restore_latest((params, state),
                                                device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t2
        if got_step != at:
            raise AssertionError(f"restored step {got_step}, not {at}")
        pairs = list(zip(tree_leaves(restored), tree_leaves((params, state))))
        bad = [i for i, (a, b) in enumerate(pairs)
               if a.dtype != b.dtype or not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"restored leaves {bad[:8]} differ")
        count = len(pairs)
        del pairs, params, state
        _, _, again = step_fn(*restored, batch, lr)
        if not torch.equal(again, loss):
            raise AssertionError(f"the resumed step's loss {float(again)!r} "
                                 f"is not the uninterrupted {float(loss)!r}")
        del restored
        out = {"bytes": nbytes, "free_bytes": free, "blocked_s": blocked,
               "write_s": mgr.write_seconds, "waited_s": waited,
               "restore_s": restore_s, "loss": float(loss)}
        print(f"  checkpoint: the caller blocked {blocked:.2f} s (device to "
              f"host), the background write took {out['write_s']:.2f} s "
              f"({waited:.2f} s of it after the next step), restore_latest "
              f"(validate + restore to the card) {restore_s:.2f} s; "
              f"{count} leaves bitwise equal, "
              f"the resumed step's loss {float(loss)!r} bitwise the "
              f"uninterrupted run's")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_lm_phase():
    """LM training through the train_lm example's step builder
    (`repro_torch.examples.train_lm.make_step`) on its synthetic batches.

    (a) gemma2-2b at full width and depth in bf16 (`remat="full"`, the
    config's): `TRAIN_STEPS[0]` steps all active (no kernel launch: every
    forward needs a backward), then `TRAIN_STEPS[1]` under the half-prefix
    plan, whose frozen 12 layers take flash (12 launches a step), each
    step timed with its tokens/s and each plan's peak memory, beside one
    step with `remat="none"`; the bf16 gap between the kernel and plain
    routes under the plan, printed; then the checkpoint round trip of the
    whole state (`checkpoint_round_trip`). (b) the pair in fp32 at full
    width with depth cut to `TRAIN_FP32_LAYERS`, 4 flash launches a step,
    loss and every gradient leaf within 1e-3. (c) rwkv6-3b at full width
    with `RWKV_TRAIN` layers and tokens: no launch and no error before the
    switch, 2 WKV6 launches a step under the plan, the fp32 pair within
    1e-3."""
    cfg = get_config("gemma2-2b")
    B, S = TRAIN_BATCH
    n_active, n_frozen = TRAIN_STEPS
    total = n_active + n_frozen + 1
    rng = np.random.default_rng(0)
    batches = [train_lm.synthetic_batch(rng, cfg.vocab_size, B, S, "cuda")
               for _ in range(total)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kmodel, params = lm_model(cfg, use_pallas=True)
    if kmodel.cfg.remat != "full":
        raise AssertionError(f"gemma2-2b's remat is {kmodel.cfg.remat}")
    G = kmodel.num_freeze_units
    plan = train_lm.half_prefix_plan(G)
    frozen = sum(plan.groups) * cfg.num_layers // G
    held = [params, adamw_init(params, train_lm.OPT_CFG)]
    del params
    out = {"frozen_layers": frozen, "by_plan": {}}
    for name, p, first, n, want in (
            ("all active", None, 0, n_active, flash_only(0)),
            ("half prefix", plan, n_active, n_frozen, flash_only(frozen))):
        torch.cuda.reset_peak_memory_stats()
        losses, ms = train_steps(kmodel, held, p, batches[first:first + n],
                                 first, total, want)
        peak = torch.cuda.max_memory_allocated() / 1e9
        warm = ms[1:] or ms
        mean = sum(warm) / len(warm)
        out["by_plan"][name] = {"losses": losses, "ms": ms, "ms_mean": mean,
                                "tokens_per_s": B * S / mean * 1e3,
                                "peak_memory_gb": peak,
                                "launches_per_step": want["flash_attention"]}
        print(f"  bf16, {name} ({want['flash_attention']} flash launches a "
              f"step): losses {[round(x, 4) for x in losses]}; ms a step "
              f"(CUDA events) {[round(x, 2) for x in ms]}, "
              f"{mean:.2f} after the first ({B * S / mean * 1e3:.0f} "
              f"tokens/s); peak memory {peak:.2f} GB")
    out["gemma2_train"] = n_frozen * frozen
    params, state = held
    out["step_split_ms"] = step_split(kmodel, params, state, plan,
                                      batches[-1])

    # the forward and backward alone under each remat (an all-active
    # step's peak is AdamW's where it is larger), then a whole step
    # without remat
    peaks = {}
    for remat in ("full", "none"):
        model = build_model(kmodel.cfg.replace(remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = grads_of(model.loss, params, batches[0], None)
        torch.cuda.synchronize()
        peaks[f"grads_{remat}"] = torch.cuda.max_memory_allocated() / 1e9
        del res
    torch.cuda.reset_peak_memory_stats()
    res = train_lm.make_step(model, train_lm.OPT_CFG, None)(
        params, state, batches[0], lr_at(0, total))
    torch.cuda.synchronize()
    peaks["step_none"] = torch.cuda.max_memory_allocated() / 1e9
    del res
    out["peak_memory_gb_remat"] = peaks
    print(f"  peak memory, all active: forward and backward "
          f"{peaks['grads_full']:.2f} GB with remat=\"full\", "
          f"{peaks['grads_none']:.2f} GB with \"none\"; a whole step "
          f"{out['by_plan']['all active']['peak_memory_gb']:.2f} GB "
          f"(\"full\"), {peaks['step_none']:.2f} GB (\"none\")")

    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
    kern = grads_of(kmodel.loss, params, batches[-1], plan)
    plain = grads_of(pmodel.loss, params, batches[-1], plan)
    out["bf16_gap"] = grads_gap(kern, plain)
    print(f"  bf16 under the plan, not held: loss kernel against plain "
          f"{out['bf16_gap'][0]:.4g}, largest gradient-leaf gap "
          f"{out['bf16_gap'][1]:.4g} of the leaf's max |g|")
    del kern, plain
    torch.cuda.empty_cache()

    held = [params, state]
    del params, state
    out["checkpoint"] = checkpoint_round_trip(
        train_lm.make_step(kmodel, train_lm.OPT_CFG, plan), held, batches[-1],
        lr_at(total - 1, total), total - 2)
    torch.cuda.empty_cache()

    fp32 = cfg.replace(num_layers=TRAIN_FP32_LAYERS)
    kmodel, params = lm_model(fp32, use_pallas=True, dtype="float32",
                              param_dtype="float32")
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
    plan = train_lm.half_prefix_plan(kmodel.num_freeze_units)
    n = sum(plan.groups) * TRAIN_FP32_LAYERS // kmodel.num_freeze_units
    zero_launches()
    kern = grads_of(kmodel.loss, params, batches[0], plan)
    if read_launches() != flash_only(n):
        raise AssertionError(f"fp32 kernel run: {read_launches()}")
    zero_launches()
    plain = grads_of(pmodel.loss, params, batches[0], plan)
    if any(read_launches().values()):
        raise AssertionError(f"fp32 plain run: {read_launches()}")
    out["fp32_max_abs_err"] = hold_grads(
        f"gemma2-2b fp32, {TRAIN_FP32_LAYERS} layers, {n} flash launches",
        kern, plain, PAIR_TOL)
    out["gemma2_train_fp32"] = n
    del kern, plain, params
    torch.cuda.empty_cache()

    layers, T = RWKV_TRAIN
    rcfg = get_config("rwkv6-3b").replace(num_layers=layers)
    rng = np.random.default_rng(1)
    rbatches = [train_lm.synthetic_batch(rng, rcfg.vocab_size, B, T, "cuda")
                for _ in range(2)]
    kmodel, params = lm_model(rcfg, use_pallas=True, dtype="float32",
                              param_dtype="float32")
    pmodel = build_model(kmodel.cfg.replace(use_pallas=False))
    plan = train_lm.half_prefix_plan(kmodel.num_freeze_units)
    n = sum(plan.groups)
    held = [params, adamw_init(params, train_lm.OPT_CFG)]
    losses, _ = train_steps(kmodel, held, None, rbatches[:1], 0, 2,
                            wkv_only(0))
    more, _ = train_steps(kmodel, held, plan, rbatches[1:], 1, 2,
                          wkv_only(n))
    print(f"  rwkv6-3b, {layers} layers on {B} x {T} tokens, fp32: an "
          f"all-active step (no launch) and a half-prefix step ({n} WKV6 "
          f"launches), losses {losses + more}")
    # What the kernel changes in a train step is the frozen prefix's
    # output; that, the loss and each gradient entry are held. rwkv6's
    # fp32 gradients are not held leaf by leaf at PAIR_TOL of their
    # largest |g|: any ulp-sized change to the prefix output moves them by
    # ~2e-3 of it, through the per-head group norm of heads whose first
    # token's WKV output is nearly constant. `control` shows that floor
    # without the kernel: the plain run with a frozen weight moved by
    # 1e-7 of itself.
    out["rwkv6_features"] = hold_features(
        f"rwkv6-3b fp32, {layers} layers on {B} x {T} tokens, WKV6 against "
        f"the chunked form", kmodel, pmodel, params, rbatches[0], PAIR_TOL)
    kern = grads_of(kmodel.loss, params, rbatches[0], plan)
    plain = grads_of(pmodel.loss, params, rbatches[0], plan)
    out["rwkv6_max_abs_err"] = hold_grads(
        f"rwkv6-3b fp32, {layers} layers, {n} WKV6 launches", kern, plain,
        PAIR_TOL, relative=False)
    wo = params["blocks"][0]["mix"]["wo"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn(wo.shape, device="cuda", generator=gen)
    moved = {**params, "blocks": [{**params["blocks"][0], "mix": {
        **params["blocks"][0]["mix"], "wo": wo * (1 + 1e-7 * noise)}},
        *params["blocks"][1:]]}
    control = grads_gap(grads_of(pmodel.loss, moved, rbatches[0], plan),
                        plain)
    print(f"  rwkv6-3b fp32 control, not held: the plain run with frozen "
          f"layer 0's wo x (1 + 1e-7 noise) against the plain run: loss "
          f"{control[0]:.4g}, largest gradient-leaf gap {control[1]:.4g} of "
          f"the leaf's max |g| (the kernel run's: "
          f"{grads_gap(kern, plain)[1]:.4g})")
    out["rwkv6_train"] = n
    del kern, plain, params, held, moved, noise
    torch.cuda.empty_cache()
    return out


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


def attention_timing(gen, shape) -> dict:
    """Flash attention (non-causal) at `shape` = (B, S, H, hd), its plain
    version and SDPA on the same inputs, eager and on the card, beside
    the bound: q, k, v read and o written once, 4 B H S^2 hd operations
    as 3xTF32."""
    B, S, H, hd = shape
    q, k, v = (torch.randn((B, S, H, hd), generator=gen).cuda()
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel = lambda: att_ops.flash_attention(  # noqa: E731
        q, k, v, causal=False)
    plain = lambda: att_ops.attention_plain(  # noqa: E731
        q, k, v, causal=False)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    att = {
        "shape": list(shape),
        "ms": time_ms(kernel),
        "plain_ms": time_ms(plain),
        "library_ms": time_ms(sdpa),
        "device_ms": device_ms(kernel),
        "plain_device_ms": device_ms(plain, calls=5),
        "library_device_ms": device_ms(sdpa),
    }
    flops = 4.0 * B * H * S * S * hd
    nbytes = 4.0 * 4 * B * S * H * hd
    att.update(bound(flops, nbytes, tensor_cores=True))
    return att


def bert_timing(gen) -> dict:
    """Flash attention at bert-base's shapes (the mixed loop's and
    serving's) and CKA's example route at its probe shape, n = 512 rows
    of d = 768 on raw maps, as its kernels (`_launch_example`, which
    centers in torch first where n > 16), as the wrapper and as the plain
    version (`_prepare`, then `cka_terms_plain`), eager and on the card,
    beside the bound of the example form's work (`example_bound`), with
    the card's time in each of its three passes."""
    att = {name: attention_timing(gen, shape) for name, shape in
           (("loop", BERT_LOOP_ATT), ("serving", BERT_SERVE_ATT))}
    for name, t in att.items():
        print(f"  flash_attention at bert-base's {name} shape "
              f"{t['shape']}: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} (device "
              f"{t['plain_device_ms']:.4f}), SDPA {t['library_ms']:.4f} "
              f"(device {t['library_device_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['bound_kind']}); the kernel's device time is "
              f"{t['device_ms'] / t['bound_ms']:.2f}x the bound")
    n, d = BERT_CKA
    x, y = _cka_inputs(gen, n, d, d)
    cka = dict(example_bound([d], n=n), launches=1, shape=[n, d])
    for key, run in {"": lambda: cka_ops._launch_example(x, y),
                     "wrapper_": lambda: cka_ops.cka_terms(x, y),
                     "plain_": lambda: cka_ops.cka_terms_plain(
                         cka_ops._prepare(x), cka_ops._prepare(y))
                     }.items():
        cka[f"{key}ms"] = time_ms(run)
        cka[f"{key}device_ms"] = device_ms(run)
    cka["device_ms_by_pass"] = pass_device_ms(
        lambda: cka_ops._launch_example(x, y), EXAMPLE_PASSES, calls=20)
    report_cnn_cka(f"one launch at n{n} d{d} (a bert-base probe map, "
                   f"{-(-n // cka_ops.EXAMPLE_ROWS)} row tiles)", cka)
    print(f"  cka at the bert-base probe shape: the kernels' device time is "
          f"{cka['device_ms'] / cka['bound_ms']:.2f}x the bound and "
          f"{cka['device_ms'] / cka['plain_device_ms']:.2f}x the plain "
          f"version's")
    return {"attention": att, "cka": cka}


def attended_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask with this window keeps over S
    positions: row i sees min(i + 1, window) keys."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def gemma_timing(gen) -> dict:
    """Flash attention at gemma2-2b's prefill shapes, causal with softcap
    50: the serving shape [4, 512, 8/4, 256], and one 8192-token prompt
    with the local layers' 4096 window and without it (a global layer).
    As the main path calls it: q, k, v in bf16, which the wrapper copies
    to fp32 for the kernel (the copies are in the times). Kernel and
    plain version, eager (`ms`) and on the card (`device_ms`), beside the
    bound of the unmasked pairs' work in that type (`bf16_bound`: 4 hd
    operations a pair and head on bf16 inputs, q, k, v read as bf16 and
    the fp32 o written once). The fp32 function, the kernel on fp32
    inputs, is timed beside it (`fp32_device_ms`) against its own bound
    (3xTF32, 4-byte inputs; `fp32_bound_ms`). No single PyTorch call
    computes this function: SDPA has no logit softcap. Its causal time
    on the same bf16 inputs without the softcap (`enable_gqa`) stands
    beside it as a different function."""
    out = {}
    _, _, Hq, Hkv, hd = GEMMA_ATT
    for name, (B, S, window) in (("serving_shape", (*GEMMA_ATT[:2], 0)),
                                 ("long_local", (1, GEMMA_LONG,
                                                 GEMMA_WINDOW)),
                                 ("long_global", (1, GEMMA_LONG, 0))):
        q = torch.randn((B, S, Hq, hd), generator=gen).cuda()
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen).cuda()
                for _ in range(2))
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qb, kb, vb))
        kw = dict(causal=True, window=window, softcap=GEMMA_SOFTCAP)
        kernel = lambda: att_ops.flash_attention(  # noqa: E731
            qb, kb, vb, **kw)
        fp32 = lambda: att_ops.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: att_ops.attention_plain(  # noqa: E731
            qb, kb, vb, **kw)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        long = S > 1024
        t = {"shape": [B, S, Hq, Hkv, hd], "dtype": "bfloat16",
             "window": window, "softcap": GEMMA_SOFTCAP,
             "ms": time_ms(kernel, iters=5 if long else 50),
             "device_ms": device_ms(kernel, calls=5 if long else 20),
             "fp32_device_ms": device_ms(fp32, calls=5 if long else 20),
             "plain_ms": time_ms(plain, iters=2 if long else 10,
                                 warmup=1 if long else 5),
             "library_ms": None, "library": "none (softcap)",
             "sdpa_causal_no_softcap_ms": time_ms(sdpa,
                                                  iters=5 if long else 50)}
        pairs = attended_pairs(S, window)
        t["flops"] = 4.0 * B * Hq * pairs * hd
        in_elems = B * S * hd * (Hq + 2 * Hkv)
        out_bytes = 4.0 * B * S * Hq * hd
        t.update(bf16_bound(t["flops"], 2.0 * in_elems + out_bytes))
        fp32_bound = bound(t["flops"], 4.0 * in_elems + out_bytes,
                           tensor_cores=True)
        t["fp32_bound_ms"] = fp32_bound["bound_ms"]
        t["fp32_bound_by"] = fp32_bound["bound_by"]
        print(f"  flash_attention at gemma2-2b's {name} "
              f"[{B}, {S}, {Hq}/{Hkv}, {hd}] (causal, window {window}, "
              f"softcap {GEMMA_SOFTCAP:g}; {t['flops'] / 1e9:.1f} GFLOP "
              f"over {pairs} pairs a head), bf16 inputs as the main path "
              f"passes them: kernel {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f}, library "
              f"none (softcap; SDPA causal without it, bf16, "
              f"{t['sdpa_causal_no_softcap_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bound_kind']}); "
              f"the kernel's device time is "
              f"{t['device_ms'] / t['bound_ms']:.2f}x the bound. The fp32 "
              f"function: device {t['fp32_device_ms']:.4f} ms, bound "
              f"{t['fp32_bound_ms']:.4f} ({t['fp32_bound_by']}, 3xTF32), "
              f"{t['fp32_device_ms'] / t['fp32_bound_ms']:.2f}x")
        out[name] = t
        del q, k, v, qb, kb, vb, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def qwen3_timing(gen) -> dict:
    """Flash attention at qwen3-moe-30b-a3b's prefill shape [4, 512,
    32/4, 128], causal, on bf16 q, k, v as the main path passes them (the
    wrapper's fp32 copies in the times): kernel, plain version and SDPA
    (`is_causal`, `enable_gqa`), which computes the same function here
    (no window, no softcap) in bf16, eager (`ms`) and on the card
    (`device_ms`), beside `bf16_bound` of the unmasked pairs' work; the
    fp32 function (fp32 inputs) beside it. SDPA's output is held to the
    plain version's within the bf16 tolerance."""
    B, S, Hq, Hkv, hd = QWEN3_ATT
    q = torch.randn((B, S, Hq, hd), generator=gen).cuda()
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen).cuda()
            for _ in range(2))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qb, kb, vb))
    kernel = lambda: att_ops.flash_attention(  # noqa: E731
        qb, kb, vb, causal=True)
    fp32 = lambda: att_ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: att_ops.attention_plain(  # noqa: E731
        qb, kb, vb, causal=True)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    want = plain()
    library_err = float((sdpa().transpose(1, 2).float() - want).abs().max())
    if library_err > LM_TOL:
        raise AssertionError(f"SDPA parts from the plain version by "
                             f"{library_err}")
    t = {"shape": [B, S, Hq, Hkv, hd], "dtype": "bfloat16",
         "ms": time_ms(kernel), "device_ms": device_ms(kernel),
         "fp32_device_ms": device_ms(fp32),
         "plain_ms": time_ms(plain, iters=10),
         "plain_device_ms": device_ms(plain, calls=5),
         "library_ms": time_ms(sdpa), "library_device_ms": device_ms(sdpa),
         "library": "scaled_dot_product_attention(is_causal, enable_gqa)",
         "library_max_abs_err": library_err}
    pairs = attended_pairs(S)
    t["flops"] = 4.0 * B * Hq * pairs * hd
    in_elems = B * S * hd * (Hq + 2 * Hkv)
    out_bytes = 4.0 * B * S * Hq * hd
    t["bytes"] = 2.0 * in_elems + out_bytes
    t.update(bf16_bound(t["flops"], t["bytes"]))
    fp32_bound = bound(t["flops"], 4.0 * in_elems + out_bytes,
                       tensor_cores=True)
    t["fp32_bound_ms"] = fp32_bound["bound_ms"]
    print(f"  flash_attention at qwen3-moe-30b-a3b's prefill shape "
          f"[{B}, {S}, {Hq}/{Hkv}, {hd}] (causal; {t['flops'] / 1e9:.2f} "
          f"GFLOP, {t['bytes'] / 1e6:.1f} MB), bf16 inputs as the main path "
          f"passes them: kernel {t['ms']:.4f} ms (device "
          f"{t['device_ms']:.4f}), plain {t['plain_ms']:.4f} (device "
          f"{t['plain_device_ms']:.4f}), SDPA, the same function, "
          f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f}; "
          f"max_abs_err against plain {library_err:.3g}), bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bound_kind']}); "
          f"the kernel's device time is {t['device_ms'] / t['bound_ms']:.2f}x "
          f"the bound and {t['device_ms'] / t['library_device_ms']:.2f}x "
          f"SDPA's. The fp32 function: device {t['fp32_device_ms']:.4f} ms, "
          f"bound {t['fp32_bound_ms']:.4f} (3xTF32)")
    del q, k, v, qb, kb, vb, qt, kt, vt, want
    torch.cuda.empty_cache()
    return t


def timing_phase():
    gen = torch.Generator().manual_seed(99)
    att = attention_timing(gen, MAIN_ATT)

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
    return (att, cka, wkv, bert_timing(gen), gemma_timing(gen),
            qwen3_timing(gen))


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
    _, _, busy = busy_run(lambda: [run() for _ in range(calls)])
    return busy * 1e3 / calls


def example_bound(dims, n=CNN_PROBE) -> dict:
    """The least time for the CKA terms of n examples at feature dims
    `dims` (one X and one Y of d columns each): each input read once,
    three floats written a launch, against the example form's products,
    the upper triangles of XX^T and YY^T (2d n(n+1)/2 FMAs each) and their
    n(n+1)/2 entry products, as 3xTF32 as the kernel takes them."""
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
    profile_mixed()
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
    kmodel, params = lm_model(rwkv, use_pallas=True)
    prompts = np.random.default_rng(0).integers(
        0, rwkv.vocab_size, MAIN_WKV[:2]).astype(np.int32)
    serve(kmodel, params, prompts)  # warm-up outside the profiled window
    report_profile(rwkv.name, lambda: serve(kmodel, params, prompts))
    cudnn_deterministic_cost()


def profile_mixed() -> None:
    """The full-width `mixed` session of `mixed_phase` under the
    profiler, compiled with its graphs captured beforehand, and eager."""
    scale = {k: v for k, v in WORKLOAD_SCALE.items() if k != "batch_size"}
    models = mixed_models(True)
    benches = workload_benches(presets(seed=0, **scale)["mixed"],
                               models["cv"].cfg)
    with CAPTURES:
        run_mixed(models, benches, compiled=True)
    report_profile("mixed (MobileNetV2 + bert-base), compiled (graphs "
                   "captured)", lambda: run_mixed(models, benches,
                                                  compiled=True))
    report_profile("mixed (MobileNetV2 + bert-base), eager",
                   lambda: run_mixed(models, benches, compiled=False))


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


def bf16_bound(flops: float, nbytes: float) -> dict:
    """The least time for `flops` operations on bf16 inputs and `nbytes`
    bytes: one bf16 product with fp32 accumulation for each, at the dense
    bf16 tensor-core peak (a bf16 x bf16 product is exact in fp32)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_kind": "bf16 tensor cores"}


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

    def phase(title: str) -> None:
        print(f"{title} [{time.perf_counter() - t0:.1f} s since the build "
              f"began]")

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

    phase("phase 2: kernels against their plain versions")
    (att_err, cka_err, cnn_err, wkv_err, bert_att_err, bert_cka_err,
     lm_att_err, qwen3_att_err) = kernel_phase()
    # qwen3-moe's 62 GB go first: the later phases keep ~20 GiB on the
    # card (the compiled and mixed sessions' graphs among them)
    phase("phase 3: qwen3-moe-30b-a3b serving at full width and depth, "
          "128 experts top-8 on every layer, the flash kernel on its "
          "prefill")
    qwen3 = moe_phase(get_config("qwen3-moe-30b-a3b"))
    phase("phase 3: jamba's mamba block at full width; the reduced jamba "
          "served")
    jamba = mamba_phase()
    phase("phase 3: LM training: gemma2-2b at full width and depth, flash "
          "on its frozen prefix, the checkpoint round trip; rwkv6-3b, WKV6 "
          "on its frozen prefix")
    train = train_lm_phase()
    phase("phase 3: DeiT-tiny serving and SimFreeze probes at full width")
    launches = slice_phase(get_config("deit-tiny"))
    phase("phase 3: the ETuner loop on DeiT-tiny at full width")
    loop_launches = etuner_phase(get_config("deit-tiny"))
    phase("phase 3: the ETuner loop on MobileNetV2 at full width")
    mbv2_launches = cnn_loop_phase(get_config("mobilenetv2"), repeat=True)
    phase("phase 3: the ETuner loop on ResNet50 at full width")
    resnet_launches = cnn_loop_phase(get_config("resnet50"), repeat=False)
    phase("phase 3: the round hooks (fake-quant 8 bits, SimSiam 0.5) on "
          "MobileNetV2 at full width")
    hooks_phase(get_config("mobilenetv2"))
    phase("phase 3: the paper's baselines (Table V) on MobileNetV2 at full "
          "width")
    baselines = baselines_phase()
    phase("phase 3: the paper's harness: Tables II and IV through "
          "run_method, the workloads sweep, the quickstart")
    harness = harness_phase()
    phase("phase 3: the compiled hot path at full width (CUDA graphs)")
    with CAPTURES:
        compiled_launches = compiled_phase()
    phase("phase 3: bert-base serving at full width, 512 positions")
    bert_serving = bert_serving_phase()
    phase("phase 3: the mixed session at full width (MobileNetV2 and "
          "bert-base, two slots on one card)")
    with CAPTURES:
        mixed = mixed_phase()
    phase("phase 3: the multi-device fleet and its environment on "
          "MobileNetV2 at full width")
    fleet, fleet_runs = fleet_phase()
    phase("phase 3: live telemetry on the fleet (tracer, metrics, sinks)")
    traced = telemetry_phase(fleet_runs)
    del fleet_runs
    phase("phase 3: rwkv6-3b serving at full width and depth")
    rwkv = get_config("rwkv6-3b")
    wkv_launches = rwkv_phase(rwkv)
    phase("phase 3: gemma2-2b serving at full width and depth, the flash "
          "kernel on its prefill")
    gemma = lm_phase(get_config("gemma2-2b"))
    phase("phase 4: timing at the main-path shapes (CUDA events)")
    att, cka, wkv, bert, gemma_att, qwen3_att = timing_phase()
    cka_feature = {k: v for k, v in cka.items() if k != "cnn"}
    if args.profile:
        phase("phase 5: where the slices' time goes (torch.profiler)")
        profile_phase(get_config("deit-tiny"), rwkv)

    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:80",
         "launches": mixed["flash_eager"],
         "launches_by_path": {
             "mixed_loop": mixed["flash_eager"],
             "compiled mixed": mixed["flash_card"],
             "bert_serving": bert_serving["launches"],
             "etuner_loop": loop_launches["flash_attention"],
             "serving_and_probes": launches["flash_attention"],
             **{f"compiled {name}": n["flash_attention"]
                for name, n in compiled_launches.items()
                if n["flash_attention"]},
             "gemma2_serving": gemma["serving"],
             "gemma2_long": gemma["long"],
             "qwen3_moe_serving": qwen3["serving"],
             "qwen3_moe_fp32": qwen3["fp32"],
             "jamba_reduced": jamba["jamba_reduced"],
             "gemma2_train": train["gemma2_train"],
             "gemma2_train_fp32": train["gemma2_train_fp32"],
             "harness_table4": harness["table4"]},
         "max_abs_err": bert_att_err, **bert["attention"]["loop"],
         "bert_serving": bert["attention"]["serving"],
         "deit_tiny": {"max_abs_err": att_err, **att},
         "gemma2": {"max_abs_err": lm_att_err, "serving_run": gemma,
                    "training_run": train, **gemma_att},
         "qwen3_moe": {"max_abs_err": qwen3_att_err, "serving_run": qwen3,
                       "jamba": jamba, **qwen3_att}},
        {"name": "cka_terms", "route": "cuda",
         "source": "src/repro_torch/csrc/cka_terms.cu",
         "replaces": "src/repro/kernels/cka/kernel.py:56",
         "launches": mbv2_launches["cka_terms"],
         "launches_by_path": {
             "cnn_loop_mobilenetv2": mbv2_launches["cka_terms"],
             "cnn_loop_resnet50": resnet_launches["cka_terms"],
             "etuner_loop": loop_launches["cka_terms"],
             "serving_and_probes": launches["cka_terms"],
             "mixed_loop": mixed["cka_eager"],
             **{f"compiled {name}": n["cka_terms"]
                for name, n in compiled_launches.items()},
             "baselines": baselines, "fleet": fleet,
             "fleet_traced": traced,
             "harness_table2": harness["table2"],
             "harness_sweep": harness["sweep"]},
         "launches_by_route": {
             route: sum(p[f"cka_{route}"] for p in (
                 mbv2_launches, resnet_launches, loop_launches, launches))
             + (mixed["cka_eager"] + sum(baselines.values())
                + sum(n for runs in (fleet, traced)
                      for devs in runs.values() for n in devs.values())
                if route == "example" else 0)
             for route in ("feature", "example")},
         "max_abs_err": cnn_err, **cka_record(cka),
         "bert_probe": {"max_abs_err": bert_cka_err, **bert["cka"]},
         "feature_route": {"max_abs_err": cka_err, **cka_feature}},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv/kernel.py:58",
         "launches": wkv_launches,
         "launches_by_path": {"rwkv6_serving": wkv_launches,
                              "rwkv6_train": train["rwkv6_train"]},
         "max_abs_err": wkv_err, **wkv},
    ]}
    print(f"all phases done in {time.perf_counter() - t0:.1f} s since the "
          f"build began")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
