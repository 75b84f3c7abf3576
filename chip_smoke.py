#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # and phase 5 as well

It imports nothing of JAX and nothing of the JAX package, and fails
(non-zero exit, no result line) on the first mismatch. In order:

1. card and software: the card's name, power limit and driver, torch and
   CUDA versions; builds both CUDA kernels from `src/repro_torch/csrc`
   (one nvcc process each, started together), prints the build time and
   which CUDA runtime libraries the process has mapped;
2. kernel phase: each kernel against its plain PyTorch version on the
   card, at the main-path shapes and at ragged, masked, GQA and head-dim
   variants; the CKA kernel also for CKA(x, x) = 1 and for two launches
   that agree bit for bit;
3. slice phase at full width: DeiT-tiny (`get_config("deit-tiny")`,
   224x224, 12 layers, d=192) with params from a seeded
   `torch.Generator`, serving every inference event of a
   `build_timeline` through `InferenceServer` and running SimFreeze's CKA
   probe on every data event under `EventScheduler`, with the kernels and
   again with the plain paths (`use_pallas`/`use_kernel` off); the two
   runs must give the same accuracies, freeze plans and CKA FLOPs, logits
   and CKA histories within the kernel tolerances, and the kernel run must
   have launched both kernels the expected number of times. Once more
   with coalesced serving (`batch_window` > 0): the same accuracies;
4. timing: each kernel, its plain version and (attention) PyTorch's
   `scaled_dot_product_attention` at the main-path shapes, with CUDA
   events after a warm-up, beside the bound the card's published peaks
   set for the least work the function needs; for CKA also the feature
   form that `core/cka.py` takes without the kernel; and the slice's
   requests per second;
5. only with --profile: one more kernel run of the slice under
   torch.profiler, for the device's busy share of its wall time and the
   kernels that fill it.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
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

from repro_torch import tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cka import cka_feature_form  # noqa: E402
from repro_torch.core.simfreeze import SimFreeze, SimFreezeConfig  # noqa: E402
from repro_torch.data.arrivals import build_timeline  # noqa: E402
from repro_torch.data.streams import nc_benchmark  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention import ops as att_ops  # noqa: E402
from repro_torch.kernels.cka import ops as cka_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.costmodel import EdgeCostModel  # noqa: E402
from repro_torch.runtime.inference import InferenceServer  # noqa: E402
from repro_torch.runtime.ledger import CostLedger  # noqa: E402
from repro_torch.runtime.scheduler import EventScheduler  # noqa: E402
from repro_torch.runtime.train_loop import as_tensor  # noqa: E402

# kernel tolerances, as tests/test_kernels.py holds the Pallas kernels
ATT_RTOL, ATT_ATOL = 2e-4, 2e-5
CKA_RTOL = 1e-4
CKA_HISTORY_ATOL = 1e-4
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 on the CUDA
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# main-path shapes: DeiT-tiny at 224x224 (197 tokens, 3 heads of 64) on a
# 16-image batch; the CKA probe flattens [16, 197, 192] to 3152 x 192
MAIN_ATT = (16, 197, 3, 64)
MAIN_CKA = (16 * 197, 192)
THRESHOLD = 0.01
INFER_BATCH = 16


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
    q = torch.randn((B, S, Hq, hd), generator=gen).cuda()
    k = torch.randn((B, S, Hkv, hd), generator=gen).cuda()
    v = torch.randn((B, S, Hkv, hd), generator=gen).cuda()
    got = att_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    want = att_ops.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=ATT_RTOL, atol=ATT_ATOL)
    err = float((got - want).abs().max())
    print(f"  flash B{B} S{S} Hq{Hq} Hkv{Hkv} hd{hd} causal={causal} "
          f"window={window} softcap={softcap}: max_abs_err {err:.3g}")
    return err


def _cka_inputs(gen, n, dx, dy):
    x = torch.randn((n, dx), generator=gen)
    y = 0.3 * x[:, :dy] if dy <= dx else torch.zeros((n, dy))
    y = y + torch.randn((n, dy), generator=gen)
    return x.cuda(), y.cuda()


def check_cka(gen, n, dx, dy) -> float:
    x, y = _cka_inputs(gen, n, dx, dy)
    got = torch.stack(cka_ops.cka_terms(x, y))
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    hsic, kk, ll = cka_ops.cka_terms_plain(xc, yc)
    want = torch.stack([hsic, kk.sqrt(), ll.sqrt()])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=CKA_RTOL, atol=0.0)
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    print(f"  cka n{n} dx{dx} dy{dy}: max_abs_err {err:.3g} "
          f"(max_rel_err {rel:.3g})")
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

    cka_err = check_cka(gen, *MAIN_CKA, MAIN_CKA[1])  # main path
    for n, dx, dy in ((200, 300, 300), (520, 192, 192), (100, 1000, 1000),
                      (300, 192, 100)):
        check_cka(gen, n, dx, dy)
    x, _ = _cka_inputs(gen, 520, 192, 192)
    one = float(cka_ops.cka(x, x))
    if abs(one - 1.0) >= 1e-5:
        raise AssertionError(f"CKA(x, x) = {one!r}, not 1 within 1e-5")
    a, b = _cka_inputs(gen, *MAIN_CKA, MAIN_CKA[1])
    first = torch.stack(cka_ops.cka_terms(a, b))
    second = torch.stack(cka_ops.cka_terms(a, b))
    if not torch.equal(first, second):
        raise AssertionError(f"two CKA launches differ: {first} {second}")
    print(f"  cka(x, x) = {one!r}; two launches agree bit for bit")
    return att_err, cka_err


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


def slice_setup(cfg):
    """The kernel and plain models, and the run's params, data, timeline
    and perturbation, all from fixed seeds."""
    kmodel = build_model(cfg.replace(use_pallas=True))
    pmodel = build_model(cfg.replace(use_pallas=False))
    params0 = kmodel.init(torch.Generator().manual_seed(0))
    move = perturbation(params0, seed=11, scale=0.5)
    bench = nc_benchmark(num_classes=50, num_scenarios=4, batches=6,
                         batch_size=16, image_size=cfg.image_size, seed=0)
    events = [dataclasses.replace(e, scenario=e.scenario + 1)
              for e in build_timeline(num_scenarios=3, batches_per_scenario=6,
                                      inferences_total=48, seed=0)]
    return kmodel, pmodel, (params0, bench, events, move)


def slice_phase(cfg):
    kmodel, pmodel, common = slice_setup(cfg)

    att_ops.flash_attention.launches = cka_ops.cka_terms.launches = 0
    kern = run_slice(kmodel, *common, use_kernel=True)
    launches = {"flash_attention": att_ops.flash_attention.launches,
                "cka_terms": cka_ops.cka_terms.launches}

    att_ops.flash_attention.launches = cka_ops.cka_terms.launches = 0
    plain = run_slice(pmodel, *common, use_kernel=False)
    if att_ops.flash_attention.launches or cka_ops.cka_terms.launches:
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
          f"(expected {L + 1} x {kern['passes']})")
    if launches["flash_attention"] != L * forwards or \
            launches["cka_terms"] != (L + 1) * kern["passes"] or \
            not all(launches.values()):
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
# phase 4: timing


def time_ms(fn, iters=50, warmup=5) -> float:
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


def timing_phase():
    gen = torch.Generator().manual_seed(99)
    B, S, H, hd = MAIN_ATT
    q, k, v = (torch.randn((B, S, H, hd), generator=gen).cuda()
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    att = {
        "ms": time_ms(lambda: att_ops.flash_attention(q, k, v, causal=False)),
        "plain_ms": time_ms(lambda: att_ops.attention_plain(q, k, v,
                                                            causal=False)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
    }
    flops = 4.0 * B * H * S * S * hd
    nbytes = 4.0 * 4 * B * S * H * hd
    att.update(bound(flops, nbytes))

    n, d = MAIN_CKA
    x, y = _cka_inputs(gen, n, d, d)
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    cka = {
        "ms": time_ms(lambda: cka_ops._launch(xc, yc)),
        "plain_ms": time_ms(lambda: cka_ops.cka_terms_plain(xc, yc)),
        "library_ms": None,
    }
    # the least work: the feature form, Y^T X and the upper triangles of
    # X^T X and Y^T Y
    flops = 2.0 * n * (d * d + d * (d + 1))
    nbytes = 4.0 * n * (d + d) + 4 * 3
    cka.update(bound(flops, nbytes))
    # the kernel's own design tiles the upper triangle of both n x n Grams
    design = bound(2.0 * (d + d) * n * (n + 1) / 2, nbytes)
    feature_ms = time_ms(lambda: cka_feature_form(xc, yc, use_kernel=False))
    for name, t in (("flash_attention", att), ("cka_terms", cka)):
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, library {lib} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    print(f"  cka_terms: the plain feature form that core/cka.py takes "
          f"without the kernel {feature_ms:.4f} ms; the limit of the "
          f"kernel's example-form design only {design['bound_ms']:.4f} ms "
          f"({design['bound_by']})")
    return att, cka


def profile_phase(cfg) -> None:
    """One more kernel run of the slice under torch.profiler: the device's
    busy share of the run's wall time and the kernels that fill it."""
    from torch.profiler import ProfilerActivity, profile

    kmodel, _, common = slice_setup(cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_slice(kmodel, *common, use_kernel=True)
    # device-side rows only (kernels, copies): operator rows repeat the
    # time of the kernels they launched
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("  the profiler recorded no device time: busy share not measured")
        return
    print(f"  under the profiler: wall {res['wall_s']:.3f} s, device busy "
          f"{busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / res['wall_s']:.1f}% "
          f"of wall)")
    for us, name, count in rows[:8]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% x{count:<5d} "
              f"{name[:90]}")


def bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
    reports = build.build(["flash_attention", "cka_terms"])
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    for name in ("flash_attention", "cka_terms"):
        build.load(name)
    print(f"  CUDA runtime mapped: {mapped_cudart()}")

    print("phase 2: kernels against their plain versions")
    att_err, cka_err = kernel_phase()
    print("phase 3: DeiT-tiny serving and SimFreeze probes at full width")
    launches = slice_phase(get_config("deit-tiny"))
    print("phase 4: timing at the main-path shapes (CUDA events)")
    att, cka = timing_phase()
    if args.profile:
        print("phase 5: where the slice's time goes (torch.profiler)")
        profile_phase(get_config("deit-tiny"))

    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:80",
         "launches": launches["flash_attention"], "max_abs_err": att_err,
         **att},
        {"name": "cka_terms", "route": "cuda",
         "source": "src/repro_torch/csrc/cka_terms.cu",
         "replaces": "src/repro/kernels/cka/kernel.py:56",
         "launches": launches["cka_terms"], "max_abs_err": cka_err, **cka},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
