"""The port's fine-tuning slice against the JAX package on the CPU, at the
reduced DeiT-tiny: the optimizers, the gradient of `loss` under freeze
plans, `TrainStepCache`, `FineTuneExecutor`, the controller modules
(curve fit, LazyTune, the energy-score detector, every policy and
`ETunerController`), and the ETuner loop as a whole against a live
`ContinualRuntime.run` in the same process.

Inputs are the same numpy arrays on both sides, and the JAX params cross
by `bridge.params_from_jax`. The JAX side runs its Pallas kernels in
interpret mode (`use_pallas`, `use_kernel`), the port the plain versions
its kernel wrappers take on the CPU.
"""
import contextlib
import dataclasses
import math
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import controller as jax_controller
from repro.core import curvefit as jax_curvefit
from repro.core import lazytune as jax_lazytune
from repro.core import ood as jax_ood
from repro.core import policies as jax_policies
from repro.core.freeze_plan import LayerFreezePlan as JaxLayerFreezePlan
from repro.core.simfreeze import SimFreezeConfig as JaxSimFreezeConfig
from repro.data.streams import nc_benchmark as jax_nc_benchmark
from repro.models import build_model as jax_build_model
from repro.optim import optimizer as jax_optim
from repro.runtime import executor as jax_executor
from repro.runtime import train_loop as jax_train_loop
from repro.runtime.config import RuntimeConfig
from repro.runtime.continual import ContinualRuntime
from repro.runtime.costmodel import EdgeCostModel as JaxEdgeCostModel
from repro.runtime.ledger import CostLedger as JaxCostLedger
from repro.runtime.scheduler import EventScheduler as JaxEventScheduler
from repro_torch import tree_leaves, tree_map
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import curvefit, lazytune, ood, policies
from repro_torch.core.controller import ETunerConfig, ETunerController
from repro_torch.core.freeze_plan import LayerFreezePlan
from repro_torch.core.lazytune import LazyTuneConfig
from repro_torch.core.policies import adapt_controller
from repro_torch.core.simfreeze import SimFreezeConfig
from repro_torch.data.arrivals import build_timeline
from repro_torch.data.streams import nc_benchmark
from repro_torch.models import build_model
from repro_torch.optim import optimizer as optim
from repro_torch.runtime.costmodel import EdgeCostModel
from repro_torch.runtime.config import RuntimeConfig as PortRuntimeConfig
from repro_torch.runtime.continual import \
    ContinualRuntime as PortContinualRuntime
from repro_torch.runtime.executor import (FineTuneExecutor, ReplayBuffer,
                                          RoundHook)
from repro_torch.runtime.ledger import CostLedger
from repro_torch.runtime.scheduler import EventScheduler
from repro_torch.runtime.train_loop import (TrainStepCache, as_tensor,
                                            batch_signature, evaluate,
                                            grads_of, make_optimizer_state,
                                            same_shape_runs)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jax_get_reduced("deit-tiny").replace(use_pallas=True),
            get_reduced("deit-tiny").replace(use_pallas=True))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jax_params, cfg):
    """JAX params (or grads) in the port's layout, on the CPU."""
    return params_from_jax(_host(jax_params), cfg, device=CPU)


# ---------------------------------------------------------------------------
# the ETuner loop: the port's ContinualRuntime, one device, one stream,
# oracle boundaries


def run_loop(model, params, bench, events, ctrl, *, opt_cfg, seed=0,
             replay_batches=2, pretrain_epochs=1, inference_batch=16):
    """The port's ETuner loop over `events` through its `ContinualRuntime`
    on the model's device, pretraining from `params`; returns what a
    `RunResult` reports, and the freeze plan of every round."""
    model = dataclasses.replace(model, init=lambda generator: params)
    rt = PortContinualRuntime.from_config(
        PortRuntimeConfig(seed=seed, replay_batches=replay_batches,
                          pretrain_epochs=pretrain_epochs,
                          inference_batch=inference_batch),
        device=model.device, model=model, benchmark=bench, controller=ctrl,
        opt_cfg=opt_cfg)
    with _PlanSpy(FineTuneExecutor) as spy:
        r = rt.run(events=events)
    return {"rounds": r.rounds, "recompiles": r.recompiles,
            "controller_stats": r.controller_stats,
            "round_plans": spy.plans, "inference_accs": r.inference_accs,
            "val_curve": r.val_curve, "total_time_s": r.total_time_s,
            "total_energy_j": r.total_energy_j, "breakdown": r.breakdown,
            "params": rt.fleet.devices[0].primary.executor.params}


LOOP_BENCH = dict(num_classes=10, num_scenarios=3, batches=6, batch_size=8,
                  seed=0)
LOOP_INFERENCES = 16


def _etuner_config(api, freeze_interval):
    return api.ETunerConfig(
        lazytune_cfg=api.LazyTuneConfig(max_batches_needed=6),
        simfreeze_cfg=api.SimFreezeConfig(freeze_interval=freeze_interval,
                                          min_history=2, cka_threshold=0.01,
                                          use_kernel=True))


class _JaxApi:
    ETunerConfig = jax_controller.ETunerConfig
    LazyTuneConfig = jax_lazytune.LazyTuneConfig
    SimFreezeConfig = JaxSimFreezeConfig


class _PortApi:
    ETunerConfig = ETunerConfig
    LazyTuneConfig = LazyTuneConfig
    SimFreezeConfig = SimFreezeConfig


class _PlanSpy:
    """Records the freeze plan of every round an executor class runs (the
    runtime reports only counts)."""

    def __init__(self, cls):
        self.cls, self.plans = cls, []
        self._orig = cls.execute_round

    def __enter__(self):
        spy = self

        def execute_round(ex, plan, *a, **k):
            if ex.buffers.get(k.get("stream", 0)):
                spy.plans.append(plan.layers)
            return spy._orig(ex, plan, *a, **k)

        self.cls.execute_round = execute_round
        return self

    def __exit__(self, *exc):
        self.cls.execute_round = self._orig


def run_reference(freeze_interval):
    jcfg, _ = _cfgs()
    model = jax_build_model(jcfg)
    bench = jax_nc_benchmark(image_size=jcfg.image_size, **LOOP_BENCH)
    ctrl = jax_controller.ETunerController(
        model, _etuner_config(_JaxApi, freeze_interval))
    rt = ContinualRuntime.from_config(
        RuntimeConfig(seed=0, pretrain_epochs=1), model=model,
        benchmark=bench, controller=ctrl)
    with _PlanSpy(jax_executor.FineTuneExecutor) as spy:
        r = rt.run(inferences_total=LOOP_INFERENCES)
    return {"rounds": r.rounds, "recompiles": r.recompiles,
            "controller_stats": r.controller_stats,
            "round_plans": spy.plans, "inference_accs": r.inference_accs,
            "val_curve": r.val_curve, "total_time_s": r.total_time_s,
            "total_energy_j": r.total_energy_j, "breakdown": r.breakdown,
            "params": rt.fleet.devices[0].primary.executor.params}


def run_port(freeze_interval):
    jcfg, cfg = _cfgs()
    model = build_model(cfg, device=CPU)
    # the reference's pretraining starts from init(PRNGKey(seed))
    params = _port(jax_build_model(jcfg).init(jax.random.PRNGKey(0)), cfg)
    bench = nc_benchmark(image_size=cfg.image_size, **LOOP_BENCH)
    events = [dataclasses.replace(e, scenario=e.scenario + 1)
              for e in build_timeline(
                  num_scenarios=bench.num_scenarios - 1,
                  batches_per_scenario=len(bench.scenarios[1].train_batches),
                  inferences_total=LOOP_INFERENCES, seed=0)]
    ctrl = ETunerController(model, _etuner_config(_PortApi, freeze_interval))
    return run_loop(model, params, bench, events, ctrl,
                    opt_cfg=optim.AdamWConfig(lr=1e-3))


# ---------------------------------------------------------------------------
# optimizers


def _pairs(want, got):
    """(want leaf, got leaf) pairs of two trees of one structure, matched
    by key (JAX orders dict leaves by sorted key, the port by insertion)."""
    if isinstance(got, dict):
        return [p for k in got for p in _pairs(want[k], got[k])]
    if isinstance(got, (list, tuple)):
        return [p for w, g in zip(want, got, strict=True)
                for p in _pairs(w, g)]
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    return [(np.asarray(want, np.float32), np.asarray(got))]


def _opt_tree(rng, scale=1.0):
    """A params-shaped tree: dicts, a list of blocks and a [G, ...] leaf."""
    def r(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"a": r(3, 4), "blocks": [{"w": r(5), "g": r(2, 3, 2)},
                                     {"w": r(5), "g": r(2, 3, 2)}],
            "head": {"b": r(7)}}


def _opt_masks():
    return {"a": 1.0, "blocks": [{"w": 0.0, "g": np.array([1.0, 0.0])},
                                 {"w": 1.0, "g": np.array([0.0, 1.0])}],
            "head": {"b": 0.0}}


def _run_optimizer(side, kind, steps_grads, params, masks, cfg_kw):
    """`len(steps_grads)` updates from `params`, on JAX or the port."""
    if side == "jax":
        to = lambda t: jax.tree.map(jnp.asarray, t)
        mod, back = jax_optim, _host
    else:
        to = lambda t: tree_map(lambda a: torch.as_tensor(np.asarray(a)), t)
        mod = optim
        back = lambda t: t
    cfg = (mod.AdamWConfig if kind == "adamw" else mod.SGDMConfig)(**cfg_kw)
    init = mod.adamw_init if kind == "adamw" else mod.sgdm_init
    update = mod.adamw_update if kind == "adamw" else mod.sgdm_update
    p = to(params)
    state = init(p, cfg)
    for g in steps_grads:
        p, state = update(to(g), state, p, cfg, lr_scale=0.5,
                          masks=None if masks is None else to(masks))
    moments = (state.m, state.v) if kind == "adamw" else (state.mom,)
    return back(p), [back(t) for t in moments], int(state.step)


@pytest.mark.parametrize("kind,masked,clip", [
    ("adamw", False, 1.0), ("adamw", True, 1.0), ("adamw", False, 0.0),
    ("adamw", True, 0.0), ("sgdm", False, 0.0), ("sgdm", True, 0.0),
    ("sgdm", False, 1.0), ("sgdm", True, 1.0)])
def test_optimizer_updates_match_jax(kind, masked, clip):
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    # the clip binds on the large grads and not on the small ones
    grads = [_opt_tree(rng, scale) for scale in (1.0, 1e-3, 0.3)]
    masks = _opt_masks() if masked else None
    cfg_kw = {"clip_norm": clip}
    a = _run_optimizer("jax", kind, grads, params, masks, cfg_kw)
    b = _run_optimizer("port", kind, grads, params, masks, cfg_kw)
    assert a[2] == b[2] == 3
    for x, y in _pairs([a[0], a[1]], [b[0], b[1]]):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
    if masked:  # frozen leaves keep their params exactly
        np.testing.assert_array_equal(b[0]["head"]["b"], params["head"]["b"])
        np.testing.assert_array_equal(b[0]["blocks"][0]["g"][1],
                                      params["blocks"][0]["g"][1])


def test_optimizer_state_dtype_and_norms_match_jax():
    rng = np.random.default_rng(2)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    a = _run_optimizer("jax", "adamw", [grads], params, None,
                       {"state_dtype": "bfloat16"})
    b = _run_optimizer("port", "adamw", [grads], params, None,
                       {"state_dtype": "bfloat16"})
    assert b[1][0]["a"].dtype == torch.bfloat16
    for x, y in _pairs([a[0], a[1]], [b[0], b[1]]):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
    tg = tree_map(torch.as_tensor, grads)
    np.testing.assert_allclose(float(optim.global_norm(tg)),
                               float(jax_optim.global_norm(grads)), rtol=1e-6)
    clipped, norm = optim.clip_by_global_norm(tg, 0.5)
    want, wnorm = jax_optim.clip_by_global_norm(grads, 0.5)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for x, y in _pairs(want, clipped):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-7)
    for step in (0, 1, 50, 100, 5000, 10_000, 20_000):
        np.testing.assert_allclose(
            float(optim.cosine_schedule(step, base_lr=3e-4)),
            float(jax_optim.cosine_schedule(step, base_lr=3e-4)), rtol=1e-6)


def _keyed_case(side, kind, reorder):
    """One masked update of params {"a", "b"} with "b" frozen, from a
    nonzero optimizer state, with the mask tree or the state's dicts in
    the other key order (ROADMAP C.6: leaves pair by key, not position)."""
    def f32(*v):
        return np.float32(v)

    params = {"a": f32(1.0, -0.5), "b": f32(2.0, 0.25)}
    grads = {"a": f32(0.5, 0.1), "b": f32(-0.3, 0.7)}
    masks = {"a": np.float32(1.0), "b": np.float32(0.0)}
    first = {"a": f32(0.02, -0.01), "b": f32(0.05, 0.03)}
    second = {"a": f32(4e-4, 1e-4), "b": f32(9e-4, 2e-4)}
    swap = lambda d: {k: d[k] for k in reversed(list(d))}
    if reorder == "masks":
        masks = swap(masks)
    else:
        first, second = swap(first), swap(second)
    if side == "jax":
        mod, to, step = jax_optim, lambda t: jax.tree.map(jnp.asarray, t), \
            jnp.int32(1)
    else:
        mod, step = optim, torch.tensor(1, dtype=torch.int32)
        to = lambda t: tree_map(lambda a: torch.as_tensor(np.asarray(a)), t)
    if kind == "adamw":
        cfg = mod.AdamWConfig(clip_norm=0.0)
        state = mod.AdamWState(step=step, m=to(first), v=to(second))
        update = mod.adamw_update
    else:
        cfg = mod.SGDMConfig()
        state = mod.SGDMState(step=step, mom=to(first))
        update = mod.sgdm_update
    p, state = update(to(grads), state, to(params), cfg, masks=to(masks))
    return ({k: np.asarray(v) for k, v in p.items()},
            [{k: np.asarray(v) for k, v in t.items()}
             for t in (state[1:] if kind == "adamw" else state[1:2])])


@pytest.mark.parametrize("reorder", ["masks", "state"])
@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_optimizer_pairs_leaves_by_key_as_jax(kind, reorder):
    want = _keyed_case("jax", kind, reorder)
    got = _keyed_case("port", kind, reorder)
    for w, g in zip([want[0], *want[1]], [got[0], *got[1]], strict=True):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)
    # "a" steps and the frozen "b" stays
    np.testing.assert_array_equal(got[0]["b"], np.float32([2.0, 0.25]))
    assert not np.allclose(got[0]["a"], np.float32([1.0, -0.5]))


@pytest.mark.parametrize("tree", ["masks", "grads", "state"])
@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_optimizer_raises_on_mismatched_keys(kind, tree):
    t = lambda **kw: {k: torch.full((2,), float(v)) for k, v in kw.items()}
    params, grads, masks = t(a=1, b=2), t(a=0.5, b=0.5), t(a=1, b=0)
    init, update, cfg = (optim.adamw_init, optim.adamw_update,
                         optim.AdamWConfig()) if kind == "adamw" else \
        (optim.sgdm_init, optim.sgdm_update, optim.SGDMConfig())
    state = init(params, cfg)
    if tree == "masks":
        masks = t(a=1)
    elif tree == "grads":
        grads = t(a=0.5, c=0.5)
    else:
        state = init(t(a=1, b=2, c=3), cfg)
    with pytest.raises(ValueError, match="tree structure mismatch"):
        update(grads, state, params, cfg, masks=masks)


# ---------------------------------------------------------------------------
# gradients of the ViT loss under freeze plans

def _grad_setup(batch_size=8, seed=0):
    jcfg, cfg = _cfgs()
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(seed)
    batch = {"images": rng.standard_normal(
                 (batch_size, cfg.image_size, cfg.image_size, 3)
             ).astype(np.float32),
             "labels": rng.integers(0, cfg.num_classes,
                                    batch_size).astype(np.int32)}
    return jcfg, cfg, jmodel, model, jparams, batch


PLANS = {
    "all-active": (False,) * 6,
    "frozen-prefix": (True, True, True, False, False, False),
    "frozen-middle": (False, False, True, False, False, False),
}


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_loss_gradients_match_jax(name):
    jcfg, cfg, jmodel, model, jparams, batch = _grad_setup()
    flags = PLANS[name]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jax_train_loop.as_jnp(batch),
                              JaxLayerFreezePlan(flags))[0])(jparams)
    loss, _, grads = grads_of(model.loss, _port(jparams, cfg),
                              as_tensor(batch, CPU), LayerFreezePlan(flags))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = _port(jgrads, cfg)  # the patch kernel mapped to [p*p*3, d]
    frozen_units = {i for i, f in enumerate(flags) if f}
    for path, g, w in zip(_leaf_paths(want), tree_leaves(grads),
                          tree_leaves(want)):
        g, w = g.numpy(), w.numpy()
        unit = int(path.split("/")[2]) + 1 if path.startswith("/blocks") \
            else 0 if path.split("/")[1] in ("patch", "cls", "pos") \
            else len(flags) - 1 if path.startswith("/head") else None
        if unit in frozen_units or (unit is not None and unit < min(
                [i for i, f in enumerate(flags) if not f])):
            # frozen units, and every unit before the first trained one,
            # get exactly zero on both sides
            assert not g.any() and not w.any(), path
        elif path.endswith("attn/bk"):
            # the key bias shifts every score of a query by one constant,
            # which softmax removes: its gradient is zero in exact
            # arithmetic, and both sides give rounding noise
            blk = path.rsplit("/", 1)[0]
            scale = np.abs(tree_leaves(want)[
                _leaf_paths(want).index(f"{blk}/bq")].numpy()).max()
            assert np.abs(g).max() <= 1e-4 * scale, path
            assert np.abs(w).max() <= 1e-4 * scale, path
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)
            assert np.abs(w).max() > 0, path


def test_frozen_units_move_as_in_jax():
    """A frozen unit gets a zero gradient, and the step still applies
    weight decay and its decaying first moment to it: from the same state
    (JAX's after one all-active step), one step under a plan that freezes
    block 0 moves its leaves as JAX's step does."""
    jcfg, cfg, jmodel, model, jparams, batch = _grad_setup()
    rng = np.random.default_rng(5)
    batch2 = {"images": rng.standard_normal(batch["images"].shape)
              .astype(np.float32), "labels": batch["labels"][::-1].copy()}
    active, frozen = (False,) * 6, (False, True) + (False,) * 4
    jsteps = jax_train_loop.TrainStepCache(
        jmodel, jax_optim.AdamWConfig(lr=1e-3), donate=False)
    jopt = jax_train_loop.make_optimizer_state(
        jmodel, jax_optim.AdamWConfig(lr=1e-3), jparams)
    p1, o1, _ = jsteps.get(JaxLayerFreezePlan(active))(
        jparams, jopt, jax_train_loop.as_jnp(batch))
    p2, _, _ = jsteps.get(JaxLayerFreezePlan(frozen))(
        p1, o1, jax_train_loop.as_jnp(batch2))
    steps = TrainStepCache(model, optim.AdamWConfig(lr=1e-3))
    state = optim.AdamWState(step=torch.tensor(int(o1.step), dtype=torch.int32),
                             m=_port(o1.m, cfg), v=_port(o1.v, cfg))
    start = _port(p1, cfg)
    t2, tstate, _ = steps.get(LayerFreezePlan(frozen))(
        start, state, as_tensor(batch2, CPU))
    assert int(tstate.step) == 2
    _, _, grads = grads_of(model.loss, start, as_tensor(batch2, CPU),
                           LayerFreezePlan(frozen))
    want, before = _port(p2, cfg), start
    for g, a, b, s in zip(tree_leaves(grads["blocks"][0]),
                          tree_leaves(want["blocks"][0]),
                          tree_leaves(t2["blocks"][0]),
                          tree_leaves(before["blocks"][0])):
        assert not g.any()  # the frozen unit's gradient is zero ...
        assert (b - s).abs().max() > 0  # ... and it still moves
        np.testing.assert_allclose((b - s).numpy(), (a - s).numpy(),
                                   rtol=0, atol=1e-6)
    assert max(float((b - s).abs().max()) for b, s in zip(
        tree_leaves(t2["blocks"][0]), tree_leaves(before["blocks"][0]))) \
        > 5e-4  # nearly lr = 1e-3
    # the start is not written: the step is out of place
    for x, y in zip(tree_leaves(start), tree_leaves(_port(p1, cfg))):
        assert torch.equal(x, y)
    assert not any(t.requires_grad for t in tree_leaves(t2))


# ---------------------------------------------------------------------------
# TrainStepCache


def _batch(rng, n, cfg):
    return {"images": rng.standard_normal(
                (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
            "labels": rng.integers(0, cfg.num_classes, n).astype(np.int32)}


def test_train_step_cache_counts_recompiles_as_jax():
    jcfg, cfg = _cfgs()
    jsteps = jax_train_loop.TrainStepCache(jax_build_model(jcfg),
                                           jax_optim.AdamWConfig())
    steps = TrainStepCache(build_model(cfg, device=CPU), optim.AdamWConfig())
    rng = np.random.default_rng(0)
    b8, b4, b8b = _batch(rng, 8, cfg), _batch(rng, 4, cfg), _batch(rng, 8, cfg)
    a, f = (False,) * 6, (True, True) + (False,) * 4
    script = [(a, b8), (a, b8b), (a, b4), (a, None), (f, None), (f, b4),
              (f, b8), (a, b4), (f, b8b), ((True,) * 5 + (False,), b4)]
    counts = []
    for flags, batch in script:
        jsteps.get(JaxLayerFreezePlan(flags),
                   None if batch is None else jax_train_loop.as_jnp(batch))
        steps.get(LayerFreezePlan(flags),
                  None if batch is None else as_tensor(batch, CPU))
        counts.append((jsteps.recompiles, steps.recompiles))
    assert [j for j, _ in counts] == [t for _, t in counts]
    assert counts[-1] == (5, 5)
    assert jax_train_loop.batch_signature(b8) == batch_signature(b8)
    runs = [b8, b8b, b4, b4, b8]
    assert [len(r) for r in same_shape_runs(runs)] == \
        [len(r) for r in jax_train_loop.same_shape_runs(runs)] == [2, 2, 1]


_HLO_INSTR = re.compile(r"\s*(?:ROOT )?%([\w.\-]+) = (\S+) ([\w\-]+)\((.*)$")
_HLO_ELEMENTWISE = frozenset((
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "negate",
    "abs", "compare", "convert", "and", "or", "not", "xor", "clamp",
    "select", "sign", "floor", "ceil", "round-nearest-even",
    "round-nearest-afz", "remainder", "is-finite"))


def _hlo_numel(shape: str) -> int:
    m = re.match(r"\w+\[([\d,]*)\]", shape)
    return math.prod(int(v) for v in m.group(1).split(",") if v) if m else 0


def _xla_recomputed(compiled):
    """The FLOPs XLA's cost analysis counts more than once, and the
    instructions that carry them (ROADMAP C.8).

    XLA's fusion pass copies an elementwise producer into every fusion
    that reads it, and `cost_analysis` counts each copy. An instruction
    is a copy when its opcode, shape, attributes and operands, followed
    through the fusions' parameters to the values they were called
    with, are those of one met before: the same value computed again.
    Walks the compiled module from its entry; counts elementwise ops,
    reductions and reduce-windows as `HloCostAnalysis` does. Returns
    (FLOPs of every copy after the first, [(instruction, op_name)]
    of those copies)."""
    comps, entry, cur = {}, None, None
    for line in compiled.as_text().splitlines():
        head = re.match(r"(ENTRY )?%([\w.\-]+) \(.*\{\s*$", line)
        if head:
            cur = comps[head.group(2)] = []
            entry = head.group(2) if head.group(1) else entry
            continue
        m = _HLO_INSTR.match(line)
        if m and cur is not None:
            name, shape, op, rest = m.groups()
            body = re.sub(r", metadata=\{.*\}", "", rest)
            called = re.search(r"(?:calls|to_apply)=%([\w.\-]+)", rest)
            op_name = re.search(r'op_name="([^"]*)"', rest)
            cur.append(dict(
                name=name, shape=shape.split("{")[0], op=op,
                operands=re.findall(r"%([\w.\-]+)", body.split(")")[0]),
                attrs=re.sub(r"%[\w.\-]+", "", body),
                calls=called and called.group(1),
                op_name=op_name.group(1) if op_name else ""))
    shapes = {i["name"]: i["shape"] for c in comps.values() for i in c}

    def sub_flops(comp):
        return sum(_hlo_numel(i["shape"]) for i in comps[comp]
                   if i["op"] in _HLO_ELEMENTWISE)

    def flops(ins):
        if ins["op"] in _HLO_ELEMENTWISE:
            return _hlo_numel(ins["shape"])
        if ins["op"] == "reduce":
            return (_hlo_numel(shapes[ins["operands"][0]])
                    - _hlo_numel(ins["shape"])) * sub_flops(ins["calls"])
        if ins["op"] == "reduce-window":
            size = re.search(r"window=\{size=([\dx]+)", ins["attrs"]).group(1)
            return ((math.prod(int(v) for v in size.split("x")) - 1)
                    * _hlo_numel(ins["shape"]) * sub_flops(ins["calls"]))
        return 0

    seen, copies = set(), []

    def walk(comp, bound):
        keys = {}
        for ins in comps[comp]:
            if ins["op"] == "parameter":
                index = int(re.match(r"(\d+)", ins["attrs"]).group(1))
                keys[ins["name"]] = bound[index] if bound else ins["name"]
                continue
            args = tuple(keys.get(o, o) for o in ins["operands"])
            if ins["op"] == "fusion":
                keys[ins["name"]] = ins["name"]
                walk(ins["calls"], args)
                continue
            key = keys[ins["name"]] = hash(
                (ins["op"], ins["shape"], ins["attrs"], args))
            f = flops(ins)
            if f and key in seen:
                copies.append((f, ins["name"], ins["op_name"]))
            seen.add(key)

    walk(entry, None)
    return sum(f for f, _, _ in copies), [(n, o) for _, n, o in copies]


def _xla_step_flops(jmodel, opt_cfg, plan, batch):
    """(XLA's count of the reference's whole train step under `plan`,
    what that count holds of recomputation): the step compiled as
    `TrainStepCache.flops` compiles it."""
    from repro.roofline.analysis import cost_analysis_dict

    jsteps = jax_train_loop.TrainStepCache(jmodel, opt_cfg)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    opt_state = jax.eval_shape(lambda p: jax_train_loop.make_optimizer_state(
        jmodel, opt_cfg, p), params)
    compiled = jsteps.get(plan).lower(
        params, opt_state, jax_train_loop.as_jnp(batch)).compile()
    return cost_analysis_dict(compiled)["flops"], \
        _xla_recomputed(compiled)[0]


@contextlib.contextmanager
def xla_less_recomputation():
    """Inside the block the reference's `TrainStepCache.flops` returns
    XLA's count of a plan's whole step less what XLA recomputes (ROADMAP
    C.8), the number the port's count is held to: compiled as the
    reference compiles it, and kept apart from its process-wide cache."""
    from repro.roofline.analysis import cost_analysis_dict

    def flops(self, plan, example_batch):
        if plan not in self._flops:
            params = jax.eval_shape(self.model.init, jax.random.PRNGKey(0))
            opt_state = jax.eval_shape(
                lambda p: jax_train_loop.make_optimizer_state(
                    self.model, self.opt_cfg, p), params)
            compiled = self.get(plan).lower(params, opt_state,
                                            example_batch).compile()
            self._flops[plan] = float(cost_analysis_dict(compiled)["flops"]
                                      - _xla_recomputed(compiled)[0])
        return self._flops[plan]

    with mock.patch.object(jax_train_loop.TrainStepCache, "flops", flops):
        yield


def _flop_plans(n):
    """All active, a frozen prefix of half the units, all but the head."""
    return [(False,) * n, (True,) * (n // 2) + (False,) * (n - n // 2),
            (True,) * (n - 1) + (False,)]


def _flop_ratio_gaps(jcfg, cfg, batch=None, sgd=False):
    """XLA's count of the reference's whole step less its recomputation
    (`_xla_recomputed`), and the port's count of its whole step, under
    the all-active plan, a frozen prefix of half the units and all units
    but the head, at batch 16 (images, unless `batch` is given), under
    AdamW (or SGD-momentum). Returns (the gaps between the two counts'
    ratios to all-active, the counts' relative gaps per plan)."""
    jopt = jax_optim.SGDMConfig() if sgd else jax_optim.AdamWConfig()
    jmodel = jax_build_model(jcfg)
    model = build_model(cfg, device=CPU)
    steps = TrainStepCache(
        model, optim.SGDMConfig() if sgd else optim.AdamWConfig())
    if batch is None:
        batch = _batch(np.random.default_rng(0), 16, cfg)
    plans = _flop_plans(model.num_freeze_units)
    xla = [_xla_step_flops(jmodel, jopt, JaxLayerFreezePlan(p), batch)
           for p in plans]
    ref = [whole - again for whole, again in xla]
    params = model.init(torch.Generator().manual_seed(0))
    before = [t.clone() for t in tree_leaves(params)]
    port = [steps.flops(LayerFreezePlan(p), batch) for p in plans]
    # the count computes nothing: real params are not touched
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(params)))
    assert steps.flops(LayerFreezePlan(plans[0]), batch) == port[0]
    gaps = []
    for x, p in zip(ref[1:], port[1:]):
        rx, rp = x / ref[0], p / port[0]
        gaps.append(abs(rp - rx) / rx)
        assert rp < 1.0
    parts = [abs(p - x) / x for p, x in zip(port, ref)]
    print(f"XLA {[w for w, _ in xla]}, recomputed {[a for _, a in xla]}; "
          f"port {port}; ratio gaps {[f'{g:.2%}' for g in gaps]}; count "
          f"gaps {[f'{g:.2%}' for g in parts]}")
    return gaps, parts


def test_flop_ratios_between_plans_match_xla():
    """The port counts a whole step as XLA's cost analysis counts the
    reference's (`runtime/flops.py`), and XLA's count less the work its
    fusion pass recomputes (ROADMAP C.8) is what the port's step
    computes. Between plans the ratios agree within 7%, and each plan's
    count within 3%."""
    gaps, parts = _flop_ratio_gaps(*_cfgs())
    assert max(gaps) < 0.07
    assert max(parts) < 0.03


@pytest.mark.parametrize("arch", ["mobilenetv2", "resnet50"])
def test_cnn_flop_ratios_between_plans_match_xla(arch):
    """The ratio test above on the reduced CNNs, with its 7% limit. The
    count takes a convolution's taps in its input only, as XLA does
    (torch's own formulas counted the "SAME" padding's too, and the
    deep units' small maps then weighed more than in XLA's count:
    MobileNetV2's gap was 8.65%)."""
    gaps, parts = _flop_ratio_gaps(jax_get_reduced(arch), get_reduced(arch))
    assert max(gaps) < 0.07
    assert max(parts) < 0.03


def test_full_width_flop_ratios_match_xla():
    """The ratio test at full width: DeiT-tiny (12 layers, d = 192),
    batch 16 at 224x224, with the 7% limit. The reference's step is only
    compiled for XLA's count, never run; the port's count runs on `meta`
    tensors."""
    jcfg, cfg = jax_get_config("deit-tiny"), get_config("deit-tiny")
    assert (cfg.num_layers, cfg.d_model, cfg.image_size) == (12, 192, 224)
    gaps, parts = _flop_ratio_gaps(jcfg, cfg)
    assert max(gaps) < 0.07
    assert max(parts) < 0.03


@pytest.mark.parametrize("arch", ["mobilenetv2", "deit-tiny", "bert-base"])
@pytest.mark.parametrize("sgd", [False, True], ids=["adamw", "sgd"])
def test_whole_step_flops_match_xla_per_plan(arch, sgd):
    """Under AdamW and SGD-momentum, on the reduced MobileNetV2, DeiT-tiny
    and bert-base, each plan's whole-step count (loss, gradient and the
    optimizer's update) is within 3% of XLA's count of the reference's
    step less its recomputation, and that recomputation is all that
    parts them: XLA's whole count is the larger by it."""
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    batch = None
    if arch == "bert-base":
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (16, 32)).astype(
                     np.int32),
                 "labels": rng.integers(0, cfg.num_classes, 16).astype(
                     np.int32)}
    gaps, parts = _flop_ratio_gaps(jcfg, cfg, batch, sgd=sgd)
    assert max(parts) < 0.03
    assert max(gaps) < 0.03


@pytest.mark.parametrize("arch", ["mobilenetv2", "deit-tiny"])
def test_flop_count_memo_changes_no_count(arch, monkeypatch):
    """The counter memoizes each functional op and, on a hit, makes its
    outputs without running it (`runtime/flops.py`). Every plan's count,
    matmuls and the rest apart, is the same from an empty memo, from a
    warm one (where the count runs no memoized op anew) and with the
    memo off."""
    from repro_torch.runtime import flops as flops_mod
    from repro_torch.runtime import train_loop as train_loop_mod

    cfg = get_reduced(arch)
    model = build_model(cfg, device=CPU)
    batch = _batch(np.random.default_rng(0), 16, cfg)
    plans = [LayerFreezePlan(p) for p in _flop_plans(model.num_freeze_units)]

    def counts():
        monkeypatch.setattr(train_loop_mod, "_FLOPS", {})
        steps = TrainStepCache(model, optim.AdamWConfig())
        for plan in plans:
            steps.flops(plan, batch)
        return [steps.flop_counts[plan] for plan in plans]

    monkeypatch.setattr(flops_mod, "_MEMO", {})
    cold = counts()
    size = len(flops_mod._MEMO)
    assert size > 0
    warm = counts()
    assert len(flops_mod._MEMO) == size
    monkeypatch.setattr(flops_mod, "_memoizable", lambda func: False)
    off = counts()
    assert cold == warm == off
    assert all(c.matmul and c.elementwise for c in cold)


@pytest.mark.parametrize("size,k,stride", [(2, 3, 1), (5, 3, 2), (16, 3, 2),
                                           (9, 7, 2), (8, 1, 2)])
def test_conv_flops_count_taps_in_bounds_as_xla(size, k, stride):
    """One "SAME" convolution (padded apart by `F.pad`, asymmetric at
    stride 2): the forward count equals XLA's exactly, and the backward
    counts the input's and the kernel's gradients at the same in-bounds
    share (a padded map is recognised in the backward too)."""
    from repro.models.cnn import conv2d as jax_conv2d
    from repro.roofline.analysis import cost_analysis_dict
    from repro_torch.models import cnn
    from repro_torch.runtime.flops import _in_bounds_conv_formulas

    x, w = jnp.ones((2, size, size, 4)), jnp.ones((k, k, 4, 6))
    xla = cost_analysis_dict(jax.jit(
        lambda x, w: jax_conv2d(x, w, stride)).lower(x, w).compile())["flops"]
    tx = torch.empty(2, 4, size, size, device="meta", requires_grad=True)
    tw = torch.empty(k, k, 4, 6, device="meta", requires_grad=True)
    counts = []
    for backward in (False, True):
        counter = FlopCounterMode(display=False,
                                  custom_mapping=_in_bounds_conv_formulas())
        with counter:
            y = cnn.conv2d(tx, tw, stride)
            if backward:
                torch.autograd.grad(y.sum(), (tx, tw))
        counts.append(counter.get_total_flops())
    assert counts[0] == xla
    assert counts[1] == 3 * counts[0]
    if k > 1:  # padding taps present: fewer than torch's
        plain = FlopCounterMode(display=False)
        with plain:
            cnn.conv2d(tx, tw, stride)
        assert plain.get_total_flops() > counts[0]


# ---------------------------------------------------------------------------
# controller modules on scripted inputs


def _state(obj):
    return {k: (list(v) if isinstance(v, list) else v)
            for k, v in vars(obj).items() if k != "curve"}


def test_curvefit_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 6):
        iters = np.cumsum(rng.integers(1, 8, n)).astype(float)
        accs = np.sort(rng.uniform(0.1, 0.9, n))
        a = jax_curvefit.fit_accuracy_curve(iters, accs)
        b = curvefit.fit_accuracy_curve(iters, accs)
        if n < 2:
            assert a is None and b is None
            continue
        assert (a.c0, a.c1, a.c2) == (b.c0, b.c1, b.c2)
        k = np.linspace(0, 50, 11)
        np.testing.assert_array_equal(a.predict(k), b.predict(k))
        for gain in (1e-4, 0.01, 0.2, 5.0):
            assert a.iters_for_gain(iters[-1], gain) == \
                b.iters_for_gain(iters[-1], gain)
        assert a.gain(1, 9) == b.gain(1, 9)


def test_lazytune_matches_jax():
    cfg_kw = dict(max_batches_needed=6)
    a = jax_lazytune.LazyTune(jax_lazytune.LazyTuneConfig(**cfg_kw))
    b = lazytune.LazyTune(lazytune.LazyTuneConfig(**cfg_kw))
    rng = np.random.default_rng(1)
    for i in range(40):
        op = rng.integers(4)
        if op == 0:
            n = int(rng.integers(0, 8))
            assert a.should_trigger(n) == b.should_trigger(n)
        elif op == 1:
            it, acc = int(rng.integers(1, 6)), float(rng.uniform(0, 1))
            a.round_finished(it, acc)
            b.round_finished(it, acc)
        elif op == 2:
            a.inference_arrived()
            b.inference_arrived()
        elif i % 9 == 0:
            a.scenario_changed()
            b.scenario_changed()
        assert _state(a.state) == _state(b.state)


def _logit_stream(seed, n=60, shift_at=30):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((4, 10)) - (0.0 if i < shift_at else 3.0)
            for i in range(n)]


def test_energy_ood_detector_matches_jax():
    kw = dict(window=2, warmup=8, cooldown=4)
    a = jax_ood.EnergyOODDetector(jax_ood.EnergyOODConfig(**kw))
    b = ood.EnergyOODDetector(ood.EnergyOODConfig(**kw))
    assert a.confirm(np.ones((2, 3))) == b.confirm(np.ones((2, 3))) is True
    flags = []
    for lg in _logit_stream(2):
        flags.append(a.observe(lg))
        assert b.observe(lg) == flags[-1]
        assert a.confirm(lg) == b.confirm(lg)
    assert any(flags) and a.detections == b.detections > 0
    assert ood.EnergyOODDetector.energy(lg) == \
        jax_ood.EnergyOODDetector.energy(lg)


TRIGGERS = {
    "immediate": lambda m: m.ImmediateTrigger(2.0),
    "lazytune": lambda m: m.LazyTuneTrigger(),
    "staleness": lambda m: m.StalenessGuard(m.LazyTuneTrigger(), 5.0),
    "priority": lambda m: m.PriorityWeightedTrigger(priority_weight=0.5),
}


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_trigger_policies_match_jax(name):
    a, b = TRIGGERS[name](jax_policies), TRIGGERS[name](policies)
    assert isinstance(b, policies.TriggerPolicy)
    rng = np.random.default_rng(3)
    for i in range(50):
        op = rng.integers(4)
        if op == 0:
            kw = dict(staleness=float(rng.uniform(0, 8)),
                      priority=int(rng.integers(0, 3)))
            n = int(rng.integers(0, 6))
            assert a.should_trigger(n, **kw) == b.should_trigger(n, **kw)
        elif op == 1:
            it, acc = int(rng.integers(1, 5)), float(rng.uniform(0.2, 0.9))
            a.round_finished(it, acc)
            b.round_finished(it, acc)
        elif op == 2:
            a.inference_arrived()
            b.inference_arrived()
        elif i % 7 == 0:
            a.scenario_changed()
            b.scenario_changed()
        assert a.stats() == b.stats()
    with pytest.raises(ValueError):
        policies.StalenessGuard(policies.ImmediateTrigger(), 0.0)
    with pytest.raises(ValueError):
        policies.PriorityWeightedTrigger(priority_weight=-1.0)


def test_drift_and_publish_policies_match_jax():
    for a, b in ((jax_policies.NoDriftPolicy(), policies.NoDriftPolicy()),
                 (jax_policies.EnergyDriftPolicy(),
                  policies.EnergyDriftPolicy())):
        for lg in _logit_stream(4, n=50, shift_at=25):
            assert a.observe(lg) == b.observe(lg)
            assert a.confirm(lg) == b.confirm(lg)
        assert a.stats() == b.stats()
        assert isinstance(b, policies.DriftPolicy)
    for a, b in ((jax_policies.ImmediatePublish(), policies.ImmediatePublish()),
                 (jax_policies.RoundEndPublish(), policies.RoundEndPublish())):
        assert (a.delayed, a.visible_at(2.5)) == (b.delayed, b.visible_at(2.5))
        assert isinstance(b, policies.PublishPolicy)


# scripted params for the freeze-side tests: block b of the reduced
# DeiT-tiny moves along a fixed numpy direction by mult(b, k) at step k:
# block 0 never moves, block 1 only from step 4 on, the rest throughout
def _mult(b, k):
    return 0.0 if b == 0 else (0.0 if k < 4 else k - 3.0) if b == 1 \
        else float(np.sqrt(k))


@pytest.fixture(scope="module")
def scripted():
    jcfg, cfg = _cfgs()
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    p0 = _host(jmodel.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(11)
    delta = [jax.tree.map(lambda a: 0.5 * max(float(a.std()), 0.02)
                          * rng.standard_normal(a.shape).astype(np.float32),
                          blk) for blk in p0["blocks"]]

    def at(k):
        blocks = [jax.tree.map(lambda p, d, m=_mult(b, k): p + m * d, blk, d)
                  for b, (blk, d) in enumerate(zip(p0["blocks"], delta))]
        return {**p0, "blocks": blocks}

    host = [at(k) for k in range(9)]
    bench = jax_nc_benchmark(num_classes=10, num_scenarios=3, batches=2,
                             batch_size=8, image_size=cfg.image_size, seed=0)
    probes = [sc.train_batches[0] for sc in bench.scenarios]
    return {"jmodel": jmodel, "model": model,
            "jax": [jax.tree.map(jnp.asarray, h) for h in host],
            "port": [params_from_jax(h, cfg, device=CPU) for h in host],
            "jprobes": [jax_train_loop.as_jnp(b) for b in probes],
            "probes": [as_tensor(b, CPU) for b in probes],
            "logits": _logit_stream(5, n=27, shift_at=100)}


def _drive_freeze(policy, params, probes):
    """A scripted scenario: reference, six rounds, a boundary, two more."""
    plans = [policy.plan]
    policy.start_scenario(params[0], probes[1])
    for k in range(1, 7):
        policy.round_finished(1, params[k])
        plans.append(policy.plan)
    policy.scenario_changed(params[7], probes[2])
    plans.append(policy.plan)
    policy.start_scenario(params[0], probes[2])
    policy.round_finished(1, params[8])
    plans.append(policy.plan)
    return [getattr(p, "layers", p) for p in plans], policy.stats()


@pytest.mark.parametrize("kind", ["none", "simfreeze"])
def test_freeze_policies_match_jax(scripted, kind):
    kw = dict(freeze_interval=1, min_history=2, cka_threshold=0.05)
    if kind == "none":
        a = jax_policies.NoFreezePolicy(scripted["jmodel"])
        b = policies.NoFreezePolicy(scripted["model"])
    else:
        a = jax_policies.SimFreezePolicy(
            scripted["jmodel"], JaxSimFreezeConfig(use_kernel=True, **kw))
        b = policies.SimFreezePolicy(scripted["model"],
                                     SimFreezeConfig(**kw))
    assert isinstance(b, policies.FreezePolicy)
    got_a = _drive_freeze(a, scripted["jax"], scripted["jprobes"])
    got_b = _drive_freeze(b, scripted["port"], scripted["probes"])
    assert got_a[0] == got_b[0]
    assert got_a[1] == got_b[1]
    if kind == "simfreeze":
        assert got_b[1]["freezes"] > 0 and got_b[1]["unfreezes"] > 0
        assert b.plan_changes == a.plan_changes >= 2
    assert policies.empty_plan(scripted["model"]) == \
        LayerFreezePlan((False,) * 6)


def _drive_controller(ctrl, params, probes, logits):
    """The controller's whole surface, in an event order the runtime
    produces: triggers, served requests, rounds and a boundary."""
    out = []
    ctrl.start_scenario(params[0], probes[1])
    it = iter(logits)
    for k in range(1, 9):
        for _ in range(3):
            out.append(ctrl.inference_served(next(it)))
        out.append(ctrl.should_trigger(k % 4, staleness=0.5 * k,
                                       priority=k % 2))
        if k == 5:
            ctrl.scenario_changed(params[k], probes[2])
            ctrl.start_scenario(params[0], probes[2])
        ctrl.round_finished(2, 0.1 * k - 0.01 * k * k, params[k])
        out.append(getattr(ctrl.plan, "layers", ctrl.plan))
    out.append(ctrl.probe_served(logits[0]))
    return out, ctrl.stats()


CONTROLLERS = {
    "etuner": {},
    "immediate": {"lazytune": False, "simfreeze": False},
    "lazytune-only": {"simfreeze": False},
    "simfreeze-only": {"lazytune": False},
    "staleness": {"max_staleness": 2.0, "detect_scenario_changes": False},
}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_etuner_controller_matches_jax(scripted, name):
    def config(api):
        return api.ETunerConfig(
            lazytune_cfg=api.LazyTuneConfig(max_batches_needed=6),
            simfreeze_cfg=api.SimFreezeConfig(freeze_interval=2,
                                              min_history=2,
                                              cka_threshold=0.05),
            **CONTROLLERS[name])

    a = jax_controller.ETunerController(scripted["jmodel"], config(_JaxApi))
    b = ETunerController(scripted["model"], config(_PortApi))
    got_a = _drive_controller(a, scripted["jax"], scripted["jprobes"],
                              scripted["logits"])
    got_b = _drive_controller(b, scripted["port"], scripted["probes"],
                              scripted["logits"])
    assert got_a == got_b
    assert adapt_controller(b) is b


def test_policy_stack_defaults_and_legacy_adapter_match_jax(scripted):
    a = jax_policies.PolicyStack(scripted["jmodel"])
    b = policies.PolicyStack(scripted["model"])
    assert a.stats() == b.stats()
    assert a.plan.layers == b.plan.layers and a.plan_changes == b.plan_changes
    with pytest.raises(ValueError):
        policies.PolicyStack()

    class OneArg:
        def should_trigger(self, n):
            return n >= 2

    class TwoArg:
        seen = None

        def should_trigger(self, n, staleness=0.0):
            TwoArg.seen = staleness
            return n >= 1

        def stats(self):
            return {"legacy": 1}

    for cls in (OneArg, TwoArg):
        wa = jax_policies.adapt_controller(cls())
        wb = policies.adapt_controller(cls())
        assert type(wb).__name__ == type(wa).__name__ == \
            "LegacyControllerAdapter"
        for n in range(4):
            assert wa.should_trigger(n, staleness=1.5, priority=2) == \
                wb.should_trigger(n, staleness=1.5, priority=2)
    assert TwoArg.seen == 1.5 and wb.stats() == {"legacy": 1}


# ---------------------------------------------------------------------------
# FineTuneExecutor


def _executors(replay=True):
    """A JAX and a port executor over the same model, params and batches."""
    jcfg, cfg = _cfgs()
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    bench = jax_nc_benchmark(num_classes=10, num_scenarios=2, batches=4,
                             batch_size=8, image_size=cfg.image_size, seed=0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    out = {}
    for side, steps_cls, opt, ex_cls, ledger_cls, cost_cls, rb, params in (
            ("jax", jax_train_loop.TrainStepCache, jax_optim,
             jax_executor.FineTuneExecutor, JaxCostLedger, JaxEdgeCostModel,
             jax_executor.ReplayBuffer, jparams),
            ("port", TrainStepCache, optim, FineTuneExecutor, CostLedger,
             EdgeCostModel, ReplayBuffer, _port(jparams, cfg))):
        m = jmodel if side == "jax" else model
        cfg_opt = opt.AdamWConfig(lr=1e-3)
        steps = steps_cls(m, cfg_opt)
        ledger = ledger_cls()
        ex = ex_cls(steps, cost_cls(), ledger,
                    rb(bench.scenarios[0].train_batches[:2] if replay
                       else ()), rng=np.random.default_rng(0))
        make = jax_train_loop.make_optimizer_state if side == "jax" \
            else make_optimizer_state
        ex.load(params, make(m, cfg_opt, params))
        out[side] = (ex, ledger)
    return out, bench


def _report(r):
    return dataclasses.asdict(r)


def test_executor_rounds_and_charges_match_jax():
    exs, bench = _executors()
    sched = {"jax": JaxEventScheduler(), "port": EventScheduler()}
    plans = {"jax": JaxLayerFreezePlan, "port": LayerFreezePlan}
    batches = bench.scenarios[1].train_batches
    reports = {"jax": [], "port": []}
    estimates = {"jax": [], "port": []}
    script = [((False,) * 6, batches[:2], 1.0),
              ((False,) * 6, batches[2:3], 1.5),
              ((True, True) + (False,) * 4, batches[1:4], 9.0)]
    for side in ("jax", "port"):
        ex, ledger = exs[side]
        assert ex.execute_round(plans[side](script[0][0]), 0.0,
                                sched[side]) is None  # nothing buffered
        for flags, bs, now in script:
            for b in bs:
                ex.enqueue(b)
            assert ex.pending == len(bs) and ex.pending_streams == [0]
            estimates[side].append(ex.estimate_round(plans[side](flags)))
            reports[side].append(_report(ex.execute_round(
                plans[side](flags), now, sched[side])))
        assert ex.pending == 0
    (jex, jledger), (ex, ledger) = exs["jax"], exs["port"]
    for a, b in zip(reports["jax"], reports["port"]):
        assert {k: v for k, v in a.items() if k not in
                ("flops", "time_s", "energy_j", "end")} == \
            {k: v for k, v in b.items() if k not in
             ("flops", "time_s", "energy_j", "end")}
    # the first round calibrates the cost model on its own plan: its time
    # and energy agree whatever the FLOP counter; the frozen plan's round
    # differs by the FLOP-ratio gap (test_flop_ratios_between_plans_...)
    for a, b in zip(reports["jax"][:2], reports["port"][:2]):
        for k in ("time_s", "energy_j", "end"):
            assert b[k] == pytest.approx(a[k], rel=1e-12)
    for k in ("time_s", "energy_j"):
        assert reports["port"][2][k] == pytest.approx(
            reports["jax"][2][k], rel=0.03)
    assert [e[0] for e in estimates["port"][:2]] == pytest.approx(
        [e[0] for e in estimates["jax"][:2]], rel=1e-12)
    assert ledger.rounds == jledger.rounds == 3
    assert ledger.breakdown["t_overhead"] == jledger.breakdown["t_overhead"]
    assert ledger.per_stream.keys() == jledger.per_stream.keys()
    assert ex.compiled_plans == {LayerFreezePlan(f) for f, _, _ in script}
    # the trained params serve as JAX's do
    val = bench.scenarios[1].val
    want, _ = jax_train_loop.evaluate(jex.steps.model, jex.params,
                                      jax_train_loop.as_jnp(val))
    got, logits = evaluate(ex.steps.model, ex.params, as_tensor(val, CPU))
    _, jlogits = jax_train_loop.evaluate(jex.steps.model, jex.params,
                                         jax_train_loop.as_jnp(val))
    assert got == want
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cuts", [(), (0.3,), (0.1, 0.45, 0.8)])
def test_preemptible_segments_sum_to_the_unpreempted_charge(cuts):
    exs, bench = _executors()
    exs2, _ = _executors()
    batches = bench.scenarios[1].train_batches[:3]
    plan = LayerFreezePlan((False,) * 6)
    whole_ex, whole_ledger = exs["port"]
    split_ex, split_ledger = exs2["port"]
    jex, jledger = exs2["jax"]
    for ex in (whole_ex, split_ex, jex):
        for b in batches:
            ex.enqueue(b)
    whole = whole_ex.execute_round(plan, 2.0, EventScheduler())
    sched, jsched = EventScheduler(), JaxEventScheduler()
    jplan = JaxLayerFreezePlan(plan.layers)
    assert split_ex.execute_round(plan, 2.0, sched, priority=0,
                                  preemptible=True) is None
    jex.execute_round(jplan, 2.0, jsched, priority=0, preemptible=True)
    ar = split_ex.active_round
    for f in cuts:
        t = ar.first_start + f * ar.time_s
        assert sched.can_preempt(t, 1) and jsched.can_preempt(t, 1)
        split_ex.preempt(t, sched, preempting_stream=1)
        jex.preempt(t, jsched, preempting_stream=1)
        assert ar.trained == jex.active_round.trained
    assert split_ex.finalize_round(ar.end - 1e-9) is None
    rep = split_ex.finalize_round(ar.end)
    jrep = jex.finalize_round(jex.active_round.end)
    assert split_ex.active_round is None
    assert (rep.segments, rep.preemptions) == (len(cuts) + 1, len(cuts)) \
        == (jrep.segments, jrep.preemptions)
    assert (rep.start, rep.end, rep.time_s) == pytest.approx(
        (jrep.start, jrep.end, jrep.time_s), rel=1e-12)
    assert (rep.start, rep.end, rep.iters) == (whole.start, whole.end,
                                               whole.iters)
    assert split_ledger.rounds == whole_ledger.rounds == 1
    assert split_ledger.total_time_s == pytest.approx(
        whole_ledger.total_time_s, rel=1e-12, abs=0)
    assert split_ledger.total_energy_j == pytest.approx(
        whole_ledger.total_energy_j, rel=1e-12, abs=0)
    assert split_ledger.total_flops == pytest.approx(
        whole_ledger.total_flops, rel=1e-12, abs=0)
    for k, v in whole_ledger.breakdown.items():
        assert split_ledger.breakdown[k] == pytest.approx(v, rel=1e-12,
                                                          abs=1e-15)
    assert split_ledger.preemptions == len(cuts)
    # lazily trained batches give the same params as the whole round
    for x, y in zip(tree_leaves(split_ex.params), tree_leaves(whole_ex.params)):
        assert torch.equal(x, y)


def test_preempt_resume_cost_is_charged_to_the_preempting_stream():
    exs, bench = _executors()
    ex, ledger = exs["port"]
    jex, jledger = exs["jax"]
    for e in (ex, jex):
        e.preempt_resume_cost_s = 0.2
        for b in bench.scenarios[1].train_batches[:2]:
            e.enqueue(b, stream=3)
    sched, jsched = EventScheduler(), JaxEventScheduler()
    plan = LayerFreezePlan((False,) * 6)
    ex.execute_round(plan, 0.0, sched, stream=3, preemptible=True)
    jex.execute_round(JaxLayerFreezePlan(plan.layers), 0.0, jsched,
                      stream=3, preemptible=True)
    end = ex.active_round.end
    ex.preempt(0.5, sched, preempting_stream=7)
    jex.preempt(0.5, jsched, preempting_stream=7)
    assert ex.active_round.end == pytest.approx(end + 0.2, rel=1e-12)
    assert ex.finalize_round() is not None and jex.finalize_round()
    assert ledger.breakdown["t_resume"] == jledger.breakdown["t_resume"] == 0.2
    assert ledger.per_stream[7]["time_s"] == jledger.per_stream[7]["time_s"]
    assert ledger.per_stream[3]["time_s"] == pytest.approx(
        jledger.per_stream[3]["time_s"], rel=1e-12)


class _ClaimEveryOther:
    """A round hook that claims every other batch (returning the params
    unchanged, so the supervised step is skipped for it)."""

    def __init__(self):
        self.rounds, self.seen = [], 0

    def on_round_start(self, round_index):
        self.rounds.append(round_index)

    def bind(self, model):
        return model

    def process_batch(self, params, batch, device_batch):
        self.seen += 1
        return params if self.seen % 2 else None


def test_round_hooks_claim_batches_as_in_jax():
    exs, bench = _executors(replay=False)
    batches = bench.scenarios[1].train_batches
    out = {}
    for side, plan in (("jax", JaxLayerFreezePlan), ("port", LayerFreezePlan)):
        ex, ledger = exs[side]
        hook = _ClaimEveryOther()
        ex.hooks = [hook]
        sched = JaxEventScheduler() if side == "jax" else EventScheduler()
        for n in (1, 2):
            for b in batches[:n]:
                ex.enqueue(b)
            ex.execute_round(plan((False,) * 6), float(n), sched)
        out[side] = (hook.rounds, hook.seen, int(ex.opt_state.step),
                     ledger.rounds)
    # two rounds, three batches: the first and third are claimed, one
    # supervised step runs
    assert out["jax"] == out["port"] == ([0, 1], 3, 1, 2)
    base = RoundHook()
    assert base.bind("m") == "m" and base.process_batch(None, {}, {}) is None


def test_replay_buffer_matches_jax():
    a = jax_executor.ReplayBuffer([{"i": 0}], capacity=3)
    b = ReplayBuffer([{"i": 0}], capacity=3)
    for i in range(1, 5):
        a.add({"i": i})
        b.add({"i": i})
    assert len(a) == len(b) == 3
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    assert [a.sample(ra) for _ in range(8)] == [b.sample(rb) for _ in range(8)]


# ---------------------------------------------------------------------------
# the loop, against a live ContinualRuntime.run


@pytest.fixture(scope="module", params=[6, 3], ids=["interval6",
                                                     "interval3"])
def loops(request):
    return request.param, run_reference(request.param), \
        run_port(request.param)


def test_loop_matches_continual_runtime(loops):
    interval, ref, port = loops
    for k in ("rounds", "recompiles", "controller_stats", "round_plans"):
        assert port[k] == ref[k], k
    # the reference's scratch runs: (rounds, recompiles, freezes)
    assert (ref["rounds"], ref["recompiles"],
            ref["controller_stats"]["freezes"]) == \
        {6: (9, 1, 2), 3: (9, 2, 3)}[interval]
    np.testing.assert_allclose(port["inference_accs"], ref["inference_accs"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["val_curve"], ref["val_curve"], rtol=0,
                               atol=1e-5)
    assert len(port["inference_accs"]) == LOOP_INFERENCES


def test_loop_cost_totals_within_the_flop_gap(loops):
    """The ledger's totals depend on the FLOP counter through the frozen
    plans' rounds and the CKA probes (both are priced at the throughput
    calibrated on the first round's plan): within 3% of the reference."""
    interval, ref, port = loops
    for k in ("total_time_s", "total_energy_j"):
        gap = abs(port[k] - ref[k]) / ref[k]
        print(f"interval {interval}: {k} port {port[k]:.6f} reference "
              f"{ref[k]:.6f}, gap {gap:.3%}")
        assert gap < 0.03, k
    assert port["breakdown"]["t_overhead"] == pytest.approx(
        ref["breakdown"]["t_overhead"], rel=1e-12)
    assert set(port["breakdown"]) == set(ref["breakdown"])
