"""The port's composition root against the JAX package's on the CPU:
`ContinualRuntime.from_config(...).run()` in both packages in one process,
at the reduced DeiT-tiny with the ETuner policy stack (LazyTune,
SimFreeze, energy-score detection), on the same numpy benchmark and
timeline; `RuntimeConfig`'s dict form across the two packages; the
`ModelPool` on the same acquire sequence; and what the port cannot run
yet, each raising `NotImplementedError` with its ROADMAP label.

The port's model is injected with an `init` that returns the JAX
package's `init(PRNGKey(seed))` carried across by `bridge.params_from_jax`
(a test-side wrapper, so both pretrain from the same params). With
`use_pallas`, the JAX side runs its Pallas kernels in interpret mode and
the port the plain versions its kernel wrappers take on the CPU.
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import env as jax_env
from repro.configs import get_reduced as jax_get_reduced
from repro.core import policies as jax_policies
from repro.core.policies import throttle as jax_throttle
from repro.data.arrivals import build_timeline as jax_build_timeline
from repro.data.streams import nc_benchmark as jax_nc_benchmark
from repro.env import EnvSpec as JaxEnvSpec
from repro.models import build_model as jax_build_model
from repro.obs.spec import TelemetrySpec as JaxTelemetrySpec
from repro.optim import optimizer as jax_optim
from repro.runtime import config as jax_config
from repro.runtime import continual as jax_continual
from repro.runtime import executor as jax_executor
from repro.runtime import modelpool as jax_modelpool
from repro.runtime.costmodel import EdgeCostModel as JaxEdgeCostModel
from repro_torch import env, tree_leaves
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.core import policies
from repro_torch.core.policies import throttle
from repro_torch.data.arrivals import build_timeline
from repro_torch.data.streams import nc_benchmark
from repro_torch.models import build_model
from repro_torch.obs.spec import TelemetrySpec
from repro_torch.optim import optimizer as optim
from repro_torch.runtime import config, continual, executor, modelpool
from repro_torch.runtime.costmodel import EdgeCostModel
from repro_torch.runtime.device import clone_device_slots

CPU = "cpu"
BENCH = dict(num_classes=10, num_scenarios=3, batches=6, batch_size=8,
             seed=0)
INFERENCES = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Jax:
    RuntimeConfig = jax_config.RuntimeConfig
    SlotConfig = jax_config.SlotConfig
    DeviceConfig = jax_config.DeviceConfig
    HookSpec = jax_config.HookSpec
    PolicySpec = jax_policies.PolicySpec
    EnvSpec = JaxEnvSpec
    TelemetrySpec = JaxTelemetrySpec
    etuner_stack_spec = staticmethod(jax_policies.etuner_stack_spec)
    ContinualRuntime = jax_continual.ContinualRuntime
    FineTuneExecutor = jax_executor.FineTuneExecutor


class _Port:
    RuntimeConfig = config.RuntimeConfig
    SlotConfig = config.SlotConfig
    DeviceConfig = config.DeviceConfig
    HookSpec = config.HookSpec
    PolicySpec = policies.PolicySpec
    EnvSpec = env.EnvSpec
    TelemetrySpec = TelemetrySpec
    etuner_stack_spec = staticmethod(policies.etuner_stack_spec)
    ContinualRuntime = continual.ContinualRuntime
    FineTuneExecutor = executor.FineTuneExecutor


def _session(api, *, use_pallas=False, drift=None, **kw):
    """The ETuner session of PR 15's loop (LazyTune max_batches_needed 6,
    SimFreeze every 3 iterations from 2 CKA points at threshold 0.01,
    energy-score detection), one pretraining epoch. `drift` sets the
    energy-score detector's parameters."""
    spec = api.etuner_stack_spec(
        lazytune_params={"max_batches_needed": 6},
        simfreeze_params={"freeze_interval": 3, "min_history": 2,
                          "cka_threshold": 0.01})
    if drift is not None:
        spec = dataclasses.replace(spec,
                                   drift=api.PolicySpec("energy", drift))
    return api.RuntimeConfig(
        slots={"default": api.SlotConfig(arch="deit-tiny", policies=spec)},
        seed=0, pretrain_epochs=1, use_pallas=use_pallas, **kw)


def _events(make_timeline, qos):
    """The benchmark's timeline; with `qos`, its requests come from a
    second stream of priority 1, whose arrivals split the rounds that
    stream 0's data launched."""
    events = [dataclasses.replace(e, scenario=e.scenario + 1)
              for e in make_timeline(num_scenarios=BENCH["num_scenarios"] - 1,
                                     batches_per_scenario=BENCH["batches"],
                                     inferences_total=INFERENCES, seed=0)]
    if qos:
        events = [dataclasses.replace(e, stream=1, priority=1)
                  if e.kind == "inference" else e for e in events]
    return events


class _PlanSpy:
    """Records the freeze plan of every round an executor class launches
    (the runtime reports only counts)."""

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


def _result(rt, r, plans):
    return {"rounds": r.rounds, "recompiles": r.recompiles,
            "probes": r.probes, "preemptions": r.preemptions,
            "controller_stats": r.controller_stats, "round_plans": plans,
            "inference_accs": r.inference_accs, "val_curve": r.val_curve,
            "total_time_s": r.total_time_s,
            "total_energy_j": r.total_energy_j,
            "per_stream": r.per_stream, "per_model": r.per_model,
            "per_device": r.per_device, "runtime": rt}


def run_reference(qos=False, use_pallas=False, **kw):
    bench = jax_nc_benchmark(
        image_size=jax_get_reduced("deit-tiny").image_size, **BENCH)
    rt = _Jax.ContinualRuntime.from_config(
        _session(_Jax, use_pallas=use_pallas, **kw), benchmark=bench)
    with _PlanSpy(_Jax.FineTuneExecutor) as spy:
        r = rt.run(events=_events(jax_build_timeline, qos))
    return _result(rt, r, spy.plans)


def bridged_model(use_pallas, seed=0):
    """The port's reduced DeiT-tiny on the CPU, whose `init` returns the
    JAX package's `init(PRNGKey(seed))` in the port's layout."""
    jcfg = jax_get_reduced("deit-tiny").replace(use_pallas=use_pallas)
    cfg = get_reduced("deit-tiny").replace(use_pallas=use_pallas)
    params = params_from_jax(
        jax.tree.map(np.asarray,
                     jax_build_model(jcfg).init(jax.random.PRNGKey(seed))),
        cfg, device=CPU)
    model = build_model(cfg, device=CPU)
    return dataclasses.replace(model, init=lambda generator: params)


def run_port(qos=False, use_pallas=False, **kw):
    bench = nc_benchmark(image_size=get_reduced("deit-tiny").image_size,
                         **BENCH)
    rt = _Port.ContinualRuntime.from_config(
        _session(_Port, use_pallas=use_pallas, **kw), device=CPU,
        model=bridged_model(use_pallas), benchmark=bench)
    with _PlanSpy(_Port.FineTuneExecutor) as spy:
        r = rt.run(events=_events(build_timeline, qos))
    return _result(rt, r, spy.plans)


DETECT = {"warmup": 4, "window": 4, "z_threshold": 1.5, "cooldown": 4}

# the reference's runs on the CPU: (rounds, recompiles, probes,
# preemptions); each case must drive the path it is named for
CASES = {
    "oracle": (dict(), (9, 2, 0, 0)),
    # a detector that wakes within 16 requests, so probes fire
    "detector": (dict(boundaries="detector", drift=DETECT), (9, 2, 1, 0)),
    "preemptible": (dict(qos=True, preemptible=True,
                         preempt_resume_cost_s=0.5), (9, 2, 0, 2)),
    "use_pallas": (dict(use_pallas=True), (9, 2, 0, 0)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    kw, counts = CASES[name]
    return name, counts, run_reference(**kw), run_port(**kw)


@pytest.fixture(params=sorted(CASES))
def runs(request):
    return _case(request.param)


def test_session_matches_reference(runs):
    name, counts, ref, port = runs
    for k in ("rounds", "recompiles", "probes", "preemptions",
              "controller_stats", "round_plans"):
        assert port[k] == ref[k], k
    assert (ref["rounds"], ref["recompiles"], ref["probes"],
            ref["preemptions"]) == counts
    for k in ("per_stream", "per_model", "per_device"):
        assert port[k].keys() == ref[k].keys(), k
        for cell in port[k]:
            assert port[k][cell].keys() == ref[k][cell].keys(), (k, cell)
    np.testing.assert_allclose(port["inference_accs"], ref["inference_accs"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["val_curve"], ref["val_curve"], rtol=0,
                               atol=1e-5)
    assert len(port["inference_accs"]) == INFERENCES


def test_session_cost_totals_within_the_flop_gap(runs):
    """The ledger's totals differ through the FLOP counters (ROADMAP C.5):
    within 3% of the reference."""
    name, _, ref, port = runs
    for k in ("total_time_s", "total_energy_j"):
        gap = abs(port[k] - ref[k]) / ref[k]
        print(f"{name}: {k} port {port[k]:.6f} reference {ref[k]:.6f}, "
              f"gap {gap:.3%}")
        assert gap < 0.03, k


def test_clone_device_slots_copy_device_zero():
    """A clone device (the fleet's devices 1..N-1, built once N > 1 is
    ported) starts from a copy of device 0's params and optimizer state
    and draws from its own generator."""
    port = _case("oracle")[3]
    fleet = port["runtime"].fleet
    src = fleet.devices[0].slots
    slots, rng = clone_device_slots(fleet, config.DeviceConfig("dev1"), 1,
                                    src, fleet.ledger)
    ex, ex0 = slots["default"].executor, src["default"].executor
    assert ex.rng is rng and ex.device_name == "dev1"
    assert rng.integers(1 << 30) == \
        np.random.default_rng([0, 104729, 1]).integers(1 << 30)
    assert type(ex.opt_state) is type(ex0.opt_state)
    for a, b in zip(tree_leaves((ex.params, ex.opt_state)),
                    tree_leaves((ex0.params, ex0.opt_state)), strict=True):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


# ---------------------------------------------------------------------------
# RuntimeConfig's dict form across the packages


def _full_config(api):
    """A config that sets every section of the dict form."""
    return api.RuntimeConfig(
        slots={"cv": api.SlotConfig(
                   arch="deit-tiny", benchmark="nc",
                   benchmark_kw={"num_classes": 10},
                   policies=api.etuner_stack_spec(
                       lazytune_params={"max_batches_needed": 6},
                       simfreeze_params={"freeze_interval": 3},
                       max_staleness=30.0, publish="round-end"),
                   hooks=(api.HookSpec("fake-quant", {"bits": 8}),),
                   memory_mb=12.5),
               "nlp": api.SlotConfig(
                   arch="bert-base", benchmark="20news",
                   policies=dataclasses.replace(
                       api.etuner_stack_spec(lazytune=False),
                       throttle=api.PolicySpec("battery",
                                               {"min_soc": 0.2})))},
        workload="mixed", workload_scale={"inferences": 8},
        seed=3, boundaries="detector", replay_batches=1, pretrain_epochs=2,
        inference_batch=8, calibrate_cost=False, inference_window=2.0,
        preemptible=True, preempt_resume_cost_s=0.25, memory_budget_mb=64.0,
        compiled=True, use_pallas=True,
        devices=(api.DeviceConfig("dev0"),
                 api.DeviceConfig("dev1", speed_scale=0.5, energy_scale=2.0,
                                  memory_budget_mb=32.0,
                                  env=api.EnvSpec(battery_capacity_j=500.0,
                                                  thermal_cap_c=70.0))),
        routing="least-loaded", aggregate_every=10.0,
        telemetry=api.TelemetrySpec(enabled=True, dispatch_events=False))


@pytest.mark.parametrize("make", ["default", "session", "full"])
@pytest.mark.parametrize("src,dst", [(_Jax, _Port), (_Port, _Jax)],
                         ids=["jax_to_port", "port_to_jax"])
def test_config_dicts_load_across_packages(make, src, dst):
    cfg = {"default": lambda api: api.RuntimeConfig(),
           "session": _session, "full": _full_config}[make](src)
    d = cfg.to_dict()
    back = dst.RuntimeConfig.from_dict(d)
    assert back.to_dict() == d
    assert back == {"default": lambda api: api.RuntimeConfig(),
                    "session": _session, "full": _full_config}[make](dst)
    assert src.RuntimeConfig.from_dict(back.to_dict()) == cfg


def test_config_validation_errors_match_reference():
    for bad in ({"slots": {}}, {"boundaries": "psychic"},
                {"routing": "random"}, {"nope": 1},
                {"slots": {"a": {"arch": "deit-tiny", "hooks": [
                    {"name": "fake-quant"}]}}},
                {"slots": {"a": {"policies": {"trigger": {"name": "x"}}}}},
                {"devices": [{"name": "d", "env": {"thermal_cap_c": -1}}]},
                {"telemetry": {"enabled": "yes"}}):
        with pytest.raises(ValueError) as want:
            _Jax.RuntimeConfig.from_dict(bad)
        with pytest.raises(ValueError) as got:
            _Port.RuntimeConfig.from_dict(bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# ModelPool against the reference


def _pool_states():
    """Reduced DeiT-tiny params + AdamW state in both packages, from one
    init."""
    jcfg, cfg = jax_get_reduced("deit-tiny"), get_reduced("deit-tiny")
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    js = jax_optim.adamw_init(jp, jax_optim.AdamWConfig())
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    ts = optim.adamw_init(tp, optim.AdamWConfig())
    return (jp, js), (tp, ts)


def _pool_trace(mod, cost_cls, trees):
    mb = mod.tree_mb(*trees)
    pool = mod.ModelPool(
        [mod.ModelSlot("cv", None, None, cost=cost_cls()),
         mod.ModelSlot("nlp", None, None,
                       cost=cost_cls(t_load_s=0.7, t_save_s=0.3,
                                     overhead_power_w=4.0))],
        memory_budget_mb=1.5 * mb)
    pool.set_memory("cv", mb)
    pool.set_memory("nlp", mb)
    out = [mb, pool.warm()]
    for name in ("cv", "nlp", "nlp", "cv", "cv", "nlp", "cv"):
        out.append((pool.ensure_resident(name), pool.resident))
    return out


def test_model_pool_matches_reference():
    (jp, js), (tp, ts) = _pool_states()
    want = _pool_trace(jax_modelpool, JaxEdgeCostModel, (jp, js))
    got = _pool_trace(modelpool, EdgeCostModel, (tp, ts))
    assert got == want
    assert want[1] == ("cv",)
    assert sum(1 for (t, _, _), _ in want[2:] if t) == 4  # swaps


# ---------------------------------------------------------------------------
# the throttle facet and the environment models (copied inert, A.8)


def _env_trace(env_mod, throttle_mod):
    """A device environment stepped through a fixed energy/time sequence,
    and each throttle policy's answer at every step."""
    dev = env_mod.DeviceEnv(env_mod.EnvSpec(
        battery_capacity_j=400.0, harvest_w=2.0, thermal_cap_c=40.0,
        thermal_time_constant_s=5.0), "dev0")
    pols = [throttle_mod.NullThrottle(), throttle_mod.BudgetThrottle(0.3),
            throttle_mod.ThermalThrottle(35.0)]
    out = []
    for i, (energy, dt) in enumerate([(30.0, 1.0), (60.0, 2.0), (5.0, 4.0),
                                      (120.0, 1.5), (0.0, 10.0),
                                      (90.0, 0.5), (40.0, 3.0)]):
        dev.on_energy(energy)
        level = dev.step(float(i * 4 + dt))
        st = dev.state()
        out.append((level, st, [p.allow_round(st, energy_j=25.0)
                                for p in pols]))
    return out, [p.stats() for p in pols], dev.dvfs.transitions


def test_env_models_and_throttles_match_reference():
    want = _env_trace(jax_env, jax_throttle)
    got = _env_trace(env, throttle)
    assert [(lv, dataclasses.astuple(st), a) for lv, st, a in got[0]] == \
        [(lv, dataclasses.astuple(st), a) for lv, st, a in want[0]]
    assert got[1:] == want[1:]
    assert want[2] > 0 and any(not a[1] for _, _, a in want[0])


# ---------------------------------------------------------------------------
# what the port cannot run yet


def _tiny_bench():
    return nc_benchmark(num_classes=10, num_scenarios=2, batches=2,
                        batch_size=4, image_size=32, seed=0)


UNPORTED = {
    "bert": (dict(slots={"default": config.SlotConfig(arch="bert-base")}),
             "ROADMAP A.2"),
    "nlp-workload": (dict(slots={"cv": config.SlotConfig(arch="deit-tiny"),
                                 "nlp": config.SlotConfig(arch="bert-base")},
                          workload="mixed", compiled=True),
                     "ROADMAP queue A item 6"),
    "workload": (dict(workload="mixed"), "ROADMAP queue A item 6"),
    "telemetry": (dict(telemetry=TelemetrySpec(enabled=True)),
                  "ROADMAP A.8"),
    "two-devices": (dict(devices=(config.DeviceConfig("dev0"),
                                  config.DeviceConfig("dev1"))),
                    "ROADMAP A.8"),
    "least-loaded": (dict(routing="least-loaded"), "ROADMAP A.8"),
    "merge": (dict(aggregate_every=5.0), "ROADMAP A.8"),
    "env": (dict(devices=(config.DeviceConfig(
        "dev0", env=env.EnvSpec(battery_capacity_j=100.0)),)),
        "ROADMAP A.8"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_paths_raise_naming_their_roadmap_item(name):
    kw, label = UNPORTED[name]
    kw = {"slots": {"default": config.SlotConfig(arch="deit-tiny")}, **kw}
    with pytest.raises(NotImplementedError, match=label):
        rt = continual.ContinualRuntime.from_config(
            config.RuntimeConfig(pretrain_epochs=0, **kw), device=CPU,
            benchmark=_tiny_bench())
        rt.run(events=[])


def test_legacy_constructor_warns_and_resolves_like_from_config():
    bench = _tiny_bench()
    model = build_model(get_reduced("deit-tiny"), device=CPU)
    with pytest.warns(DeprecationWarning, match="from_config"):
        rt = continual.ContinualRuntime(model, bench, None, device=CPU,
                                        seed=2, pretrain_epochs=1)
    assert (rt.model, rt.bench, rt.seed, rt.pretrain_epochs, rt.device) == \
        (model, bench, 2, 1, torch.device(CPU))
    assert isinstance(rt.controller, policies.PolicyStack)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rt = continual.ContinualRuntime(model, bench, None, device=CPU,
                                        quant_bits=8, unlabeled_fraction=0.5)
    assert [type(h) for h in rt.hooks] == [executor.FakeQuantHook,
                                           executor.SimSiamHook]
    assert rt.hooks[0].bits == 8 and rt.hooks[1].unlabeled_fraction == 0.5
    assert rt.model.loss is not model.loss  # fake-quant wraps the model


def test_injected_model_must_live_on_the_session_device():
    model = build_model(get_reduced("deit-tiny"), device=CPU)
    with pytest.raises(ValueError, match="lives on cpu"):
        continual.ContinualRuntime.from_config(
            config.RuntimeConfig(), device="meta", model=model,
            benchmark=_tiny_bench())
