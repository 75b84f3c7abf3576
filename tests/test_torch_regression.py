"""The sessions of `tests/test_regression_runtime.py` run live in both
packages on the CPU: reduced MobileNetV2 (the runtime's default arch) on
`nc_benchmark` with 3 scenarios of 6 batches of 8 and 16 inferences,
under the ETuner controller, the reference's `semi_quant` session
(immediate rounds with the fake-quant and SimSiam hooks), explicit
`preemptible=False`, the deprecated kwarg constructor and the
fully-declarative policy stack.

Each is held to the composition root's equalities
(`tests/test_torch_runtime.py`): equal rounds, recompiles, probes,
controller stats, freeze plans and attribution keys, accuracies within
1e-6 and the validation curve within 1e-5; hook sessions also make the
same number of SimSiam updates. The golden file is not read (its replays
fail on this JAX version, ROADMAP C.2): the reference runs here.

The port's model is injected with an `init` returning the JAX package's
`init(PRNGKey(0))` carried across by `bridge.params_from_jax`, and its
SimSiam hook is given the reference's augmentation draws and head (JAX
draws them with `jax.random`, which the port does not reproduce).
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core import controller as jax_controller
from repro.core import policies as jax_policies
from repro.core.lazytune import LazyTuneConfig as JaxLazyTuneConfig
from repro.core.simfreeze import SimFreezeConfig as JaxSimFreezeConfig
from repro.data.streams import nc_benchmark as jax_nc_benchmark
from repro.models import build_model as jax_build_model
from repro.runtime import config as jax_config
from repro.runtime import continual as jax_continual
from repro.runtime import executor as jax_executor
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.core import controller, policies
from repro_torch.core.lazytune import LazyTuneConfig
from repro_torch.core.simfreeze import SimFreezeConfig
from repro_torch.data.streams import nc_benchmark
from repro_torch.models import build_model
from repro_torch.runtime import config, continual, executor
from test_torch_cnn import reference_draws, reference_head

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
    ETunerConfig = jax_controller.ETunerConfig
    ETunerController = jax_controller.ETunerController
    LazyTuneConfig = JaxLazyTuneConfig
    SimFreezeConfig = JaxSimFreezeConfig
    RuntimeConfig = jax_config.RuntimeConfig
    SlotConfig = jax_config.SlotConfig
    HookSpec = jax_config.HookSpec
    etuner_stack_spec = staticmethod(jax_policies.etuner_stack_spec)
    ContinualRuntime = jax_continual.ContinualRuntime
    executor = jax_executor

    @staticmethod
    def model_bench():
        return (jax_build_model(jax_get_reduced("mobilenetv2")),
                jax_nc_benchmark(**BENCH))


class _Port:
    ETunerConfig = controller.ETunerConfig
    ETunerController = controller.ETunerController
    LazyTuneConfig = LazyTuneConfig
    SimFreezeConfig = SimFreezeConfig
    RuntimeConfig = config.RuntimeConfig
    SlotConfig = config.SlotConfig
    HookSpec = config.HookSpec
    etuner_stack_spec = staticmethod(policies.etuner_stack_spec)
    ContinualRuntime = continual.ContinualRuntime
    executor = executor

    @staticmethod
    def model_bench():
        """The reduced MobileNetV2 on the CPU, its `init` returning the
        JAX package's `init(PRNGKey(0))` in the port's layout."""
        jcfg, cfg = jax_get_reduced("mobilenetv2"), get_reduced("mobilenetv2")
        params = params_from_jax(
            jax.tree.map(np.asarray,
                         jax_build_model(jcfg).init(jax.random.PRNGKey(0))),
            cfg, device=CPU)
        model = dataclasses.replace(build_model(cfg, device=CPU),
                                    init=lambda generator: params)
        return model, nc_benchmark(**BENCH)


def _ctrl(api, model, method):
    """`tests/test_regression_runtime.py::_ctrl`."""
    return api.ETunerController(model, api.ETunerConfig(
        lazytune=method in ("lazy", "etuner"),
        simfreeze=method in ("freeze", "etuner"),
        detect_scenario_changes=False,
        lazytune_cfg=api.LazyTuneConfig(max_batches_needed=6),
        simfreeze_cfg=api.SimFreezeConfig(freeze_interval=6, min_history=2,
                                          cka_threshold=0.01)))


def _hooks(api):
    return (api.HookSpec("fake-quant", {"bits": 8}),
            api.HookSpec("simsiam", {"fraction": 0.5}))


def _build(api, name):
    """The session `name` of `tests/test_regression_runtime.py`, built
    through the same front door in `api`'s package."""
    model, bench = api.model_bench()
    kw = {"device": CPU} if api is _Port else {}
    if name == "declarative":
        cfg = api.RuntimeConfig(
            slots={"default": api.SlotConfig(policies=api.etuner_stack_spec(
                detect_scenario_changes=False,
                lazytune_params={"max_batches_needed": 6.0},
                simfreeze_params={"freeze_interval": 6, "min_history": 2,
                                  "cka_threshold": 0.01}))},
            pretrain_epochs=1, seed=0, preemptible=False)
        return api.ContinualRuntime.from_config(cfg, model=model,
                                                benchmark=bench, **kw)
    method = "immed" if "semi_quant" in name else "etuner"
    ctrl = _ctrl(api, model, method)
    if name.startswith("legacy"):
        legacy = dict(unlabeled_fraction=0.5, quant_bits=8) \
            if method == "immed" else dict(preemptible=False)
        with pytest.warns(DeprecationWarning, match="legacy kwarg"):
            return api.ContinualRuntime(model, bench, ctrl, pretrain_epochs=1,
                                        seed=0, **legacy, **kw)
    hooks = _hooks(api) if method == "immed" else ()
    cfg_kw = {"preemptible": False} if name == "preemptible_off" else {}
    cfg = api.RuntimeConfig(slots={"default": api.SlotConfig(hooks=hooks)},
                            pretrain_epochs=1, seed=0, **cfg_kw)
    return api.ContinualRuntime.from_config(cfg, model=model, benchmark=bench,
                                            controller=ctrl, **kw)


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


def _run(api, name):
    rt = _build(api, name)
    semi = [0]
    for h in rt.hooks:
        if isinstance(h, api.executor.SimSiamHook):
            if api is _Port:
                h.draws, h.init_head = reference_draws, reference_head
            update = h._semi_update

            def counted(*args, update=update):
                semi[0] += 1
                return update(*args)

            h._semi_update = counted
    with _PlanSpy(api.executor.FineTuneExecutor) as spy:
        r = rt.run(inferences_total=INFERENCES)
    return {"rounds": r.rounds, "recompiles": r.recompiles,
            "probes": r.probes, "preemptions": r.preemptions,
            "controller_stats": r.controller_stats, "round_plans": spy.plans,
            "semi_updates": semi[0], "hooks": [type(h).__name__
                                               for h in rt.hooks],
            "inference_accs": r.inference_accs, "val_curve": r.val_curve,
            "total_time_s": r.total_time_s,
            "keys": {k: {c: sorted(v) for c, v in getattr(r, k).items()}
                     for k in ("per_stream", "per_model", "per_device")}}


# the reference's runs on the CPU: (rounds, recompiles, freezes, SimSiam
# updates); each case must drive the path it is named for
SESSIONS = {
    "etuner": (9, 1, 6, 0),
    "semi_quant": (9, 1, 0, 14),
    "preemptible_off": (9, 1, 6, 0),
    "legacy_etuner": (9, 1, 6, 0),
    "legacy_semi_quant": (9, 1, 0, 14),
    "declarative": (9, 1, 6, 0),
}


@functools.lru_cache(maxsize=None)
def _session(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return _run(_Jax, name), _run(_Port, name)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_regression_session_matches_reference(name):
    ref, port = _session(name)
    for k in ("rounds", "recompiles", "probes", "preemptions",
              "controller_stats", "round_plans", "semi_updates", "hooks",
              "keys"):
        assert port[k] == ref[k], k
    assert (ref["rounds"], ref["recompiles"],
            ref["controller_stats"]["freezes"], ref["semi_updates"]) == \
        SESSIONS[name]
    np.testing.assert_allclose(port["inference_accs"], ref["inference_accs"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["val_curve"], ref["val_curve"], rtol=0,
                               atol=1e-5)
    assert len(port["inference_accs"]) == INFERENCES
    # the modeled time differs only through the FLOP counters (C.5)
    assert port["total_time_s"] == pytest.approx(ref["total_time_s"],
                                                 rel=0.03)


def test_default_session_runs_on_the_default_arch():
    """`edgeol_session(RuntimeConfig())` on its defaults: the reduced
    MobileNetV2 on the default `nc` benchmark, a few events."""
    from repro_torch.data.arrivals import build_timeline
    from repro_torch.runtime import RuntimeConfig, edgeol_session

    cfg = RuntimeConfig()
    assert cfg.slots["default"].arch == "mobilenetv2"
    rt = edgeol_session(dataclasses.replace(cfg, pretrain_epochs=1),
                        device=CPU)
    assert rt.model.cfg.name == "mobilenetv2-reduced"
    events = [dataclasses.replace(e, scenario=e.scenario + 1)
              for e in build_timeline(num_scenarios=1, batches_per_scenario=3,
                                      inferences_total=4, seed=0)]
    r = rt.run(events=events)
    assert len(r.inference_accs) == 4 and r.rounds >= 1
    assert all(0.0 <= a <= 1.0 for a in r.inference_accs)
    assert np.isfinite(r.total_time_s)
