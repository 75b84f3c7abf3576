"""The device environment in the port's fleet (DESIGN.md §15) against the
JAX package's: `EnvSpec` / `DeviceConfig` round trips and validation
across the packages; the battery, thermal RC node and DVFS governor step
for step against the reference's models; the throttle facets; and the
sessions of `tests/test_env.py` live on the CPU (reduced MobileNetV2 on
the `two-stream` preset at that file's scale), in the port compiled and
eager.

Equal in the port: an inactive spec and a null throttle leave a fleet
session bit for bit as it was; a battery's drain equals its device's
ledger energy; a finite battery throttles or evicts within its budget,
compiled exactly as eager, and, as in the reference's version of that
session, its Chrome trace loads with the temperature and state-of-charge
counters of both devices, gauge events and throttle marks.

Across the packages the throttle and eviction decisions are held equal
with a policy stack without SimFreeze: every plan is then all-active,
the one-shot cost calibration makes both ledgers equal up to rounding,
and a battery threshold falls on the same event in both (under SimFreeze
plans the ledgers part by up to the C.5 gap). Equal: rounds, syncs,
deferrals, each device's eviction, battery death and DVFS time; ledger
totals within 1e-9.
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
from repro.models import build_model as jax_build_model
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import SlotConfig as JaxSlotConfig
from repro.runtime import TelemetrySpec as JaxTelemetrySpec
from repro.runtime import edgeol_session as jax_edgeol_session
from repro.runtime.config import DeviceConfig as JaxDeviceConfig
from repro.runtime.costmodel import EdgeCostModel as JaxEdgeCostModel
from repro.runtime.costmodel import scale_cost as jax_scale_cost
from repro_torch import env
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.core import policies
from repro_torch.models import build_model
from repro_torch.obs import events_from_chrome, load_chrome_trace
from repro_torch.runtime import (RuntimeConfig, SlotConfig, TelemetrySpec,
                                 edgeol_session)
from repro_torch.runtime.config import DeviceConfig
from repro_torch.runtime.costmodel import EdgeCostModel, scale_cost
from repro_torch.runtime.ledger import CostLedger

CPU = "cpu"
SCALE = dict(batches_per_scenario=3, inferences=6, num_scenarios=2)
BUDGET = 40.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model():
    return jax_build_model(jax_get_reduced("mobilenetv2"))


def _port_model():
    cfg = get_reduced("mobilenetv2")
    params = params_from_jax(
        jax.tree.map(np.asarray, _jax_model().init(jax.random.PRNGKey(0))),
        cfg, device=CPU)
    return dataclasses.replace(build_model(cfg, device=CPU),
                               init=lambda generator: params)


class _Jax:
    env = jax_env
    policies = jax_policies
    RuntimeConfig = JaxRuntimeConfig
    SlotConfig = JaxSlotConfig
    DeviceConfig = JaxDeviceConfig
    TelemetrySpec = JaxTelemetrySpec

    @staticmethod
    def session(cfg):
        return jax_edgeol_session(cfg, model=_jax_model())


class _Port:
    env = env
    policies = policies
    RuntimeConfig = RuntimeConfig
    SlotConfig = SlotConfig
    DeviceConfig = DeviceConfig
    TelemetrySpec = TelemetrySpec

    @staticmethod
    def session(cfg):
        return edgeol_session(cfg, device=CPU, model=_port_model())


# ---------------------------------------------------------------------------
# specs


SPECS = [dict(battery_capacity_j=50.0, thermal_cap_c=60.0,
              dvfs_levels=(1.0, 0.5)),
         dict(battery_capacity_j=1.0), dict(thermal_cap_c=40.0), {},
         dict(harvest_w=2.0, battery_reserve_frac=0.2, ambient_c=20.0,
              gauge_period_s=1.0)]


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: ",".join(kw) or "none")
def test_env_spec_round_trips_across_packages(kw):
    got, want = env.EnvSpec(**kw), jax_env.EnvSpec(**kw)
    assert got.to_dict() == want.to_dict()
    assert got.active == want.active
    assert env.EnvSpec.from_dict(want.to_dict()) == got
    dc = DeviceConfig("dev1", speed_scale=1.5, env=got).validate("test")
    jdc = JaxDeviceConfig("dev1", speed_scale=1.5, env=want).validate("test")
    assert dc.to_dict() == jdc.to_dict()
    assert DeviceConfig.from_dict(jdc.to_dict()) == dc
    assert "env" not in DeviceConfig("dev0").to_dict()


@pytest.mark.parametrize("bad, match", [
    (dict(battery_capacity_j=-1.0), "battery_capacity_j"),
    (dict(dvfs_levels=(0.5, 1.0)), "dvfs_levels"),
    (dict(battery_reserve_frac=1.0), "reserve")])
def test_env_spec_validation_matches_reference(bad, match):
    for mod in (env, jax_env):
        with pytest.raises(ValueError, match=match):
            mod.EnvSpec(**bad).validate()
    with pytest.raises(ValueError, match="unknown"):
        env.EnvSpec.from_dict({"battery_capacity_mj": 1.0})


# ---------------------------------------------------------------------------
# the physics, step for step


def _physics(mod):
    out = []
    b = mod.BatteryModel(100.0, harvest_w=2.0, reserve_frac=0.1)
    for op, x in (("drain", 30.0), ("harvest", 5.0), ("harvest", 100.0),
                  ("drain", 91.0)):
        getattr(b, op)(x)
        out.append((b.charge_j, b.drained_j, b.harvested_j, b.soc, b.dead))
    t = mod.ThermalModel(ambient_c=25.0, resistance_c_per_w=2.0,
                         time_constant_s=30.0)
    out += [t.step(p, dt) for p, dt in ((3.0, 10.0), (3.0, 7.0),
                                        (0.0, 13.0), (8.0, 40.0))]
    g = mod.DvfsGovernor((1.0, 0.75, 0.5), cap_c=60.0, hysteresis_c=5.0)
    out += [g.update(c) for c in (65.0, 65.0, 65.0, 57.0, 54.0, 54.0)]
    out.append(g.transitions)
    out.append(mod.DvfsGovernor((1.0, 0.5), cap_c=0.0).update(500.0))
    return out


def test_physics_matches_reference_step_for_step():
    got, want = _physics(env), _physics(jax_env)
    assert got == want
    assert want[3][4] and want[-2] == 4  # dead battery; 4 transitions


def test_throttles_and_dvfs_rescale_match_reference():
    def decide(mod, pols):
        E = mod.EnvState
        states = [E(device="d", temperature_c=30.0, level=1.0),
                  E(device="d", temperature_c=30.0, level=1.0, soc=0.5,
                    charge_j=50.0, reserve_j=5.0),
                  E(device="d", temperature_c=85.0, level=0.5, soc=0.02,
                    charge_j=2.0, reserve_j=5.0, battery_dead=True)]
        built = [pols.build_throttle(pols.PolicySpec(*s)) for s in (
            ("none",), ("battery", {"min_soc": 0.1}),
            ("thermal", {"max_temp_c": 80.0}))]
        return [[p.allow_round(s, energy_j=e) for p in built
                 for s in states] for e in (0.0, 40.0, 46.0)], \
            [p.stats() for p in built]

    assert decide(env, policies) == decide(jax_env, jax_policies)
    base = EdgeCostModel()
    for speed, energy in ((0.75, 0.5625), (0.5 / 0.75, (0.5 / 0.75) ** 2),
                          (1.0, 1.0)):
        got = dataclasses.asdict(scale_cost(base, speed=speed, energy=energy))
        want = dataclasses.asdict(jax_scale_cost(
            JaxEdgeCostModel(), speed=speed, energy=energy))
        assert got == want


def test_ledger_observer_takes_the_env_observer():
    dev = env.DeviceEnv(env.EnvSpec(battery_capacity_j=100.0), "dev1")
    ledger = CostLedger()
    ledger.telemetry = env.EnvLedgerObserver({"dev1": dev}, inner=None)
    ledger.charge_probe("cka", 1.0, 2.5, device="dev1")
    ledger.charge_sync(time_s=1.0, energy_j=4.0, device="dev1")
    ledger.charge_swap(time_s=1.0, energy_j=8.0, model="m", device="dev0")
    assert dev.battery.drained_j == 6.5 == \
        ledger.per_device["dev1"]["energy_j"]


# ---------------------------------------------------------------------------
# sessions


def _battery_policies(api, freeze=True):
    P = api.policies
    kw = {} if freeze else {"freeze": P.PolicySpec("none")}
    return P.PolicyStackSpec(throttle=P.PolicySpec("battery"), **kw)


def _devices(api, name):
    D, E = api.DeviceConfig, api.env.EnvSpec
    if name == "plain":
        return (D("dev0"), D("dev1"))
    if name == "inert":
        return (D("dev0", env=E()), D("dev1", env=E()))
    if name == "huge":
        e = E(battery_capacity_j=1e9)
        return (D("dev0", env=e), D("dev1", env=e, speed_scale=1.5))
    e = E(battery_capacity_j=BUDGET, thermal_cap_c=26.0)
    return (D("dev0", env=e), D("dev1", env=e))


#: the session that runs traced when compiled (its Chrome trace is
#: checked); its eager run is untraced, and the two are held equal
TRACED = "finite"

SESSIONS = {"plain": ("plain", None), "inert": ("inert", None),
            "null-throttle": ("plain", "null"), "huge": ("huge", None),
            "finite": ("finite", "battery"),
            "finite-no-freeze": ("finite", "battery-no-freeze")}


@functools.lru_cache(maxsize=None)
def _run(api, name, compiled=True):
    devices, pol = SESSIONS[name]
    slot = api.SlotConfig()
    if pol == "null":
        slot = api.SlotConfig(policies=api.policies.PolicyStackSpec(
            throttle=api.policies.PolicySpec("none")))
    elif pol is not None:
        slot = api.SlotConfig(policies=_battery_policies(
            api, freeze=pol == "battery"))
    cfg = api.RuntimeConfig(slots={"cv": slot}, workload="two-stream",
                            workload_scale=dict(SCALE), seed=0,
                            pretrain_epochs=1, compiled=compiled,
                            devices=_devices(api, devices),
                            aggregate_every=50.0,
                            telemetry=api.TelemetrySpec(
                                enabled=name == TRACED and compiled))
    rt = api.session(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = rt.run()
    return res, rt


def _assert_identical(a, b):
    """`tests/test_env.py::_assert_identical`."""
    assert a.rounds == b.rounds
    assert a.syncs == b.syncs
    np.testing.assert_array_equal(a.inference_accs, b.inference_accs)
    np.testing.assert_array_equal(a.val_curve, b.val_curve)
    assert a.total_time_s == b.total_time_s
    assert a.total_energy_j == b.total_energy_j
    assert a.per_stream == b.per_stream
    assert a.per_device == b.per_device


def test_inactive_env_and_null_throttle_are_bit_exact():
    base, _ = _run(_Port, "plain")
    inert, rt = _run(_Port, "inert")
    assert rt.fleet.envs == {} and rt.fleet.ledger.telemetry is None
    _assert_identical(base, inert)
    _assert_identical(base, _run(_Port, "null-throttle")[0])


def test_battery_drain_equals_per_device_ledger_energy():
    res, rt = _run(_Port, "huge")
    envs = rt.fleet.envs
    assert set(envs) == {"dev0", "dev1"}
    assert isinstance(rt.fleet.ledger.telemetry, env.EnvLedgerObserver)
    for name, cell in res.per_device.items():
        assert envs[name].battery.drained_j == pytest.approx(
            cell["energy_j"], rel=1e-9)
        assert not envs[name].battery_dead
    ref = _run(_Jax, "huge")[0]
    assert res.rounds == ref.rounds and res.syncs == ref.syncs
    for name, cell in ref.per_device.items():
        assert res.per_device[name]["energy_j"] == pytest.approx(
            cell["energy_j"], rel=0.03)


@pytest.mark.parametrize("name", ["finite", "finite-no-freeze"])
def test_finite_battery_fleet_throttles_within_budget(name, tmp_path):
    res, rt = _run(_Port, name)
    engaged = any(cell["throttle_s"] > 0 or cell["battery_dead"] > 0
                  or cell["evicted"] > 0
                  for cell in res.per_device.values())
    deferred = res.controller_stats.get("throttle_deferred", 0)
    assert engaged or deferred > 0
    for cell in res.per_device.values():
        assert cell["energy_j"] <= BUDGET + 1e-6
    assert np.isfinite(res.total_energy_j)
    eager, ert = _run(_Port, name, compiled=False)
    _assert_identical(res, eager)
    assert res.controller_stats == eager.controller_stats
    assert [d.env.state() for d in rt.fleet.devices] == \
        [d.env.state() for d in ert.fleet.devices]
    if name != TRACED:
        return
    # the Chrome trace validates and carries gauges + throttle marks
    trace = str(tmp_path / "env_trace.json")
    rt.telemetry.spec = TelemetrySpec(chrome_trace=trace)
    rt.telemetry.flush_sinks()
    doc = load_chrome_trace(trace)
    counters = {r["name"] for r in doc["traceEvents"]
                if r.get("ph") == "C"}
    assert {"temperature_c/dev0", "soc/dev0",
            "temperature_c/dev1", "soc/dev1"} <= counters
    evs = events_from_chrome(doc)
    assert any(e.cat == "gauge" for e in evs)      # "C" records invert
    assert any(e.cat == "throttle" for e in evs)   # spans or defer marks


def test_throttle_and_eviction_decisions_match_reference():
    res, rt = _run(_Port, "finite-no-freeze")
    ref, jrt = _run(_Jax, "finite-no-freeze")
    for key in ("rounds", "recompiles", "syncs", "controller_stats"):
        assert getattr(res, key) == getattr(ref, key), key
    assert res.controller_stats.get("throttle_deferred", 0) > 0
    for dev, want in ref.per_device.items():
        got = res.per_device[dev]
        for key in ("rounds", "syncs", "streams", "evicted",
                    "battery_dead"):
            assert got[key] == want[key], (dev, key)
        assert got["throttle_s"] == pytest.approx(want["throttle_s"],
                                                  rel=1e-9), dev
        assert got["energy_j"] == pytest.approx(want["energy_j"],
                                                rel=1e-9), dev
    assert rt.fleet.assignment == jrt.fleet.assignment
    np.testing.assert_allclose(res.inference_accs, ref.inference_accs,
                               rtol=0, atol=1e-6)
    for key in ("total_time_s", "total_energy_j"):
        assert getattr(res, key) == pytest.approx(getattr(ref, key),
                                                  rel=1e-9), key
