"""The port's `DeviceFleet` beyond one device, against the JAX package's:
the sessions of `tests/test_fleet.py` run live in both packages on the
CPU (reduced MobileNetV2, the `two-stream` and `fleet` workload presets
at that file's scale, one pretraining epoch), and in the port compiled
and eager.

Held equal across the packages: rounds, syncs, swaps, probes, each
device's streams, rounds, syncs and eviction, and the stream
assignment; accuracies within 1e-6, the validation curve within 1e-5,
ledger totals within 3% (ROADMAP C.5). Every attribution (per stream,
model and device) sums to the totals within 1e-9. Within the port, the
compiled session is exactly the eager one, final params of every device
bitwise equal. The federated merge's arithmetic (rounds-weighted fp32
mean, summed in device order) is held to the reference's on the same
numpy trees within 1e-6, and each participant gets its own copy.

The port's model is injected with an `init` returning the JAX package's
`init(PRNGKey(0))` carried across by `bridge.params_from_jax`; the JAX
side gets one shared model, so its sessions reuse their compiled steps.
"""
import dataclasses
import functools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data.arrivals import Event as JaxEvent
from repro.distributed.straggler import StragglerConfig as JaxStragglerConfig
from repro.models import build_model as jax_build_model
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import SlotConfig as JaxSlotConfig
from repro.runtime import edgeol_session as jax_edgeol_session
from repro.runtime import fleet as jax_fleet
from repro.runtime.config import DeviceConfig as JaxDeviceConfig
from repro.runtime.costmodel import EdgeCostModel as JaxEdgeCostModel
from repro.runtime.ledger import CostLedger as JaxCostLedger
from repro_torch import tree_leaves, tree_map
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.data.arrivals import Event
from repro_torch.distributed.straggler import StragglerConfig
from repro_torch.models import build_model
from repro_torch.runtime import RuntimeConfig, SlotConfig, edgeol_session
from repro_torch.runtime import fleet
from repro_torch.runtime.config import DeviceConfig
from repro_torch.runtime.costmodel import EdgeCostModel
from repro_torch.runtime.ledger import CostLedger

CPU = "cpu"
SCALE = dict(batches_per_scenario=3, inferences=6, num_scenarios=2)
FLEET_SCALE = dict(batches_per_scenario=2, inferences=4, num_scenarios=2,
                   fleet_streams=6)


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


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree.map(np.asarray, _jax_model().init(jax.random.PRNGKey(0)))


def _port_model():
    cfg = get_reduced("mobilenetv2")
    params = params_from_jax(_jax_params(), cfg, device=CPU)
    return dataclasses.replace(build_model(cfg, device=CPU),
                               init=lambda generator: params)


class _Jax:
    RuntimeConfig = JaxRuntimeConfig
    SlotConfig = JaxSlotConfig
    DeviceConfig = JaxDeviceConfig
    StragglerConfig = JaxStragglerConfig
    fleet_devices = staticmethod(jax_fleet.fleet_devices)

    @staticmethod
    def session(cfg):
        return jax_edgeol_session(cfg, model=_jax_model())


class _Port:
    RuntimeConfig = RuntimeConfig
    SlotConfig = SlotConfig
    DeviceConfig = DeviceConfig
    StragglerConfig = StragglerConfig
    fleet_devices = staticmethod(fleet.fleet_devices)

    @staticmethod
    def session(cfg):
        return edgeol_session(cfg, device=CPU, model=_port_model())


def _devices(api, name):
    """The device tuples of `tests/test_fleet.py`'s sessions."""
    D = api.DeviceConfig
    return {
        "one": (D("dev0"),),
        "three": api.fleet_devices(3, seed=0, speed_spread=0.4,
                                   energy_spread=0.2),
        "two": api.fleet_devices(2, seed=0, speed_spread=0.4),
        "fleet3": api.fleet_devices(3, seed=0, speed_spread=0.4),
        "slow": (D("dev0"), D("dev1"), D("slow", speed_scale=0.2)),
    }[name]


# name -> (workload, scale, devices, config knobs, straggler config)
SESSIONS = {
    "legacy": ("two-stream", SCALE, None, {}, None),
    "fleet-of-one": ("two-stream", SCALE, "one", {}, None),
    "one-with-merge-period": ("two-stream", SCALE, "one",
                              dict(aggregate_every=20.0,
                                   routing="least-loaded"), None),
    "three-devices": ("two-stream", SCALE, "three",
                      dict(routing="least-loaded", aggregate_every=25.0),
                      None),
    "fleet-preset": ("fleet", FLEET_SCALE, "fleet3",
                     dict(routing="least-loaded", aggregate_every=25.0),
                     None),
    "two-drift": ("two-stream", SCALE, "two", dict(aggregate_every=0.0),
                  None),
    "two-merged": ("two-stream", SCALE, "two", dict(aggregate_every=20.0),
                   None),
    "straggler": ("fleet", FLEET_SCALE, "slow",
                  dict(routing="static", aggregate_every=10.0),
                  dict(min_samples=1, slow_factor=1.5, evict_after=2)),
}


@functools.lru_cache(maxsize=None)
def _run(api, name, compiled=True):
    workload, scale, devices, knobs, straggler = SESSIONS[name]
    kw = dict(knobs)
    if devices is not None:
        kw["devices"] = _devices(api, devices)
    cfg = api.RuntimeConfig(slots={"cv": api.SlotConfig()},
                            workload=workload, workload_scale=dict(scale),
                            seed=0, pretrain_epochs=1, compiled=compiled,
                            **kw)
    rt = api.session(cfg)
    if straggler is not None:
        rt.straggler_config = api.StragglerConfig(**straggler)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = rt.run()
    return res, rt


def _assert_identical(a, b):
    """`tests/test_fleet.py::_assert_identical`, plus the devices."""
    assert a.rounds == b.rounds
    assert a.swaps == b.swaps
    assert a.syncs == b.syncs
    np.testing.assert_array_equal(a.inference_accs, b.inference_accs)
    np.testing.assert_array_equal(a.val_curve, b.val_curve)
    assert a.total_time_s == b.total_time_s
    assert a.total_energy_j == b.total_energy_j
    assert a.compute_tflops == b.compute_tflops
    assert a.per_stream == b.per_stream
    assert a.per_model == b.per_model
    assert a.per_device == b.per_device


def _assert_attributions_sum(res):
    for dim in (res.per_stream, res.per_model, res.per_device):
        np.testing.assert_allclose(
            sum(v["time_s"] for v in dim.values()), res.total_time_s,
            rtol=1e-9)
        np.testing.assert_allclose(
            sum(v["energy_j"] for v in dim.values()), res.total_energy_j,
            rtol=1e-9)


DEVICE_COUNTS = ("streams", "rounds", "syncs", "swaps", "evicted",
                 "battery_dead")


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matches_reference(name):
    (port, prt), (ref, jrt) = _run(_Port, name), _run(_Jax, name)
    for key in ("rounds", "recompiles", "syncs", "swaps", "probes",
                "preemptions", "controller_stats"):
        assert getattr(port, key) == getattr(ref, key), key
    assert prt.fleet.assignment == jrt.fleet.assignment
    assert sorted(port.per_device) == sorted(ref.per_device)
    for dev in ref.per_device:
        got, want = port.per_device[dev], ref.per_device[dev]
        assert {k: got[k] for k in DEVICE_COUNTS} == \
            {k: want[k] for k in DEVICE_COUNTS}, dev
    assert sorted(map(str, port.per_stream)) == \
        sorted(map(str, ref.per_stream))
    assert len(port.inference_accs) == len(ref.inference_accs) > 0
    np.testing.assert_allclose(port.inference_accs, ref.inference_accs,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.val_curve, ref.val_curve, rtol=0,
                               atol=1e-5)
    for key in ("total_time_s", "total_energy_j"):
        assert getattr(port, key) == pytest.approx(getattr(ref, key),
                                                   rel=0.03), key
    _assert_attributions_sum(port)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_compiled_session_is_exactly_eager(name):
    (compiled, crt), (eager, ert) = _run(_Port, name), \
        _run(_Port, name, compiled=False)
    _assert_identical(compiled, eager)
    for a, b in zip(crt.fleet.devices, ert.fleet.devices, strict=True):
        for x, y in zip(tree_leaves(a.primary.executor.params),
                        tree_leaves(b.primary.executor.params),
                        strict=True):
            assert torch.equal(x, y)


def test_fleet_of_one_matches_single_device():
    legacy, one = _run(_Port, "legacy")[0], _run(_Port, "fleet-of-one")[0]
    _assert_identical(legacy, one)
    assert one.syncs == 0 and set(one.per_device) == {"dev0"}
    merge = _run(_Port, "one-with-merge-period")[0]
    _assert_identical(legacy, merge)  # a merge needs two participants
    assert merge.syncs == 0


def test_multi_device_fleet_syncs_and_sums():
    res = _run(_Port, "three-devices")[0]
    devices = _devices(_Port, "three")
    assert res.syncs > 0
    assert set(res.per_device) == {d.name for d in devices}
    assert res.syncs == sum(v["syncs"] for v in res.per_device.values())
    assert str(fleet.FLEET_STREAM) in {str(k) for k in res.per_stream}
    for v in res.per_device.values():
        assert 0.0 <= v["utilization"] <= 1.0 + 1e-9
    preset = _run(_Port, "fleet-preset")[0]
    assert preset.syncs > 0 and len(preset.per_device) == 3
    assert sum(v["streams"] for v in preset.per_device.values()) == 6
    _assert_attributions_sum(preset)


def test_aggregation_changes_trajectory():
    drift, merged = _run(_Port, "two-drift")[0], _run(_Port, "two-merged")[0]
    assert drift.syncs == 0 and merged.syncs > 0
    assert merged.total_time_s > 0
    _assert_attributions_sum(drift)
    _assert_attributions_sum(merged)


def test_straggler_eviction_reroutes_streams():
    res, rt = _run(_Port, "straggler")
    slow = res.per_device["slow"]
    assert slow["evicted"] and slow["streams"] == 0
    assert sum(v["streams"] for v in res.per_device.values()) == 6
    assert res.rounds > 0
    assert set(rt.fleet.tracker.evicted) == {2}
    _assert_attributions_sum(res)


# ---------------------------------------------------------------------------
# routing and device specs


def _routing_events(make):
    uniform = [make(float(i), "data", 0, i, stream=st)
               for st in range(4) for i in range(5)]
    skewed = ([make(0.0, "data", 0, i, stream=0) for i in range(10)]
              + [make(0.0, "data", 0, i, stream=1) for i in range(1)]
              + [make(0.0, "data", 0, i, stream=2) for i in range(1)])
    return uniform, skewed


@pytest.mark.parametrize("policy", ["static", "least-loaded"])
def test_routing_matches_reference(policy):
    for api, mod, make in ((_Port, fleet, Event),
                           (_Jax, jax_fleet, JaxEvent)):
        D = api.DeviceConfig
        uniform, skewed = _routing_events(make)
        specs = [D("dev0"), D("fast", speed_scale=3.0)]
        got = mod.build_routing(policy).assign([0, 1, 2, 3], uniform, specs)
        got2 = mod.build_routing(policy).assign(
            [0, 1, 2], skewed, [D("dev0"), D("dev1")])
        got3 = mod.build_routing(policy).assign([3, 0, 7, 1], [], specs)
        if api is _Port:
            port = (got, got2, got3)
        else:
            assert port == (got, got2, got3)
    if policy == "least-loaded":
        counts = {0: 0, 1: 0}
        for d in port[0].values():
            counts[d] += 1
        assert counts[1] > counts[0]  # the 3x device absorbs more
        assert port[1][1] == port[1][2] != port[1][0]  # heaviest alone
    else:
        assert port[2] == {0: 0, 1: 1, 3: 0, 7: 1}
    with pytest.raises(ValueError, match=r"least-loaded.*static"):
        fleet.build_routing("bogus")


def test_fleet_devices_match_reference():
    got = fleet.fleet_devices(4, seed=3, speed_spread=0.4, energy_spread=0.2)
    want = jax_fleet.fleet_devices(4, seed=3, speed_spread=0.4,
                                   energy_spread=0.2)
    assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    assert got == fleet.fleet_devices(4, seed=3, speed_spread=0.4,
                                      energy_spread=0.2)
    assert got[0] == DeviceConfig("dev0")
    with pytest.raises(ValueError, match="at least one"):
        fleet.fleet_devices(0)


# ---------------------------------------------------------------------------
# the merge on the same trees


def _merge_inputs(seed=0):
    """Three devices' params of one slot (numpy, seeded) and their rounds
    since the last sync; the last device sits out mid-round."""
    rng = np.random.default_rng(seed)
    trees = [{"head": {"w": rng.normal(size=(8, 5)).astype(np.float32),
                       "b": rng.normal(size=(5,)).astype(np.float32)},
              "units": [{"conv": rng.normal(size=(3, 3, 2, 4)).astype(
                  np.float32)}]} for _ in range(3)]
    return trees, [3, 1, 2], [None, None, object()]


def _fake_fleet(mod, make_leaf, ledger, cost):
    trees, weights, active = _merge_inputs()
    published, occupied = [], []
    devices = []
    for i, (tree, w, act) in enumerate(zip(trees, weights, active)):
        ex = types.SimpleNamespace(
            params=tree_map(make_leaf, tree) if make_leaf is not None
            else jax.tree.map(jnp.asarray, tree),
            active_round=act, cost=cost)
        devices.append(types.SimpleNamespace(
            index=i, name=f"dev{i}", env=None, slots={"cv": types.SimpleNamespace(
                executor=ex)}, rounds_since_sync={"cv": w},
            server=types.SimpleNamespace(
                publish=lambda p, ts, slot: published.append((p, ts, slot)))))
    scheduler = types.SimpleNamespace(occupy=lambda *a, **k: (
        occupied.append((a, k)) or types.SimpleNamespace(start=a[0])))
    host = types.SimpleNamespace()
    fl = mod.DeviceFleet.__new__(mod.DeviceFleet)
    fl.__dict__.update(devices=devices, _evicted=set(), _flagged=set(),
                       ledger=ledger, scheduler=scheduler, host=host,
                       telemetry=None, tracer=None)
    return fl, published, occupied


def test_merge_matches_reference_on_the_same_trees():
    port, p_pub, p_occ = _fake_fleet(fleet, torch.from_numpy, CostLedger(),
                                     EdgeCostModel())
    ref, r_pub, r_occ = _fake_fleet(jax_fleet, None, JaxCostLedger(),
                                    JaxEdgeCostModel())
    fleet.DeviceFleet._merge(port, 7.5)
    jax_fleet.DeviceFleet._merge(ref, 7.5)
    assert len(p_pub) == len(r_pub) == 2  # the mid-round device sat out
    for d in range(2):
        got = port.devices[d].slots["cv"].executor.params
        want = ref.devices[d].slots["cv"].executor.params
        for g, w in zip(tree_leaves(got),
                        tree_leaves(_sorted_like(got, want)), strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
        assert port.devices[d].rounds_since_sync["cv"] == 0
    # each participant holds its own copy of the merged tree
    a, b = (tree_leaves(port.devices[d].slots["cv"].executor.params)
            for d in range(2))
    assert all(x.data_ptr() != y.data_ptr() and torch.equal(x, y)
               for x, y in zip(a, b))
    # the sat-out device keeps its params and its weight
    assert port.devices[2].rounds_since_sync["cv"] == 2
    assert port.ledger.syncs == ref.ledger.syncs == 2
    assert port.ledger.total_time_s == ref.ledger.total_time_s
    assert [a for a, _ in p_occ] == [a for a, _ in r_occ]
    # the weighted mean of the first leaf, written out
    trees, weights, _ = _merge_inputs()
    want = (3 * trees[0]["head"]["w"] + 1 * trees[1]["head"]["w"]) / 4
    np.testing.assert_allclose(
        port.devices[0].slots["cv"].executor.params["head"]["w"].numpy(),
        want, rtol=0, atol=1e-6)


def _sorted_like(port_tree, jax_tree):
    """`jax_tree` with its dicts in `port_tree`'s key order, so the two
    trees' leaves pair in order."""
    if isinstance(port_tree, dict):
        return {k: _sorted_like(v, jax_tree[k]) for k, v in port_tree.items()}
    if isinstance(port_tree, (list, tuple)):
        return [_sorted_like(v, w) for v, w in zip(port_tree, jax_tree)]
    return jax_tree


def test_eviction_shrinks_an_injected_mesh():
    """The reference's elastic mesh (`DeviceFleet(mesh=, param_specs=)`,
    `src/repro/runtime/fleet.py:576-591`): the straggler session's
    eviction halves the `data` axis of an injected (4, 2) mesh, here over
    a fake process group of 8 ranks in this process, and re-shards the
    survivors' params onto the (2, 2) mesh (`fleet.mesh_params`). The
    mesh changes no number: the run is the mesh-less run exactly, every
    device's params bitwise, and its rounds, syncs and per-device counts
    are the reference fleet's. Its params are held to the reference's
    through what they compute (served accuracies within 1e-6, the
    validation curve within 1e-5), as `test_session_matches_reference`
    holds them: after this session's AdamW rounds the two frameworks'
    params part by up to ~1e-2 of entries near 2, rounding amplified."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import sharding as sh
    from repro_torch.runtime.fleet import DeviceFleet

    workload, scale, devices, knobs, straggler = SESSIONS["straggler"]
    rt = _Port.session(RuntimeConfig(
        slots={"cv": SlotConfig()}, workload=workload,
        workload_scale=dict(scale), seed=0, pretrain_epochs=1,
        devices=_devices(_Port, devices), **knobs))
    rt.straggler_config = StragglerConfig(**straggler)
    cfg = get_reduced("mobilenetv2")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data",
                                                               "model"))
        specs = sh.param_specs(_port_model().init(None), cfg, mesh)
        fl = DeviceFleet(rt, mesh=mesh, param_specs=specs)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res = fl.run(list(rt._session_events))
        assert sh.axis_sizes(fl._mesh) == {"data": 2, "model": 2}
    finally:
        dist.destroy_process_group()
    (plain, prt), (ref, _) = _run(_Port, "straggler"), _run(_Jax, "straggler")
    _assert_identical(res, plain)
    for a, b in zip(fl.devices, prt.fleet.devices, strict=True):
        for x, y in zip(tree_leaves(a.primary.executor.params),
                        tree_leaves(b.primary.executor.params), strict=True):
            assert torch.equal(x, y)
    assert (res.rounds, res.syncs) == (ref.rounds, ref.syncs)
    np.testing.assert_allclose(res.inference_accs, ref.inference_accs,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.val_curve, ref.val_curve, rtol=0,
                               atol=1e-5)
    for dev in ref.per_device:
        assert {k: res.per_device[dev][k] for k in DEVICE_COUNTS} == \
            {k: ref.per_device[dev][k] for k in DEVICE_COUNTS}, dev
    assert ref.per_device["slow"]["evicted"]
    survivors = [d.index for d in fl.devices if d.name != "slow"]
    assert sorted(fl.mesh_params) == [(i, name) for i in survivors
                                      for name in fl.devices[i].slots]
    for placed in fl.mesh_params.values():
        for t, s in zip(tree_leaves(placed), tree_leaves(
                sh.map_with_path(lambda _, s: s, specs)), strict=True):
            assert t.device_mesh is not mesh
            assert t.placements == sh.placements(t.device_mesh, s)
