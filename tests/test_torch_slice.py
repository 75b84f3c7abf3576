"""The port's first slice end to end against the JAX package: DeiT
serving through `InferenceServer` and SimFreeze's CKA probe, driven by
`EventScheduler` over the same `nc_benchmark` stream and timeline.

Both packages run the same loop (`run_slice`, which mirrors the handlers
of `repro.runtime.device.DeviceRuntime`): the JAX side with the Pallas
kernels in interpret mode (`use_pallas`, `use_kernel`), the port with the
plain versions its kernel wrappers take on the CPU. Fine-tuning rounds are
the next slice's work, so a seeded numpy perturbation of the params stands
in for them between freeze passes.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_reduced as jax_get_reduced
from repro.core.simfreeze import SimFreeze as JaxSimFreeze
from repro.core.simfreeze import SimFreezeConfig as JaxSimFreezeConfig
from repro.data.arrivals import build_timeline as jax_build_timeline
from repro.data.streams import nc_benchmark as jax_nc_benchmark
from repro.models import build_model as jax_build_model
from repro.runtime.costmodel import EdgeCostModel as JaxEdgeCostModel
from repro.runtime.inference import InferenceServer as JaxInferenceServer
from repro.runtime.ledger import CostLedger as JaxCostLedger
from repro.runtime.scheduler import EventScheduler as JaxEventScheduler
from repro.runtime.train_loop import as_jnp
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.core.simfreeze import SimFreeze, SimFreezeConfig
from repro_torch.data.arrivals import build_timeline
from repro_torch.data.streams import nc_benchmark
from repro_torch.models import build_model
from repro_torch.runtime.costmodel import EdgeCostModel
from repro_torch.runtime.inference import InferenceServer
from repro_torch.runtime.ledger import CostLedger
from repro_torch.runtime.scheduler import EventScheduler
from repro_torch.runtime.train_loop import as_tensor

THRESHOLD = 0.01
BATCH = 8


def _perturbation(tree, seed, scale):
    """Fixed random directions for the blocks and the head, from numpy."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        leaf = np.asarray(leaf)
        return scale * max(float(leaf.std()), 0.02) * \
            rng.standard_normal(leaf.shape).astype(np.float32)

    return {"blocks": [jax.tree.map(draw, b) for b in tree["blocks"]],
            "head": jax.tree.map(draw, tree["head"])}


def _drift(num_blocks, event, first_of_scenario2):
    """Multiplier of each block's direction at data event `event` (and the
    head's, last): the first third of the blocks never moves, so its units
    freeze; the middle third moves from scenario 2 on, so its units freeze
    in scenario 1 and are unfrozen at the boundary; the last third and the
    head drift throughout, by the square root of the events elapsed."""
    third = num_blocks // 3
    late = np.sqrt(max(event - first_of_scenario2 + 1, 0))
    always = np.sqrt(event + 1)
    return [0.0 if b < third else late if b < 2 * third else always
            for b in range(num_blocks)] + [always]


def run_slice(api, model, params0, bench, events, *, batch_window=0.0,
              use_kernel=True, seed=0):
    """Serve every inference event and run SimFreeze's probes on every data
    event, as `DeviceRuntime.on_inference`/`on_data` do; returns what the
    two packages must agree on."""
    sched = api["scheduler"](events)
    served_logits = []

    def on_served(logits, stream):
        served_logits.append(np.array(logits))
        return False

    server = api["server"](model, batch_window=batch_window,
                           on_served=on_served)
    sf = api["simfreeze"](model.num_freeze_units, model.features,
                          api["simfreeze_config"](
                              cka_threshold=THRESHOLD, freeze_interval=1,
                              use_kernel=use_kernel))
    ledger, cost = api["ledger"](), api["cost"]()
    rng = np.random.default_rng(seed)
    first2 = next(i for i, e in enumerate(e for e in events if e.kind == "data")
                  if e.scenario == 2)
    num_blocks = len(params0["blocks"])
    state = {"params": params0, "data": 0}
    plans, histories, variations = [], [], []

    def snapshot():
        histories.append([list(h) for h in sf.state.cka_history])

    def on_data(ev, boundary):
        server.expire(ev.time)
        batch = bench.scenarios[ev.scenario].train_batches[
            ev.index % len(bench.scenarios[ev.scenario].train_batches)]
        if boundary and sf.reference_params is not None:
            old = {i: h[-1] for i, h in enumerate(sf.state.cka_history)
                   if sf.state.frozen[i] and h}
            sf.scenario_changed(state["params"], api["batch"](batch))
            variations.extend(abs(sf.state.cka_history[i][0] - o) /
                              max(abs(o), 1e-8) for i, o in old.items())
            plans.append(sf.plan().layers)
            snapshot()
        if boundary:
            sf.start_scenario(params0, api["batch"](batch))
        # stand-in for the fine-tuning round of the next slice
        state["params"] = api["perturb"](
            _drift(num_blocks, state["data"], first2))
        state["data"] += 1
        server.publish(state["params"], ev.time)
        frozen = list(sf.state.frozen)
        # the freeze pass's probe FLOPs are charged, as DeviceRuntime.complete
        # charges those of round_finished; a scenario_changed pass adds to
        # cka_flops uncharged, as in the reference
        before = sf.state.cka_flops
        sf.maybe_freeze(state["params"], 1)
        dcka = sf.state.cka_flops - before
        if dcka:
            ledger.charge_probe("cka", *cost.compute_cost(dcka))
        variations.extend(abs(h[-1] - h[-2]) / max(abs(h[-2]), 1e-8)
                          for i, h in enumerate(sf.state.cka_history)
                          if not frozen[i] and len(h) >= 2)
        plans.append(sf.plan().layers)
        snapshot()

    def on_inference(ev):
        cur = sched.scenario_of(ev.stream)
        sc = bench.scenarios[min(ev.scenario, cur) or ev.scenario]
        test = bench.scenarios[max(cur, 1)].test \
            if ev.scenario <= cur else sc.test
        idx = rng.choice(len(test["labels"]), min(BATCH, len(test["labels"])),
                         replace=False)
        server.submit(ev.time, {k: v[idx] for k, v in test.items()})

    server.publish(params0, 0.0)
    sched.run(on_data=on_data, on_inference=on_inference)
    server.flush()
    return {"accs": list(server.accs), "logits": served_logits,
            "plans": plans, "histories": histories,
            "variations": variations, "cka_flops": sf.state.cka_flops,
            "freezes": sf.state.freezes, "unfreezes": sf.state.unfreezes,
            "breakdown": dict(ledger.breakdown),
            "total_time_s": ledger.total_time_s,
            "total_energy_j": ledger.total_energy_j,
            "eval_calls": server.eval_calls}


def _setup(scale):
    jcfg = jax_get_reduced("deit-tiny").replace(use_pallas=True)
    cfg = get_reduced("deit-tiny").replace(use_pallas=True)
    jmodel = jax_build_model(jcfg)
    model = build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, jparams)
    delta = _perturbation(host, seed=11, scale=scale)

    def jax_perturb(mult):
        blocks = [jax.tree.map(lambda p, d, m=m: p + m * d, b, db)
                  for b, db, m in zip(jparams["blocks"], delta["blocks"], mult)]
        head = jax.tree.map(lambda p, d: p + mult[-1] * d, jparams["head"],
                            delta["head"])
        return {**jparams, "blocks": blocks, "head": head}

    def torch_perturb(mult):
        return params_from_jax(jax.tree.map(np.asarray, jax_perturb(mult)),
                               cfg, device="cpu")

    bench_kw = dict(num_classes=10, num_scenarios=4, batches=6,
                    batch_size=BATCH, image_size=cfg.image_size, seed=0)
    tl_kw = dict(num_scenarios=3, batches_per_scenario=6, inferences_total=24,
                 seed=0)
    shift = lambda evs: [dataclasses.replace(e, scenario=e.scenario + 1)
                         for e in evs]
    jax_api = {"scheduler": JaxEventScheduler, "server": JaxInferenceServer,
               "simfreeze": JaxSimFreeze,
               "simfreeze_config": JaxSimFreezeConfig,
               "ledger": JaxCostLedger, "cost": JaxEdgeCostModel,
               "batch": as_jnp, "perturb": jax_perturb}
    torch_api = {"scheduler": EventScheduler, "server": InferenceServer,
                 "simfreeze": SimFreeze, "simfreeze_config": SimFreezeConfig,
                 "ledger": CostLedger, "cost": EdgeCostModel,
                 "batch": lambda b: as_tensor(b, "cpu"),
                 "perturb": torch_perturb}
    return {
        "jax": (jax_api, jmodel, jparams, jax_nc_benchmark(**bench_kw),
                shift(jax_build_timeline(**tl_kw))),
        "torch": (torch_api, model, torch_perturb([0.0] * (cfg.num_layers + 1)),
                  nc_benchmark(**bench_kw), shift(build_timeline(**tl_kw))),
    }


# chosen so that the run freezes and unfreezes with every CKA variation
# more than 2e-3 away from the threshold (the first test checks it)
SCALE = 0.5


@pytest.fixture(scope="module")
def runs():
    setup = _setup(SCALE)
    jax_api, jmodel, jparams, jbench, jevents = setup["jax"]
    api, model, params, bench, events = setup["torch"]
    return {"jax": run_slice(jax_api, jmodel, jparams, jbench, jevents),
            "torch": run_slice(api, model, params, bench, events),
            "torch_window": run_slice(api, model, params, bench, events,
                                      batch_window=15.0)}


def test_slice_freeze_decisions_are_robust(runs):
    # no CKA variation sits near the threshold, so neither package's
    # rounding can flip a decision, and the run does freeze and unfreeze
    var = np.asarray(runs["jax"]["variations"])
    assert np.min(np.abs(var - THRESHOLD)) > 1e-3
    assert runs["jax"]["freezes"] > 0 and runs["jax"]["unfreezes"] > 0


def test_slice_serving_matches_jax(runs):
    a, b = runs["jax"], runs["torch"]
    assert len(a["accs"]) == 24 and a["accs"] == b["accs"]
    assert len(a["logits"]) == len(b["logits"])
    for x, y in zip(a["logits"], b["logits"]):
        np.testing.assert_allclose(y, x, rtol=2e-4, atol=2e-5)


def test_slice_simfreeze_matches_jax(runs):
    a, b = runs["jax"], runs["torch"]
    assert a["plans"] == b["plans"]
    assert (a["freezes"], a["unfreezes"]) == (b["freezes"], b["unfreezes"])
    assert len(a["histories"]) == len(b["histories"])
    for ha, hb in zip(a["histories"], b["histories"]):
        assert [len(h) for h in ha] == [len(h) for h in hb]
        for x, y in zip(ha, hb):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-4)


def test_slice_probe_charges_match_jax(runs):
    a, b = runs["jax"], runs["torch"]
    assert a["cka_flops"] == b["cka_flops"] > 0
    assert a["breakdown"] == b["breakdown"]
    assert (a["total_time_s"], a["total_energy_j"]) == \
        (b["total_time_s"], b["total_energy_j"])


def test_slice_coalesced_serving_equals_per_request(runs):
    one, many = runs["torch"], runs["torch_window"]
    assert many["eval_calls"] < one["eval_calls"]
    assert many["accs"] == one["accs"]
    for x, y in zip(one["logits"], many["logits"]):
        np.testing.assert_allclose(y, x, rtol=2e-4, atol=2e-5)
    assert many["plans"] == one["plans"]


def test_port_plain_routes_match_kernel_routes():
    # the port's use_pallas/use_kernel=False path (plain attention in the
    # model, CKA by the cheaper form) gives the same decisions
    setup = _setup(SCALE)
    api, model, params, bench, events = setup["torch"]
    plain_model = build_model(model.cfg.replace(use_pallas=False), device="cpu")
    with_kernels = run_slice(api, model, params, bench, events)
    plain = run_slice(api, plain_model, params, bench, events,
                      use_kernel=False)
    assert plain["accs"] == with_kernels["accs"]
    assert plain["plans"] == with_kernels["plans"]
    assert plain["cka_flops"] == with_kernels["cka_flops"]
    for ha, hb in zip(plain["histories"], with_kernels["histories"]):
        for x, y in zip(ha, hb):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-4)

