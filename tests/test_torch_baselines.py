"""The paper's SOTA baselines (Static, Egeria, SlimFit, RigL, Ekya) run
live in both packages on the CPU, through each package's front door:
`ContinualRuntime.from_config(RuntimeConfig(...), model=, benchmark=,
controller=)` on reduced MobileNetV2 (the runtime's default arch) and
`nc_benchmark` with 3 scenarios of 6 batches of 8, 16 inferences and two
pretraining epochs, as `benchmarks/common.py::run_method` builds them,
with `make_controller`'s parameters (Egeria interval 4, SlimFit interval 4
at threshold 0.05, RigL sparsity 0.5, Ekya windows of 6, `static4`).

Held equal: rounds, recompiles, the freeze plan of every round, the
controller stats, Ekya's `profile_rounds`; accuracies within 1e-6, the
validation curve within 1e-5, ledger totals within 3% (ROADMAP C.5), also
after Ekya's post-run profiling charge (`run_method`'s, applied here);
Egeria's CKA histories within 1e-4. RigL's masks are equal, but for
entries whose |w| ties the decision's boundary within 1e-6 relative, when
both packages decide from the same weights. In the two sessions the
weights part where AdamW amplified rounding (a gradient within 100 eps),
so there an update may also differ at an entry whose own drift reaches
the boundary, or at one it displaced.

RigL mirrors ROADMAP C.9 on both sides, eager and compiled: the
reference's programs read the masks at their trace, once per cache entry
(the port's at their entry's first call), so training stays dense in the
entries pretraining traced and a forward keeps the masks it first saw,
while an eager `predict` applies the live masks. SlimFit walks each unit's
leaves in sorted-key order (`jax.tree.leaves`), which the port's trees
do not keep.

The port's model is injected with an `init` returning the JAX package's
`init(PRNGKey(0))` carried across by `bridge.params_from_jax`.
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jax_common
from benchmarks.common import make_controller as jax_make_controller
from repro import baselines as jax_baselines
from repro.configs import get_reduced as jax_get_reduced
from repro.data.streams import nc_benchmark as jax_nc_benchmark
from repro.models import build_model as jax_build_model
from repro.runtime import config as jax_config
from repro.runtime import continual as jax_continual
from repro.runtime import executor as jax_executor
from repro_torch import baselines, tree_map
from repro_torch.baselines import controllers, harness
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.data.streams import nc_benchmark
from repro_torch.models import build_model
from repro_torch.runtime import config, continual, executor

CPU = "cpu"
BENCH = dict(num_classes=10, num_scenarios=3, batches=6, batch_size=8,
             seed=0)
INFERENCES = 16
METHODS = ("static4", "egeria", "slimfit", "rigl", "ekya")


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
    RuntimeConfig = jax_config.RuntimeConfig
    SlotConfig = jax_config.SlotConfig
    ContinualRuntime = jax_continual.ContinualRuntime
    FineTuneExecutor = jax_executor.FineTuneExecutor
    make_controller = staticmethod(jax_make_controller)
    model = staticmethod(_jax_model)
    bench = staticmethod(lambda: jax_nc_benchmark(**BENCH))
    session = {}


class _Port:
    RuntimeConfig = config.RuntimeConfig
    SlotConfig = config.SlotConfig
    ContinualRuntime = continual.ContinualRuntime
    FineTuneExecutor = executor.FineTuneExecutor
    make_controller = staticmethod(baselines.make_controller)
    model = staticmethod(_port_model)
    bench = staticmethod(lambda: nc_benchmark(**BENCH))
    session = {"device": CPU}


class _Spy:
    """Records the freeze plan of every round an executor class launches,
    and what the RigL-wrapped model's inner loss and predict see."""

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


def _masked(params) -> bool:
    """Do the port's `params` carry a mask: half the entries of a matrix
    exactly zero (a dense matrix has none)?"""
    return any(float((t == 0).float().mean()) > 0.25
               for t in controllers._sorted_leaves(params)
               if t.dim() >= 2 and not t.is_meta)


def _watch(model, ctrl, calls):
    """`model` whose loss and predict note whether they got masked params
    (a jitted reference function runs only while it is traced, on
    tracers: there the masks it would apply are those set when it runs)
    and keep the params predict last saw."""
    def seen(params) -> bool:
        return _masked(params) if hasattr(model, "device") \
            else ctrl.masks is not None

    def loss(params, batch, plan=None):
        calls["loss"].append(seen(params))
        return model.loss(params, batch, plan)

    def predict(params, batch):
        calls["predict"].append(seen(params))
        calls["predict_params"] = params
        return model.predict(params, batch)

    return dataclasses.replace(model, loss=loss, predict=predict)


def _leaves(api, tree) -> list:
    """`tree`'s leaves in `jax.tree.leaves` order, as float32 numpy."""
    if api is _Port:
        return [t.detach().numpy().astype(np.float32)
                for t in controllers._sorted_leaves(tree)]
    return [np.asarray(t, np.float32) for t in jax.tree.leaves(tree)]


def _record_updates(api, ctrl) -> list:
    """(round, params it saw, masks after it) for every RigL round."""
    out, finished = [], ctrl.round_finished

    def round_finished(iters, val_acc, params):
        seen = _leaves(api, params)
        finished(iters, val_acc, params)
        out.append((ctrl._rounds, seen, _leaves(api, ctrl.masks)))

    ctrl.round_finished = round_finished
    return out


@functools.lru_cache(maxsize=None)
def _run(api, method, compiled=False, inferences=INFERENCES):
    model = api.model()
    calls = {"loss": [], "predict": [], "predict_params": None}
    ctrl = api.make_controller(model, method)
    if method == "rigl":
        ctrl.model = _watch(model, ctrl, calls)
        model = ctrl.wrap_model()
        calls["updates"] = _record_updates(api, ctrl)
    rt = api.ContinualRuntime.from_config(
        api.RuntimeConfig(slots={"default": api.SlotConfig()}, seed=0,
                          pretrain_epochs=2, compiled=compiled),
        model=model, benchmark=api.bench(), controller=ctrl, **api.session)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with _Spy(api.FineTuneExecutor) as spy:
            res = rt.run(inferences_total=inferences)
    time_s, energy_j = res.total_time_s, res.total_energy_j
    if api is _Port:
        time_s, energy_j = baselines.profiling_charge(ctrl, res.rounds,
                                                      time_s, energy_j)
    elif method == "ekya":  # run_method's profiling charge
        energy_j += ctrl.profile_rounds * 0.2 * energy_j / max(res.rounds, 1)
        time_s += ctrl.profile_rounds * 0.2 * time_s / max(res.rounds, 1)
    return {"res": res, "plans": spy.plans, "ctrl": ctrl, "calls": calls,
            "time_s": time_s, "energy_j": energy_j, "rt": rt}


def test_make_controller_matches_the_harness():
    """`baselines.make_controller` builds each method as
    `benchmarks/common.py::make_controller` does: the baselines with its
    parameters, the paper methods from its policy stacks (the port's
    SimFreeze spec adds `use_kernel`, off by default)."""
    for method in METHODS:
        want = jax_make_controller(_jax_model(), method)
        got = baselines.make_controller(_port_model(), method)
        assert type(got).__name__ == type(want).__name__
        keys = {k for k, v in vars(want).items()
                if isinstance(v, (bool, int, float, tuple))}
        assert {k: getattr(got, k) for k in keys} == \
            {k: getattr(want, k) for k in keys}, method
    for method in jax_common.PAPER_METHODS:
        want = jax_common.method_policies(method).to_dict()
        got = harness.method_policies(method).to_dict()
        assert got == want, method
        kernel = harness.method_policies(method, use_kernel=True).freeze
        assert kernel.params.get("use_kernel") is \
            (True if kernel.name == "simfreeze" else None)
        assert type(baselines.make_controller(_port_model(), method)) \
            .__name__ == type(jax_make_controller(_jax_model(),
                                                  method)).__name__
    with pytest.raises(KeyError):
        baselines.make_controller(_port_model(), "nonesuch")
    # `run_method`'s Ekya charge: a fifth of a mean round per profiling
    # round; nothing for a controller that does not profile
    ekya = baselines.make_controller(_port_model(), "ekya")
    ekya.profile_rounds = 3
    assert baselines.profiling_charge(ekya, 4, 10.0, 20.0) == \
        (10.0 + 3 * 0.2 * 10.0 / 4, 20.0 + 3 * 0.2 * 20.0 / 4)
    static = baselines.make_controller(_port_model(), "static4")
    assert baselines.profiling_charge(static, 0, 10.0, 20.0) == (10.0, 20.0)


@pytest.mark.parametrize("method", METHODS)
def test_baseline_session_matches_reference(method):
    port, ref = _run(_Port, method), _run(_Jax, method)
    p, r = port["res"], ref["res"]
    for key in ("rounds", "recompiles", "probes", "controller_stats"):
        assert getattr(p, key) == getattr(r, key), key
    assert port["plans"] == ref["plans"]
    assert len(p.inference_accs) == len(r.inference_accs) == INFERENCES
    np.testing.assert_allclose(p.inference_accs, r.inference_accs, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(p.val_curve, r.val_curve, rtol=0, atol=1e-5)
    for key in ("time_s", "energy_j"):
        assert port[key] == pytest.approx(ref[key], rel=0.03), key
    assert p.rounds > 0
    if method == "ekya":
        assert port["ctrl"].profile_rounds == ref["ctrl"].profile_rounds > 0


def test_egeria_histories_match_and_freeze_front_to_back():
    port, ref = _run(_Port, "egeria")["ctrl"], _run(_Jax, "egeria")["ctrl"]
    assert [len(h) for h in port._hist] == [len(h) for h in ref._hist]
    assert any(port._hist)
    for got, want in zip(port._hist, ref._hist, strict=True):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    flags = list(port.plan.layers)
    first_active = flags.index(False) if False in flags else len(flags)
    assert not any(flags[first_active:])
    # the reference features stay tensors on the params' device, in fp32
    assert all(isinstance(f, torch.Tensor) and f.dtype == torch.float32
               for f in port._ref_feats)


def test_egeria_probes_take_plain_cka(monkeypatch):
    """Egeria calls `cka` without `use_kernel` in both packages, so its
    probes never reach the CKA kernel's wrapper, `use_pallas` or not."""
    from repro_torch.kernels.cka import ops as cka_ops

    seen = []
    monkeypatch.setattr(controllers, "_cka",
                        lambda x, y, **kw: seen.append(kw) or
                        torch.tensor(0.5))
    monkeypatch.setattr(cka_ops, "cka_terms",
                        lambda *a, **k: pytest.fail("kernel wrapper called"))
    model = _port_model()
    ctrl = baselines.EgeriaController(model, interval=1)
    bench = nc_benchmark(**BENCH)
    probe = tree_map(torch.from_numpy, bench.scenarios[1].train_batches[0])
    params = model.init(None)
    ctrl.start_scenario(params, probe)
    ctrl.round_finished(1, 0.5, params)
    assert seen and all(kw == {} for kw in seen)


def test_slimfit_walks_leaves_in_sorted_key_order():
    tree = {"w": np.arange(3.0), "b": {"z": np.ones(2), "a": np.zeros(1)}}
    leaves = controllers._sorted_leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(leaves) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, want))
    order = []
    out = controllers._sorted_map(lambda a: order.append(a.size) or a, tree)
    assert order == [1, 2, 3] and list(out) == ["w", "b"]
    # the reduced MobileNetV2's units and head are what `_unit_leaves`
    # keys on, with one freeze unit each
    ctrl = _run(_Port, "slimfit")["ctrl"]
    params = _port_model().init(None)
    assert len(ctrl._unit_leaves(params)) == ctrl.n_units


@pytest.mark.parametrize("arch", ["deit-tiny", "resnet50", "bert-base"])
def test_slimfit_finds_every_paper_models_units(arch):
    """The bridged params of each paper model carry the keys
    `_unit_leaves` reads, one unit a freeze unit, none missing."""
    jcfg = jax_get_reduced(arch)
    jparams = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    cfg = get_reduced(arch)
    model = build_model(cfg, device=CPU)
    params = params_from_jax(jparams, cfg, device=CPU)
    got = baselines.SlimFitController(model)._unit_leaves(params)
    want = jax_baselines.SlimFitController(
        jax_build_model(jcfg))._unit_leaves(jparams)
    assert len(got) == len(want) == model.num_freeze_units
    for g, w in zip(got, want):
        # leaf by leaf in the same order (ViT's patch kernel is HWIO in
        # JAX and the matrix of the same entries in the port)
        assert [t.numel() for t in controllers._sorted_leaves(g)] == \
            [np.size(t) for t in jax.tree.leaves(w)]


def _edge(mag: np.ndarray, prev, k_keep: int):
    """The magnitude at a RigL decision's boundary and each entry's rank
    from it: the init keeps the `k_keep` largest (rank 0 the largest);
    an update drops the smallest tenth of the entries `prev` keeps
    active (rank 0 the smallest)."""
    if prev is None:
        order = np.argsort(-mag, kind="stable")
        k = k_keep
    else:
        order = np.flatnonzero(prev)[np.argsort(mag[prev > 0],
                                                kind="stable")]
        k = order.size // 10
    rank = np.full(mag.size, -1)
    rank[order] = np.arange(order.size)
    return mag[order[k]], rank, k


def test_rigl_masks_match_reference_on_the_same_weights():
    """RigL's decisions on the same weights: both packages' controllers
    take the reference session's params round by round (the port's
    carried across by `bridge.params_from_jax`), and their masks, the
    init and every update, are equal but for entries whose |w| ties the
    decision's boundary to within 1e-6 relative."""
    updates = _run(_Jax, "rigl")["calls"]["updates"]
    treedef = jax.tree.structure(_jax_params())
    cfg = get_reduced("mobilenetv2")
    jc = jax_make_controller(_jax_model(), "rigl")
    pc = baselines.make_controller(_port_model(), "rigl")
    decisions, prev = 0, None
    for r, seen, _ in updates:
        jtree = jax.tree.unflatten(treedef, seen)
        jc.round_finished(1, 0.5, jtree)
        pc.round_finished(1, 0.5, params_from_jax(jtree, cfg, device=CPU))
        got, want = _leaves(_Port, pc.masks), _leaves(_Jax, jc.masks)
        decide = prev is None or r % pc.update_every == 0
        for i, (g, w, p) in enumerate(zip(got, want, seen, strict=True)):
            off = np.flatnonzero(g.ravel() != w.ravel())
            if off.size:
                mag = np.abs(p.ravel())
                edge, _, _ = _edge(mag, None if prev is None
                                   else prev[i].ravel(),
                                   int(p.size * (1 - pc.sparsity)))
                assert decide and np.all(
                    np.abs(mag[off] - edge) <= 1e-6 * edge), (r, i)
        decisions += decide
        prev = want
    assert decisions >= 2  # the init and an update


def test_adamw_parts_the_frameworks_below_eps():
    """Why RigL's session-level masks can part (next test): one AdamW
    step from the same params on the same batch moves a weight by
    lr * g / (|g| + eps) (bias-corrected, step 1), and where |g| is
    within a hundred eps that step turns the frameworks' rounding-level
    gradient differences into differences of a sizable fraction of lr.
    Every coordinate whose gradient is at least 100 eps in both agrees to
    float32 rounding; the others part by what that formula predicts."""
    from repro.core.freeze_plan import LayerFreezePlan as JaxPlan
    from repro.optim.optimizer import AdamWConfig as JaxAdamW
    from repro.runtime.train_loop import TrainStepCache as JaxSteps
    from repro.runtime.train_loop import \
        make_optimizer_state as jax_optimizer_state
    from repro_torch.core.freeze_plan import LayerFreezePlan
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import (TrainStepCache, as_tensor,
                                                make_optimizer_state)

    jm, pm = _jax_model(), _port_model()
    jcfg, cfg = JaxAdamW(), AdamWConfig()
    assert (cfg.lr, cfg.eps, cfg.b1) == (jcfg.lr, jcfg.eps, jcfg.b1)
    batch = nc_benchmark(**BENCH).scenarios[0].train_batches[0]
    jp, pp = jm.init(jax.random.PRNGKey(0)), pm.init(None)
    dense = (False,) * pm.num_freeze_units
    jp, js, _ = JaxSteps(jm, jcfg).get(JaxPlan(layers=dense))(
        jp, jax_optimizer_state(jm, jcfg, jp),
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    pp, ps, _ = TrainStepCache(pm, cfg).get(LayerFreezePlan(layers=dense))(
        pp, make_optimizer_state(pm, cfg, pp), as_tensor(batch, CPU))

    def flat(api, tree):
        return np.concatenate([t.ravel() for t in _leaves(api, tree)])

    dw = np.abs(flat(_Port, pp) - flat(_Jax, jp))
    # the clipped gradient each optimizer took: m = (1 - b1) g at step 1
    gp, gj = flat(_Port, ps.m) / (1 - cfg.b1), flat(_Jax, js.m) / (1 - cfg.b1)
    small = np.minimum(np.abs(gp), np.abs(gj)) < 100 * cfg.eps
    assert dw[~small].max() <= 1e-7
    assert dw[small].max() > 0.5 * cfg.lr  # not rounding
    want = cfg.lr * np.abs(gp / (np.abs(gp) + cfg.eps)
                           - gj / (np.abs(gj) + cfg.eps))
    np.testing.assert_allclose(dw, want, rtol=0, atol=2e-7)


def test_rigl_masks_match_reference_but_for_ties():
    """RigL's masks in the two sessions, round by round. The weights each
    decides from part where AdamW amplified rounding (previous test): a
    coordinate whose gradient once sat within 100 eps carries a drift of
    up to a fraction of lr a step, the rest agree to rounding. So the
    init's masks are equal, and an update may differ only at an entry
    whose own drift reaches the reference's boundary, or at one that such
    an entry displaced: within as many ranks of the port's boundary as
    there are drifted entries in its leaf. The regrow draws, from the
    shared RNG stream, coincide because the masks before them do."""
    port, ref = _run(_Port, "rigl"), _run(_Jax, "rigl")
    pc, rc = port["ctrl"], ref["ctrl"]
    assert pc._rounds == rc._rounds >= pc.update_every  # masks updated
    flips, prev = 0, None
    for (r, pw, pm), (rr, jw, jm) in zip(port["calls"]["updates"],
                                         ref["calls"]["updates"],
                                         strict=True):
        assert r == rr and len(pm) == len(jm) == len(pw)
        if prev is None:  # the init
            assert all(np.array_equal(a, b) for a, b in zip(pm, jm)), r
        elif r % pc.update_every:
            # no decision this round: both packages keep their masks
            assert all(np.array_equal(a, b) for a, b in zip(pm, prev[0]))
            assert all(np.array_equal(a, b) for a, b in zip(jm, prev[1]))
        else:
            for i, (g, w, p, q) in enumerate(zip(pm, jm, pw, jw,
                                                 strict=True)):
                assert np.array_equal(prev[0][i], prev[1][i]), (r, i)
                off = np.flatnonzero(g.ravel() != w.ravel())
                if not off.size:
                    continue
                mag, ref_mag = np.abs(p.ravel()), np.abs(q.ravel())
                active = prev[0][i].ravel()
                ref_edge, _, _ = _edge(ref_mag, active, 0)
                _, rank, k = _edge(mag, active, 0)
                drifted = np.abs(mag[off] - ref_mag[off]) \
                    >= np.abs(ref_mag[off] - ref_edge)
                n = int(drifted.sum())
                assert n, (r, i)
                displaced = off[~drifted]
                assert np.all(np.abs(rank[displaced] - k) <= n), (r, i)
                assert off.size <= max(2, p.size // 1000), (r, i, off.size)
                flips += off.size
        prev = (pm, jm)
    dens = [m.mean() for m in port["calls"]["updates"][-1][2] if m.ndim >= 2]
    assert 0.35 < float(np.mean(dens)) < 0.65
    assert pc.flops_scale == rc.flops_scale < 1.0
    assert flips <= 8


@pytest.mark.parametrize("api,compiled",
                         [(_Port, False), (_Jax, False), (_Port, True),
                          (_Jax, True)],
                         ids=["port", "jax", "port-compiled",
                              "jax-compiled"])
def test_rigl_trains_dense_and_serves_masked(api, compiled):
    """ROADMAP C.9 pinned on both sides: the reference's jitted programs
    read the masks at their trace, once per cache entry, and the port's
    keep the masks their entry's first call saw.

    Eager: pretraining traced the one train-step entry before the masks
    existed, so training stays dense (the reference runs the loss only
    while tracing; the port runs it every step), while predict, run
    eagerly, is masked once the masks exist.

    Compiled (40 inferences): a round of three batches meets a new fused
    bucket after the masks exist, and that entry trains masked, the
    others dense; the forward traced for validation before the masks
    stays dense, the serving forward traced after keeps the masks it
    first saw. The port's session equals the reference's."""
    inferences = 40 if compiled else INFERENCES
    run = _run(api, "rigl", compiled, inferences)
    calls, ctrl = run["calls"], run["ctrl"]
    rounds = run["res"].rounds
    assert ctrl.masks is not None and calls["loss"] and calls["predict"]
    if compiled:
        assert any(calls["loss"]) and not all(calls["loss"])
        assert any(calls["predict"]) and not all(calls["predict"])
        if api is _Jax:  # traced per entry, not run per call
            assert len(calls["loss"]) < rounds
            assert len(calls["predict"]) < rounds
            return
        ref = _run(_Jax, "rigl", compiled, inferences)
        p, r = run["res"], ref["res"]
        assert p.rounds == r.rounds and p.recompiles == r.recompiles
        np.testing.assert_allclose(p.inference_accs, r.inference_accs,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(p.val_curve, r.val_curve, rtol=0,
                                   atol=1e-5)
        entries = ctrl.traced_masks.items()
        # the forwards, in the order first met, see what the reference's
        # predict traces saw; as many train entries are masked as the
        # reference's loss traces (its extra one, `flops`, is dense)
        assert [m is not None for k, m in entries if k[0] == "forward"] \
            == ref["calls"]["predict"]
        assert sum(m is not None for k, m in entries if k[0] == "multi") \
            == sum(ref["calls"]["loss"]) > 0
        return
    if api is _Jax:
        assert len(calls["loss"]) <= 2 < rounds  # traced, not run per step
    else:
        assert len(calls["loss"]) > rounds
        assert set(ctrl.traced_masks.values()) == {None}
    assert not any(calls["loss"])
    assert sum(calls["predict"]) > rounds
    # the params predict last saw are masked: zero wherever the mask is
    to_np = (lambda t: t.detach().numpy()) if api is _Port else np.asarray
    leaves = controllers._sorted_leaves if api is _Port else jax.tree.leaves
    for p, m in zip(leaves(calls["predict_params"]), leaves(ctrl.masks)):
        p, m = to_np(p), to_np(m)
        assert np.all(p[m == 0] == 0)
