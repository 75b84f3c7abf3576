"""The two-modality `mixed` session in both packages on the CPU: a CV
slot (reduced MobileNetV2, `nc` stream) and an NLP slot (reduced
bert-base, `20news` stream) on one device, each with its own params,
optimizer, replay buffer and controller, under a `ModelPool` built from
the config, mirroring `tests/test_modelpool.py` at its scale (2
scenarios of 3 batches, 8 requests on the CV stream and 4 on the NLP
one, one pretraining epoch, serving batches of 8).

Each session runs unbudgeted and under a budget between the larger
slot's footprint and both together (2.5 MB: one slot resident at a
time, so the pool swaps and charges `t_swap` / `e_swap`). Against the
JAX package's live run of the same config: equal rounds, recompiles,
swaps, controller stats, freeze plans and per-slot and per-stream
rounds, inferences and swaps; accuracies within 1e-6, the validation
curve within 1e-5, ledger totals within 3% (ROADMAP C.5). Within the
port, compiled and eager sessions are exactly equal. Fake-quant on the
CV slot leaves the fp32 NLP slot's numbers as they were.

The port's slot models are built by the config (`_build_model`), their
`init` returning the JAX package's `init(PRNGKey(0))` carried across by
`bridge.params_from_jax`, so both packages start from the same params.
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data import streams as jax_streams
from repro.models import build_model as jax_build_model
from repro.runtime import config as jax_config
from repro.runtime import edgeol_session as jax_edgeol_session
from repro.runtime import executor as jax_executor
from repro.workloads import presets as jax_presets
from repro_torch.bridge import params_from_jax
from repro_torch.data import streams
from repro_torch.runtime import config, executor
from repro_torch.runtime.continual import edgeol_session
from repro_torch.runtime.modelpool import ModelPool
from repro_torch.workloads import presets
from test_torch_compiled import _assert_identical, _PlanSpy

CPU = "cpu"
SCALE = dict(batches_per_scenario=3, inferences=8, num_scenarios=2)
TIGHT_MB = 2.5
BUDGETS = {"free": 0.0, "tight": TIGHT_MB}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(api, budget, *, compiled=False, cv_hooks=()):
    return api.RuntimeConfig(
        workload="mixed", workload_scale=dict(SCALE),
        slots={"cv": api.SlotConfig(arch="mobilenetv2", hooks=cv_hooks),
               "nlp": api.SlotConfig(arch="bert-base", benchmark="20news")},
        seed=0, pretrain_epochs=1, inference_batch=8,
        memory_budget_mb=budget, compiled=compiled)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, jax_build_model(
        jax_get_reduced(arch)).init(jax.random.PRNGKey(0)))


def _reference_init(build):
    """`config._build_model` whose models start from the JAX package's
    params."""
    def built(arch, **kw):
        model = build(arch, **kw)
        params = params_from_jax(_jax_params(arch), model.cfg, device=CPU)
        return dataclasses.replace(model, init=lambda generator: params)

    return built


@functools.lru_cache(maxsize=None)
def _port_run(budget, compiled=False, segment=True, quant=False):
    hooks = (config.HookSpec("fake-quant", {"bits": 8}),) if quant else ()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "_build_model",
                   _reference_init(config._build_model))
        rt = edgeol_session(_config(config, budget, compiled=compiled,
                                    cv_hooks=hooks), device=CPU)
    rt.segment = segment
    with _PlanSpy(executor.FineTuneExecutor) as spy:
        res = rt.run()
    return rt, res, spy.plans


@functools.lru_cache(maxsize=None)
def _jax_run(budget):
    rt = jax_edgeol_session(_config(jax_config, budget))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with _PlanSpy(jax_executor.FineTuneExecutor) as spy:
            res = rt.run()
    return rt, res, spy.plans


COUNTS = ("rounds", "inferences", "swaps")


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_mixed_session_matches_jax(budget):
    rt, port, port_plans = _port_run(BUDGETS[budget])
    jrt, ref, ref_plans = _jax_run(BUDGETS[budget])
    assert sorted(rt.pool.slots) == ["cv", "nlp"]
    assert rt.pool.slot("nlp").model.cfg.family == "encoder"
    for key in ("rounds", "recompiles", "preemptions", "swaps",
                "controller_stats"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port_plans == ref_plans
    assert sorted(port.per_model) == sorted(ref.per_model) == ["cv", "nlp"]
    for slot in ("cv", "nlp"):
        for key in COUNTS:
            assert port.per_model[slot][key] == ref.per_model[slot][key], \
                (slot, key)
        assert port.per_model[slot]["rounds"] > 0
        assert port.per_model[slot]["inferences"] > 0
        np.testing.assert_allclose(port.per_model[slot]["avg_inference_acc"],
                                   ref.per_model[slot]["avg_inference_acc"],
                                   rtol=0, atol=1e-6)
    assert sorted(port.per_stream) == sorted(ref.per_stream) == [0, 1]
    for s in (0, 1):
        for key in ("rounds", "inferences"):
            assert port.per_stream[s][key] == ref.per_stream[s][key]
    assert len(port.inference_accs) == len(ref.inference_accs) > 0
    np.testing.assert_allclose(port.inference_accs, ref.inference_accs,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.val_curve, ref.val_curve, rtol=0,
                               atol=1e-5)
    for key in ("total_time_s", "total_energy_j"):
        assert getattr(port, key) == pytest.approx(getattr(ref, key),
                                                   rel=0.03), key
    assert sorted(port.breakdown) == sorted(ref.breakdown)


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("other", ["per-event", "eager"])
def test_compiled_mixed_session_is_exactly_the_other_path(budget, other):
    _, compiled, plans = _port_run(BUDGETS[budget], compiled=True)
    _, ref, ref_plans = _port_run(BUDGETS[budget],
                                  compiled=other == "per-event",
                                  segment=other != "per-event")
    _assert_identical(compiled, ref)
    assert compiled.swaps == ref.swaps
    assert plans == ref_plans


def test_memory_budget_holds_one_slot_and_charges_swaps():
    """`tests/test_modelpool.py::test_memory_budget_triggers_swap_charges`
    on the port: the tight budget fits either slot alone but not both,
    so serving and rounds swap; the swaps are charged in the breakdown,
    per slot and in the totals. The slots weigh what JAX's weigh."""
    rt, tight, _ = _port_run(TIGHT_MB)
    _, free, _ = _port_run(0.0)
    jrt, _, _ = _jax_run(TIGHT_MB)
    pool = rt.pool
    mem = {n: pool.memory_of(n) for n in ("cv", "nlp")}
    assert mem == pytest.approx({n: jrt.pool.memory_of(n) for n in mem},
                                rel=1e-9)
    assert max(mem.values()) <= pool.memory_budget_mb == TIGHT_MB \
        < sum(mem.values())
    assert free.swaps == 0 and "t_swap" not in free.breakdown
    assert tight.swaps > 0
    assert tight.breakdown["t_swap"] > 0 and tight.breakdown["e_swap"] > 0
    assert sum(v["swaps"] for v in tight.per_model.values()) == tight.swaps
    assert tight.total_time_s > free.total_time_s
    assert tight.total_energy_j > free.total_energy_j
    assert pool.resident_mb <= TIGHT_MB


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_per_model_and_per_stream_attribution_sum_to_totals(budget):
    _, res, _ = _port_run(BUDGETS[budget])
    for key, total in (("time_s", res.total_time_s),
                       ("energy_j", res.total_energy_j),
                       ("rounds", float(res.rounds))):
        np.testing.assert_allclose(
            sum(v[key] for v in res.per_model.values()), total, rtol=1e-9)
    np.testing.assert_allclose(
        sum(v["flops"] for v in res.per_model.values()),
        res.compute_tflops * 1e12, rtol=1e-9)
    n = len(res.inference_accs)
    for view in (res.per_model, res.per_stream):
        assert sum(v["inferences"] for v in view.values()) == n
        weighted = sum(v["avg_inference_acc"] * v["inferences"]
                       for v in view.values()) / n
        np.testing.assert_allclose(res.avg_inference_acc, weighted,
                                   atol=1e-9)
    # stream 0 is the cv slot's, stream 1 the nlp slot's
    for slot, stream in (("cv", 0), ("nlp", 1)):
        assert res.per_model[slot]["inferences"] == \
            res.per_stream[stream]["inferences"]


def test_quantized_cv_slot_beside_fp32_nlp_slot():
    """`tests/test_modelpool.py::test_quantized_slot_beside_fp32_slot`
    on the port: fake-quant binds to the CV slot only; the NLP slot's
    serving keeps the fp32 session's accuracy."""
    rt, quant, _ = _port_run(0.0, quant=True)
    _, fp32, _ = _port_run(0.0)
    assert [type(h).__name__ for h in rt.slot_hooks["cv"]] == \
        ["FakeQuantHook"]
    assert "nlp" not in rt.slot_hooks
    for slot in ("cv", "nlp"):
        assert quant.per_model[slot]["rounds"] > 0
        assert quant.per_model[slot]["inferences"] == \
            fp32.per_model[slot]["inferences"]
    np.testing.assert_allclose(quant.per_model["nlp"]["avg_inference_acc"],
                               fp32.per_model["nlp"]["avg_inference_acc"],
                               atol=1e-9)


def _arrays(bench):
    out = []
    for sc in bench.scenarios:
        out.append(("classes", np.asarray(sc.classes)))
        for b in sc.train_batches:
            out.extend(sorted(b.items()))
        out.extend(sorted(sc.val.items()))
        out.extend(sorted(sc.test.items()))
    return out


@pytest.mark.parametrize("kw", [
    dict(),  # the session's own materialization, below
    dict(num_classes=20, num_scenarios=4, batches=6, batch_size=16,
         seq_len=32, seed=13),  # chip_smoke.py's full-width NLP stream
])
def test_text_benchmark_matches_jax_bitwise(kw):
    if kw:
        pairs = [(streams.text_benchmark(**kw),
                  jax_streams.text_benchmark(**kw))]
    else:
        spec, jspec = presets(seed=0, **SCALE)["mixed"], \
            jax_presets(seed=0, **SCALE)["mixed"]
        got = config.materialize_stream_benchmarks(spec, 0, 8)
        want = jax_config.materialize_stream_benchmarks(jspec, 0, 8)
        assert sorted(got) == sorted(want) == [0, 1]
        assert got[1].modality == "text" and got[1].name == "20news"
        pairs = [(got[i], want[i]) for i in (0, 1)]
    for got, want in pairs:
        assert (got.name, got.num_classes, got.num_scenarios) == \
            (want.name, want.num_classes, want.num_scenarios)
        ga, wa = _arrays(got), _arrays(want)
        assert [k for k, _ in ga] == [k for k, _ in wa]
        for (k, g), (_, w) in zip(ga, wa):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_config_built_pool_builds_a_bert_slot():
    """No session without a device: the config-built pool's models go to
    the named device, the nlp slot a bert-base encoder."""
    rt = edgeol_session(_config(config, 0.0), device=CPU)
    assert isinstance(rt.pool, ModelPool)
    nlp = rt.pool.slot("nlp")
    assert nlp.model.cfg.name == "bert-reduced"
    assert nlp.model.device == torch.device(CPU)
    assert nlp.benchmark.modality == "text"
    assert rt.controller_factory is not None
