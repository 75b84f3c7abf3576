"""The port's tables harness (`repro_torch.harness.common`, `.run`)
against the reference's (`benchmarks/common.py`, `benchmarks/run.py`),
live in both packages on the CPU.

- `method_policies` and `make_controller`: the same policy stacks for
  every paper method and both triggers, the same controller classes, the
  same error text.
- `run_method` on reduced MobileNetV2, `nc`, 2 scenarios of 4 batches and
  10 inferences (its two pretraining epochs): `immed` and `etuner` give
  equal rounds, accuracies within 1e-6, and time and energy within rel
  3%; `tflops` within rel 3% of the reference's counted as the port's
  count is held (XLA's count less its recomputation, ROADMAP C.8). One
  row each with `quant_bits=8` (its accuracy within one served example,
  ROADMAP C.16; served the reference's params at every call, at four
  seeds and sizes, the port predicts every example as the reference
  does and its accuracy is the reference's within 1e-6),
  `unlabeled=0.9` (the port's SimSiam hook
  given the reference's augmentation draws and head, ROADMAP C.7),
  `method="ekya"` (its profiling charge included), `data_dist="uniform"`,
  and a `20news` row on reduced bert-base, held the same way.
- The table functions, with `run_method` replaced by a recorder in both
  packages: the same calls (quick and `--full`), and, fed the same rows,
  the same derived columns and printed lines; `main` keeps going past a
  table that raises.

The port's models are built with an `init` returning the JAX package's
`init(PRNGKey(0))` carried across by `bridge.params_from_jax`; the
reference's models are built once an architecture, so its sessions share
their compiled steps.
"""
import contextlib
import dataclasses
import functools
import io
import warnings
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jax_common
from benchmarks import run as jax_run
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.runtime import inference as jax_inference
from repro.runtime import train_loop as jax_train_loop
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.harness import common, run
from repro_torch.models import build_model
from repro_torch.runtime import executor, inference, train_loop
from test_torch_cnn import reference_draws, reference_head
from test_torch_train import xla_less_recomputation

CPU = "cpu"
SCALE = dict(scenarios=2, batches=4, inferences=10)
REL = 0.03
METHODS = common.PAPER_METHODS + ("egeria", "slimfit", "rigl", "ekya",
                                  "static4")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    return jax_build_model(jax_get_reduced(arch))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray,
                        _jax_model(arch).init(jax.random.PRNGKey(0)))


ARCH = {get_reduced(a).name: a for a in ("mobilenetv2", "bert-base")}


def _port_build_model(cfg, device=None):
    """The port's model of `cfg`, starting from the JAX init."""
    params = params_from_jax(_jax_params(ARCH[cfg.name]), cfg, device=CPU)
    return dataclasses.replace(build_model(cfg, device=device),
                               init=lambda generator: params)


def _jax_build(cfg):
    assert cfg == jax_get_reduced(ARCH[cfg.name])
    return _jax_model(ARCH[cfg.name])


class _SimSiamDraws:
    """The port's SimSiam hooks take the reference's draws and head."""

    def __enter__(self):
        self._init = executor.SimSiamHook.__init__
        init = self._init

        def patched(hook, *args, **kwargs):
            init(hook, *args, **kwargs)
            hook.draws, hook.init_head = reference_draws, reference_head

        executor.SimSiamHook.__init__ = patched

    def __exit__(self, *exc):
        executor.SimSiamHook.__init__ = self._init


@functools.lru_cache(maxsize=None)
def _port_row(arch, bench, method, **kw):
    with warnings.catch_warnings(), _SimSiamDraws(), \
            mock.patch.object(common, "build_model", _port_build_model):
        warnings.simplefilter("ignore")
        return common.run_method(arch, bench, method, device=CPU,
                                 **dict(SCALE, **kw))


@functools.lru_cache(maxsize=None)
def _jax_row(arch, bench, method, counted=False, **kw):
    """The reference's row; `counted` counts its steps as the port's
    count is held (`xla_less_recomputation`)."""
    with warnings.catch_warnings(), \
            mock.patch.object(jax_common, "build_model", _jax_build), \
            (xla_less_recomputation() if counted
             else contextlib.nullcontext()):
        warnings.simplefilter("ignore")
        return jax_common.run_method(arch, bench, method,
                                     **dict(SCALE, **kw))


# ---------------------------------------------------------------------------
# policy stacks and controllers


@pytest.mark.parametrize("trigger", ["default", "priority-weighted",
                                     "nonesuch"])
@pytest.mark.parametrize("method", common.PAPER_METHODS)
def test_method_policies_match_reference(method, trigger):
    try:
        want = jax_common.method_policies(method, trigger).to_dict()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            common.method_policies(method, trigger)
        assert str(got.value) == str(e)
        return
    plain = common.method_policies(method, trigger).to_dict()
    kernel = common.method_policies(method, trigger,
                                    use_kernel=True).to_dict()
    if method in ("simfreeze", "etuner"):
        # SimFreeze's CKA route is the port's own parameter
        assert kernel["freeze"].pop("use_kernel") is True
    assert plain == kernel == want


@pytest.mark.parametrize("trigger", ["default", "priority-weighted"])
@pytest.mark.parametrize("method", METHODS + ("nonesuch",))
def test_make_controller_matches_reference(method, trigger):
    jmodel = _jax_model("mobilenetv2")
    model = _port_build_model(get_reduced("mobilenetv2"), device=CPU)
    try:
        want = jax_common.make_controller(jmodel, method, trigger)
    except (ValueError, KeyError) as e:
        with pytest.raises(type(e)) as got:
            common.make_controller(model, method, trigger)
        assert str(got.value) == str(e)
        return
    got = common.make_controller(model, method, trigger)
    assert type(got).__name__ == type(want).__name__


# ---------------------------------------------------------------------------
# run_method's rows


def _hold_row(got, want, counted=None, acc_atol=1e-6):
    assert set(got) == set(want)
    for k in ("arch", "bench", "method", "rounds", "seeds"):
        assert got[k] == want[k], k
    assert got["acc"] == pytest.approx(want["acc"], abs=acc_atol)
    assert got["acc_std"] == pytest.approx(want["acc_std"], abs=1e-6)
    for k in ("time_s", "energy_j"):
        assert got[k] == pytest.approx(want[k], rel=REL), k
    if counted is not None:
        assert got["tflops"] == pytest.approx(counted["tflops"], rel=REL)


@pytest.mark.parametrize("method", ["immed", "etuner"])
def test_run_method_matches_reference(method):
    got = _port_row("mobilenetv2", "nc", method)
    want = _jax_row("mobilenetv2", "nc", method)
    counted = _jax_row("mobilenetv2", "nc", method, counted=True)
    _hold_row(got, want, counted)
    # XLA's whole count is the larger by its recomputation
    assert want["tflops"] > counted["tflops"]
    print(f"{method}: port {got}\nreference {want}\n"
          f"reference counted as the port {counted['tflops']}")


ROWS = {"quant": ("mobilenetv2", "nc", "etuner", dict(quant_bits=8)),
        "unlabeled": ("mobilenetv2", "nc", "immed", dict(unlabeled=0.9)),
        "ekya": ("mobilenetv2", "nc", "ekya", {}),
        "uniform": ("mobilenetv2", "nc", "etuner",
                    dict(data_dist="uniform", inf_dist="uniform")),
        "20news": ("bert-base", "20news", "etuner", {})}


#: one served example of the run's 10 requests of 16: fake quantization
#: rounds w / scale to the nearest of 255 steps, so entries that the two
#: frameworks trained apart by fp32 rounding are served a step apart, and
#: a few examples' predictions flip (ROADMAP C.16). Served the
#: reference's params, the port predicts every example as the reference
#: does (`test_fake_quant_rows_part_only_by_the_params_served`).
ONE_EXAMPLE = 1 / (SCALE["inferences"] * 16)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_run_method_rows_match_reference(name):
    arch, bench, method, kw = ROWS[name]
    if name == "quant":  # the run the witness test below reads
        got, want, _, _ = _quant_served(0, SCALE["scenarios"],
                                        SCALE["batches"])
    else:
        got = _port_row(arch, bench, method, **kw)
        want = _jax_row(arch, bench, method, **kw)
    _hold_row(got, want, acc_atol=ONE_EXAMPLE + 1e-9 if name == "quant"
              else 1e-6)


class _Served:
    """While installed, records each served call of a package's
    `InferenceServer` (its model, params, batch and accuracy)."""

    def __init__(self, module, evaluate):
        self.module, self.evaluate, self.calls = module, evaluate, []

    def __enter__(self):
        def recorded(model, params, batch):
            acc, logits = self.evaluate(model, params, batch)
            self.calls.append((model, params, batch, acc))
            return acc, logits

        self.module.evaluate = recorded
        return self

    def __exit__(self, *exc):
        self.module.evaluate = self.evaluate


@functools.lru_cache(maxsize=None)
def _quant_served(seed, scenarios, batches):
    """The `quant_bits=8` etuner row in both packages at `seed` and size,
    with every served call recorded."""
    kw = dict(SCALE, scenarios=scenarios, batches=batches, seeds=(seed,),
              quant_bits=8)

    def port_model(cfg, device=None):
        params = params_from_jax(jax.tree.map(np.asarray, _jax_model(
            ARCH[cfg.name]).init(jax.random.PRNGKey(seed))), cfg, device=CPU)
        return dataclasses.replace(build_model(cfg, device=device),
                                   init=lambda generator: params)

    with warnings.catch_warnings(), \
            _Served(inference, train_loop.evaluate) as port, \
            mock.patch.object(common, "build_model", port_model):
        warnings.simplefilter("ignore")
        got = common.run_method("mobilenetv2", "nc", "etuner", device=CPU,
                                **kw)
    with warnings.catch_warnings(), \
            _Served(jax_inference, jax_train_loop.evaluate) as ref, \
            mock.patch.object(jax_common, "build_model", _jax_build):
        warnings.simplefilter("ignore")
        want = jax_common.run_method("mobilenetv2", "nc", "etuner", **kw)
    return got, want, port.calls, ref.calls


@pytest.mark.parametrize("seed,scenarios,batches",
                         [(0, 2, 4), (1, 2, 4), (2, 2, 4), (0, 3, 4)])
def test_fake_quant_rows_part_only_by_the_params_served(seed, scenarios,
                                                        batches):
    """ROADMAP C.16 at four seeds and sizes (the first is the row held
    above). Served the reference's own params at every call (carried
    across by `bridge.params_from_jax`), the port's fake-quantized model
    predicts every example as the reference did, and its accuracy,
    averaged as a row's is, is the reference row's within 1e-6: the hook
    and the serving agree exactly, and the rows part only by the params
    each package trained. Served its own params, the port's row is
    within one served example of the reference's."""
    got, want, port, ref = _quant_served(seed, scenarios, batches)
    assert len(port) == len(ref) == SCALE["inferences"]
    cfg = get_reduced("mobilenetv2")
    witnessed, flips = [], 0
    for (model, params, batch, _), (jmodel, jparams, jbatch, _) in zip(
            port, ref):
        np.testing.assert_array_equal(batch["labels"].numpy(),
                                      np.asarray(jbatch["labels"]))
        jlogits = np.asarray(jmodel.predict(jparams, jbatch))
        bridged = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                  device=CPU)
        acc, logits = train_loop.evaluate(model, bridged, batch)
        np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))
        witnessed.append(acc)
        own = train_loop.evaluate(model, params, batch)[1]
        flips += int((own.argmax(-1) != jlogits.argmax(-1)).sum())
    assert np.mean([a for *_, a in ref]) == want["acc"]
    assert float(np.mean(witnessed)) == pytest.approx(want["acc"], abs=1e-6)
    gap = abs(got["acc"] - want["acc"]) / ONE_EXAMPLE
    print(f"seed {seed}, {scenarios} x {batches}: {flips} examples served "
          f"apart, rows {gap:.3f} examples apart")
    assert gap < 1 + 1e-6
    assert got["rounds"] == want["rounds"]


def test_run_method_kernels_give_the_plain_row():
    """`use_pallas` routes the models' and SimFreeze's kernels, whose
    wrappers take their plain versions on the CPU: the same row."""
    assert _port_row("mobilenetv2", "nc", "etuner", use_pallas=True) == \
        _port_row("mobilenetv2", "nc", "etuner")


# ---------------------------------------------------------------------------
# the table functions


class _Recorder:
    """Stands in for `run_method`: records each call and returns a row
    whose figures are drawn from the call itself, the same in both
    packages."""

    def __init__(self):
        self.calls = []

    def __call__(self, arch, bench_name, method, **kw):
        kw.pop("device", None)
        self.calls.append((arch, bench_name, method, sorted(kw.items())))
        rng = np.random.default_rng(len(self.calls))
        return {"arch": arch, "bench": bench_name, "method": method,
                "acc": float(rng.uniform(0.3, 0.9)), "acc_std": 0.0,
                "time_s": float(rng.uniform(5, 50)),
                "energy_j": float(rng.uniform(50, 500)),
                "tflops": float(rng.uniform(0.1, 1.0)),
                "rounds": float(rng.integers(1, 20)),
                "seeds": len(kw.get("seeds", (0,)))}


def _tables(module, common_module, name, full):
    rec, saved, out = _Recorder(), {}, io.StringIO()
    with mock.patch.object(common_module, "run_method", rec), \
            mock.patch.object(common_module, "save_rows",
                              lambda n, rows: saved.setdefault(n, rows)), \
            contextlib.redirect_stdout(out):
        rows = getattr(module, name)(full)
    return rec.calls, rows, saved, out.getvalue()


TABLES = sorted(set(jax_run.TABLES) - {"roofline"})


@pytest.mark.parametrize("full", [False, True], ids=["quick", "full"])
@pytest.mark.parametrize("table", TABLES)
def test_table_calls_and_columns_match_reference(table, full):
    fn = jax_run.TABLES[table].__name__
    assert run.TABLES[table].__name__ == fn
    want = _tables(jax_run, jax_common, fn, full)
    got = _tables(run, common, fn, full)
    assert got[0] == want[0]  # the same run_method calls
    assert got[1] == want[1]  # rows with the same derived columns
    assert got[2] == want[2]  # saved under the same names
    assert got[3] == want[3]  # the same printed lines


def test_tables_leave_out_only_the_roofline():
    """The roofline table, once left out, came with the dry run: the
    port's tables are the reference's, every one (the roofline table's
    rows are held in tests/test_torch_dryrun.py)."""
    assert set(run.TABLES) == set(jax_run.TABLES)
    assert run.TABLES["roofline"].__name__ == \
        jax_run.TABLES["roofline"].__name__


def test_main_reports_a_failing_table_and_goes_on(capsys):
    def boom(*args, **kwargs):
        raise RuntimeError("out of batteries")

    rec = _Recorder()
    with mock.patch.object(common, "run_method", rec), \
            mock.patch.object(common, "save_rows", lambda n, rows: n), \
            mock.patch.object(run, "tab2_accuracy", boom), \
            mock.patch.dict(run.TABLES, {"tab2": boom}):
        run.main(["--only", "tab2,tab3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "tab2,ERROR,RuntimeError: out of batteries" in out
    assert "# === tab3 ===" in out and len(rec.calls) == 2
    assert out[-1].startswith("# total wall:")


def test_save_rows_writes_results_torch(tmp_path):
    with mock.patch.object(common, "RESULTS_DIR", str(tmp_path / "r")):
        path = common.save_rows("tab0", [{"a": 1}])
    assert path == str(tmp_path / "r" / "tab0.json")
    assert open(path).read() == '[\n {\n  "a": 1\n }\n]'
    assert common.RESULTS_DIR.endswith("results_torch")
