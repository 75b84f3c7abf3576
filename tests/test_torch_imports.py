"""The port stands alone: importing any of its modules loads neither jax
nor the JAX package, and its entry points refuse to run quietly on the CPU
when no GPU is present and none was asked for."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.controller import ETunerController
from repro_torch.checkpoint import ckpt
from repro_torch.examples import (continual_cv, fleet, multi_stream,
                                  quickstart, serve_lm, train_lm)
from repro_torch.harness import common, run, workloads
from repro_torch.models import build_model
from repro_torch.runtime import (RuntimeConfig, SlotConfig, TelemetrySpec,
                                 edgeol_session)
from repro_torch.workloads import presets

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|benchmarks)\b"
    r"|from\s+(jax|repro|benchmarks)(\.|\s))", re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_modules()) >= 70


# the fine-tuning slice's modules, each the counterpart of the JAX
# package's module of the same name
FINE_TUNING = ["optim", "optim.optimizer", "runtime.train_loop",
               "runtime.executor", "core.curvefit", "core.lazytune",
               "core.ood", "core.controller", "core.policies",
               "core.policies.base", "core.policies.trigger",
               "core.policies.freeze", "core.policies.drift",
               "core.policies.publish", "core.policies.stack"]


@pytest.mark.parametrize("name", FINE_TUNING)
def test_fine_tuning_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")
            ).exists() or (ROOT / "src" / "repro" / name.replace(".", "/")
                           / "__init__.py").exists()


# the runtime's composition root and what it needs (copies of jax-free
# modules of the JAX package among them)
RUNTIME_ROOT = ["env", "env.spec", "env.models", "env.runtime",
                "distributed", "distributed.straggler", "obs.spec",
                "core.policies.spec", "core.policies.throttle",
                "runtime.config", "runtime.modelpool", "runtime.device",
                "runtime.fleet", "runtime.continual"]


@pytest.mark.parametrize("name", RUNTIME_ROOT)
def test_runtime_root_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")
            ).exists() or (ROOT / "src" / "repro" / name.replace(".", "/")
                           / "__init__.py").exists()


# the CNNs, the round hooks and BERT
CNN_AND_HOOKS = ["models.cnn", "core.semi", "models.bert"]


@pytest.mark.parametrize("name", CNN_AND_HOOKS)
def test_cnn_and_hook_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")).exists()


# the compiled hot path's workload presets, a copy of the JAX package's
# jax-free `workloads/`
WORKLOADS = ["workloads", "workloads.spec", "workloads.generators",
             "workloads.presets"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")
            ).exists() or (ROOT / "src" / "repro" / name.replace(".", "/")
                           / "__init__.py").exists()


# the paper's SOTA baselines
BASELINES = ["baselines", "baselines.controllers"]


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")
            ).exists() or (ROOT / "src" / "repro" / name.replace(".", "/")
                           / "__init__.py").exists()


# the live telemetry: copies of the JAX package's jax-free `obs/`
OBS = ["obs", "obs.trace", "obs.metrics", "obs.export", "obs.log",
       "obs.telemetry"]


@pytest.mark.parametrize("name", OBS)
def test_obs_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")
            ).exists() or (ROOT / "src" / "repro" / name.replace(".", "/")
                           / "__init__.py").exists()


# the attention LMs: their blocks, configs and the serving example
ATTENTION_LMS = ["models.attention", "models.mlp", "configs.gemma2_2b",
                 "configs.gemma2_27b", "configs.granite_20b",
                 "configs.qwen1_5_32b", "configs.qwen2_vl_72b",
                 "configs.musicgen_medium", "configs.jamba_1_5_large_398b",
                 "configs.qwen3_moe_30b_a3b", "configs.kimi_k2_1t_a32b"]


@pytest.mark.parametrize("name", ATTENTION_LMS)
def test_attention_lm_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")).exists()


# the mamba and MoE blocks of jamba, qwen3-moe and kimi-k2
MAMBA_MOE = ["models.mamba", "models.moe"]


@pytest.mark.parametrize("name", MAMBA_MOE)
def test_mamba_and_moe_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / "src" / "repro" / (name.replace(".", "/") + ".py")).exists()


# LM training: the checkpoint package and the train_lm example
LM_TRAINING = ["checkpoint", "checkpoint.ckpt", "checkpoint.manager",
               "examples.train_lm"]


@pytest.mark.parametrize("name", LM_TRAINING)
def test_lm_training_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    rel = name.replace(".", "/")
    if name.startswith("examples."):
        assert (ROOT / (rel + ".py")).exists()
    else:
        assert (ROOT / "src" / "repro" / (rel + ".py")).exists() or \
            (ROOT / "src" / "repro" / rel / "__init__.py").exists()


# the paper's harness (tables and workloads) and its four CL examples
HARNESS = ["harness", "harness.common", "harness.run", "harness.workloads",
           "harness.trace_report", "examples.quickstart",
           "examples.continual_cv", "examples.fleet", "examples.multi_stream"]
HARNESS_SOURCES = {"harness": "benchmarks", "harness.common":
                   "benchmarks/common.py", "harness.run": "benchmarks/run.py",
                   "harness.workloads": "benchmarks/workloads.py",
                   "harness.trace_report": "benchmarks/trace_report.py"}


@pytest.mark.parametrize("name", HARNESS)
def test_harness_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    assert (ROOT / HARNESS_SOURCES.get(
        name, name.replace(".", "/") + ".py")).exists()


# the distributed layer, the entry-point helpers and the kernels'
# microbenchmark
DISTRIBUTED = ["configs.base", "optim.compression", "distributed.sharding",
               "distributed.collectives", "distributed.elastic", "launch",
               "launch.mesh", "launch.platform", "launch.train",
               "harness.kernels_micro"]
DISTRIBUTED_SOURCES = {"harness.kernels_micro": "benchmarks/kernels_micro.py"}


@pytest.mark.parametrize("name", DISTRIBUTED)
def test_distributed_modules_are_ported(name):
    assert f"repro_torch.{name}" in _modules()
    rel = name.replace(".", "/")
    assert (ROOT / DISTRIBUTED_SOURCES.get(name, f"src/repro/{rel}.py")
            ).exists() or (ROOT / "src" / "repro" / rel).is_dir()


def test_serve_lm_example_is_ported():
    assert "repro_torch.examples.serve_lm" in _modules()
    assert (ROOT / "examples" / "serve_lm.py").exists()


def test_runtime_root_loads_neither_jax_nor_repro():
    names = ['repro_torch.' + n
             for n in RUNTIME_ROOT + CNN_AND_HOOKS + WORKLOADS + BASELINES
             + OBS + ATTENTION_LMS + MAMBA_MOE + LM_TRAINING + HARNESS
             + DISTRIBUTED + ["models.common", "models.transformer", "runtime.serve",
                "core.freeze_plan", "examples.serve_lm"]]
    code = ("import importlib, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_name_neither_jax_nor_repro(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)


def _build():
    build_model(get_reduced("deit-tiny"))


def _bridge():
    params_from_jax({}, get_reduced("deit-tiny"))


def _etuner():
    ETunerController(build_model(get_reduced("deit-tiny")))


def _session():
    edgeol_session(RuntimeConfig(
        slots={"default": SlotConfig(arch="deit-tiny")}))


def _cnn():
    build_model(get_reduced("mobilenetv2"))


def _default_session():
    edgeol_session(RuntimeConfig())


def _bert():
    build_model(get_reduced("bert-base"))


def _mixed_session():
    edgeol_session(RuntimeConfig(
        slots={"cv": SlotConfig(),
               "nlp": SlotConfig(arch="bert-base", benchmark="20news")},
        workload="mixed"))


def _compiled_workload_session():
    edgeol_session(RuntimeConfig(slots={"cv": SlotConfig()},
                                 workload="single-poisson", compiled=True))


def _traced_session():
    edgeol_session(RuntimeConfig(slots={"cv": SlotConfig()},
                                 telemetry=TelemetrySpec(enabled=True)))


def _gemma2():
    build_model(get_config("gemma2-2b"))


def _serve_lm():
    serve_lm.main([])


def _train_lm():
    train_lm.main([])


def _restore():
    ckpt.restore("no-such-checkpoint", {})


def _run_method():
    common.run_method("mobilenetv2", "nc", "immed")


def _tables():
    run.tab3_flops(False)


def _run_workload():
    workloads.run_workload("mobilenetv2", presets()["two-stream"], "immed")


def _sweep():
    workloads.sweep(workload_names=["two-stream"])


def _quickstart():
    quickstart.main([])


def _continual_cv():
    continual_cv.main([])


def _fleet():
    fleet.main([])


def _multi_stream():
    multi_stream.main([])


def _launch_train():
    from repro_torch.launch import platform, train

    platform._bootstrapped = None
    train.main([])


def _host_mesh():
    from repro_torch.launch import mesh

    mesh.make_host_mesh()


def _kernels_micro():
    from repro_torch.harness import kernels_micro

    kernels_micro.run()


@pytest.mark.parametrize("entry", [resolve_device, _build, _bridge, _etuner,
                                   _session, _cnn, _default_session,
                                   _compiled_workload_session, _bert,
                                   _mixed_session, _traced_session, _gemma2,
                                   _serve_lm, _train_lm, _restore,
                                   _run_method, _tables, _run_workload,
                                   _sweep, _quickstart, _continual_cv,
                                   _fleet, _multi_stream, _launch_train,
                                   _host_mesh, _kernels_micro])
def test_entry_points_raise_without_gpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_explicit_cpu_runs_on_cpu():
    model = build_model(get_reduced("deit-tiny"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    images = torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32))
    logits = model.predict(params, {"images": images})
    assert logits.device.type == "cpu" and logits.shape == (2, 10)
