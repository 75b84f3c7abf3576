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
from repro_torch.configs import get_reduced
from repro_torch.core.controller import ETunerController
from repro_torch.models import build_model
from repro_torch.runtime import RuntimeConfig, SlotConfig, edgeol_session

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                       re.MULTILINE)


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
    assert len(_modules()) >= 69


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


# the CNNs and the round hooks
CNN_AND_HOOKS = ["models.cnn", "core.semi"]


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


def test_runtime_root_loads_neither_jax_nor_repro():
    names = ['repro_torch.' + n
             for n in RUNTIME_ROOT + CNN_AND_HOOKS + WORKLOADS]
    code = ("import importlib, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
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


def _compiled_workload_session():
    edgeol_session(RuntimeConfig(slots={"cv": SlotConfig()},
                                 workload="single-poisson", compiled=True))


@pytest.mark.parametrize("entry", [resolve_device, _build, _bridge, _etuner,
                                   _session, _cnn, _default_session,
                                   _compiled_workload_session])
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
