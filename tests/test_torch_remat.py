"""`remat="dots"` in the port (selective checkpointing that keeps the
matmuls' outputs, the reference's `checkpoint_dots`) on the CPU at
reduced size, for all ten LM architectures:

- `lm_loss`'s gradients under `dots` equal the port's under `none`
  bitwise (recompute runs the same ops on the same inputs), and the
  reference's `jax.grad` under `remat="dots"` within the LM pair
  tolerance of `tests/test_torch_lm_grads.py`;
- on a reduced `train_4k` dry run the peak of what the step makes is
  ordered full <= dots <= none, and the recomputed FLOPs the other way.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
import repro_torch.configs as port_configs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.runtime.train_loop import grads_of
from test_torch_lm_grads import (CHUNK, FP32, JAMBA, LOSS_TOL, _batch,
                                 _hold_grads, _jax, _named, _torch)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_are_none_and_the_reference(arch):
    kw = dict(**FP32, **CHUNK)
    if arch == JAMBA:
        kw["num_layers"] = 16
    jmodel = jax_build_model(jax_get_reduced(arch).replace(remat="dots",
                                                           **kw))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True),
                 static_argnums=2)
    cfg = get_reduced(arch).replace(**kw)
    dots = build_model(cfg.replace(remat="dots"), device="cpu")
    none = build_model(cfg.replace(remat="none"), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    batch = _batch(cfg)
    got = grads_of(dots.loss, params, _torch(batch), None)
    want = grads_of(none.loss, params, _torch(batch), None)
    assert torch.equal(got[0], want[0])
    for (name, a), (_, b) in zip(_named(got[2]), _named(want[2]),
                                 strict=True):
        assert torch.equal(a, b), name
    (jloss, _), jgrads = vg(jparams, _jax(batch), None)
    np.testing.assert_allclose(float(got[0]), float(jloss), **LOSS_TOL)
    _hold_grads(got[2], params_from_jax(jax.tree.map(np.asarray, jgrads),
                                        cfg, device="cpu"), cfg, None)


def test_dots_sits_between_full_and_none_in_the_dry_run(monkeypatch):
    monkeypatch.setattr(port_configs, "get_config", get_reduced)
    recs = {r: dryrun.run_cell("gemma2-2b", "train_4k", "one", remat=r,
                               print_analysis=False)
            for r in ("full", "dots", "none")}
    temp = {r: rec["memory_per_chip"]["temp"] for r, rec in recs.items()}
    flops = {r: rec["flops_per_chip"] for r, rec in recs.items()}
    assert temp["full"] < temp["dots"] < temp["none"]
    assert flops["full"] > flops["dots"] > flops["none"]
    assert {rec["memory_per_chip"]["argument"] for rec in recs.values()} \
        == {recs["full"]["memory_per_chip"]["argument"]}
