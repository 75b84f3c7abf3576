"""The port's entry-point helpers (`repro_torch.launch`) and the
counterpart of `benchmarks/kernels_micro.py` (`repro_torch.harness.
kernels_micro`) on the CPU.

- `launch.mesh`: the reference's host-mesh arithmetic over the world's
  size and the production meshes, on fake process groups in this process.
- `launch.platform.bootstrap`: the device, logging and the kernels'
  build directory; idempotent.
- `launch.train`: reduced gemma2-2b (fp32) trained on a 2-rank (1, 2)
  gloo world with DTensor params sharded on `model`, from the JAX
  package's seed-0 params (bridged), against the reference's step as its
  `launch/train.py` builds it (`model.loss` under `jax.value_and_grad`,
  then `adamw_update`, jitted per plan) on the same params and batches:
  each step's loss within 1e-5, and the final params (from the port's
  last checkpoint) within 1e-4: AdamW divides each gradient by its own
  root mean square, so a gradient entry near zero turns the two
  frameworks' rounding into moves of up to lr (1e-3); one entry of
  8192 in `ffn/wu` parts by 1.35e-5. Then `python -m repro_torch.launch.train`
  on a world of one.
- `kernels_micro`: its inputs are the reference's `_cases(0)` arrays, its
  plain versions hold against the reference's `ref.py` oracles at those
  shapes, its validator and the reference's agree, and it refuses the
  CPU (it times the card's kernels).
"""
import inspect
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from benchmarks import kernels_micro as jax_micro
from repro.configs import get_reduced as jax_get_reduced
from repro.core.freeze_plan import FreezePlan as JaxFreezePlan
from repro.kernels.attention.ref import attention_ref
from repro.kernels.cka.ref import cka_ref
from repro.kernels.rwkv.ref import wkv_ref
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.configs import get_reduced
from repro_torch.harness import kernels_micro
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.rwkv import ops as wkv_ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import platform, train
from torch_ranks import run_ranks

FP32 = dict(dtype="float32", param_dtype="float32")
STEPS, BATCH, SEQ, FREEZE_AT = 6, 4, 16, 3


# ---------------------------------------------------------------------------
# meshes and process setup


def _fake_world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.mark.parametrize("world,want", [(1, (1, 1)), (2, (1, 2)),
                                        (3, (1, 3)), (8, (2, 4)),
                                        (16, (2, 4))])
def test_host_mesh_follows_the_reference_arithmetic(world, want):
    """`repro.launch.mesh.make_host_mesh` over `world` devices: data =
    min(2, max(n // 4, 1)), model cut to what is left."""
    _fake_world(world)
    try:
        mesh = launch_mesh.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == want
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.flatten().tolist() == list(range(math.prod(want)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod):
    _fake_world(512 if multi_pod else 256)
    try:
        mesh = launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                                device="cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == (
            {"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    finally:
        dist.destroy_process_group()


def test_bootstrap_sets_up_once(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(platform, "_bootstrapped", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setenv("EDGEOL_LOG", "DEBUG")
    assert platform.bootstrap("cpu", build_dir=tmp_path) == \
        torch.device("cpu")
    assert build.BUILD_DIR == tmp_path
    assert logging.getLogger("edgeol").level == logging.DEBUG
    assert platform.bootstrap("cuda", build_dir="/elsewhere") == \
        torch.device("cpu")  # idempotent: the first call's setup holds
    assert build.BUILD_DIR == tmp_path
    if not torch.cuda.is_available():
        monkeypatch.setattr(platform, "_bootstrapped", None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            platform.bootstrap()


# ---------------------------------------------------------------------------
# the LM loop on a mesh


def _reference_run(jcfg, jparams):
    """The reference's `launch/train.py` loop, its params given."""
    model = jax_build_model(jcfg)
    opt_cfg = JaxAdamWConfig(lr=1e-3)
    params, opt_state = jparams, jax_adamw_init(jparams, opt_cfg)
    cache = {}

    def get_step(plan):
        if plan not in cache:
            def step(p, o, b):
                (l, _), g = jax.value_and_grad(
                    lambda q: model.loss(q, b, plan), has_aux=True)(p)
                p, o = jax_adamw_update(g, o, p, opt_cfg)
                return p, o, l
            cache[plan] = jax.jit(step)
        return cache[plan]

    rng = np.random.default_rng(0)
    plan, losses = None, []
    for i in range(STEPS):
        if i == FREEZE_AT:
            G = model.num_freeze_units
            plan = JaxFreezePlan(groups=tuple(g < G // 2 for g in range(G)),
                                 embed=True)
        toks = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ + 1))
        batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                 "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
        params, opt_state, loss = get_step(plan)(params, opt_state, batch)
        losses.append(float(loss))
    return losses, params


TRAIN = """
from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model

cfg = get_reduced("gemma2-2b").replace(dtype="float32",
                                       param_dtype="float32")
like = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
params, _ = ckpt.restore(str(inp["params"]), like, device="cpu")
mesh = make_host_mesh(device="cpu")
plans = []
res = train.train(cfg, steps=int(inp["steps"]), batch=int(inp["batch"]),
                  seq=int(inp["seq"]), freeze_at=int(inp["freeze_at"]),
                  ckpt_dir=str(inp["dir"]), mesh=mesh, device="cpu",
                  params=params, on_step=lambda i, p: plans.append(p))
wq = res["params"]["blocks"][0]["mix"]["wq"]
out = {"mesh": sh.axis_sizes(mesh), "losses": res["losses"],
       "wq": [[p.dim if p.is_shard() else None for p in wq.placements],
              list(wq.to_local().shape)],
       "m_is_dtensor": type(res["opt_state"].m["embed"]["tok"]).__name__,
       "frozen_steps": [p is not None for p in plans]}
"""


def test_train_on_two_gloo_ranks_matches_the_reference(tmp_path):
    jcfg = jax_get_reduced("gemma2-2b").replace(**FP32)
    cfg = get_reduced("gemma2-2b").replace(**FP32)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    ckpt.save(str(tmp_path / "params"), params)
    outs = run_ranks(2, TRAIN, {
        "params": np.array(str(tmp_path / "params")),
        "dir": np.array(str(tmp_path / "ckpts")), "steps": STEPS,
        "batch": BATCH, "seq": SEQ, "freeze_at": FREEZE_AT}, tmp_path,
        timeout=240)
    want_losses, want_params = _reference_run(jcfg, jparams)
    for o in outs:
        assert o["mesh"] == {"data": 1, "model": 2}
        # wq [D, H, hd]: heads on `model`, 2 of 4 a rank
        assert o["wq"] == [[None, 1], [cfg.d_model, 2, cfg.head_dim]]
        assert o["m_is_dtensor"] == "DTensor"
        assert o["frozen_steps"] == [i >= FREEZE_AT for i in range(STEPS)]
        np.testing.assert_allclose(o["losses"], want_losses, rtol=0,
                                   atol=1e-5)
    assert outs[0]["losses"] == outs[1]["losses"]
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    assert mgr.all_steps() == [STEPS - 1]
    final, step = mgr.restore_latest(params, device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, want_params), cfg,
                           device="cpu")
    for (name, got), (_, w) in zip(ckpt._flatten_with_names(final),
                                   ckpt._flatten_with_names(want),
                                   strict=True):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_train_entry_point_on_a_world_of_one(tmp_path, monkeypatch):
    """`python -m repro_torch.launch.train --device cpu`: the (1, 1) mesh,
    a checkpoint under the temporary directory, the group torn down."""
    monkeypatch.setattr(platform, "_bootstrapped", None)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    train.main(["--device", "cpu", "--steps", "3", "--freeze-at", "2",
                "--seq", "8"])
    assert not dist.is_initialized()
    mgr = CheckpointManager(str(tmp_path / "repro_torch_launch_train"))
    assert mgr.all_steps() == [2]


def test_plain_params_train_as_the_mesh_of_one(tmp_path):
    """With no mesh the loop takes plain tensors; on a (1, 1) mesh every
    spec replicates and the losses are the same bits."""
    cfg = get_reduced("gemma2-2b")
    plain = train.train(cfg, steps=4, batch=2, seq=8, freeze_at=2,
                        ckpt_dir=str(tmp_path / "a"), device="cpu")
    launch_mesh.init_world("cpu")
    try:
        mesh = launch_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
        placed = train.train(cfg, steps=4, batch=2, seq=8, freeze_at=2,
                             ckpt_dir=str(tmp_path / "b"), mesh=mesh,
                             device="cpu")
    finally:
        dist.destroy_process_group()
    assert placed["losses"] == plain["losses"]
    for (_, a), (_, b) in zip(
            ckpt._flatten_with_names(plain["params"]),
            ckpt._flatten_with_names(placed["params"]), strict=True):
        assert torch.equal(a, b.to_local())


# ---------------------------------------------------------------------------
# kernels_micro


def _reference_arrays():
    """Each reference case's input arrays, from its lambdas' closures."""
    out = {}
    for case in jax_micro._cases(0):
        env = inspect.getclosurevars(case["pallas"]).nonlocals
        names = {"flash_attention": "q k v", "cka": "x y",
                 "rwkv_wkv": "r kk vv logw u"}[case["op"]].split()
        out[case["op"]] = tuple(env[n] for n in names)
    return out


def test_micro_cases_are_the_reference_draws():
    ours, ref = kernels_micro.case_inputs(0), _reference_arrays()
    assert list(ours) == list(ref) == [c["op"] for c in jax_micro._cases(0)]
    for op in ref:
        for a, b in zip(ours[op], ref[op], strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), op


def test_micro_plain_versions_hold_against_the_oracles():
    (q, k, v), (x, y), wkv_in = (kernels_micro.case_inputs(0)[op] for op in
                                 ("flash_attention", "cka", "rwkv_wkv"))
    t = torch.from_numpy
    np.testing.assert_allclose(
        att_ops.attention_plain(t(q), t(k), t(v), causal=False).numpy(),
        np.asarray(attention_ref(q, k, v, causal=False)),
        rtol=2e-4, atol=2e-5)
    center = lambda a: a - a.mean(axis=0, keepdims=True)  # noqa: E731
    np.testing.assert_allclose(
        float(kernels_micro.cka_plain(t(x), t(y))),
        float(cka_ref(center(x), center(y))), rtol=1e-4)
    np.testing.assert_allclose(
        wkv_ops.wkv_plain(*map(t, wkv_in))[0].numpy(),
        np.asarray(wkv_ref(*wkv_in)[0]), rtol=1e-4, atol=1e-4)
    # the kernel wrappers take their plain versions on CPU tensors
    for case in kernels_micro._cases(0, "cpu"):
        assert torch.equal(case["kernel"](), case["plain"]())


def test_micro_validators_agree():
    cell = {"op": "cka", "shape": "520x192", "pallas_ms": 0.02,
            "ref_ms": 0.05, "max_abs_err": 1e-7, "iters": 5}
    doc = {"schema_version": 1, "suite": "kernels_micro",
           "cells": [dict(cell, op=op) for op in
                     ("flash_attention", "cka", "rwkv_wkv")]}
    assert kernels_micro.validate_bench(doc) == \
        jax_micro.validate_bench(doc) == []
    for broken in (dict(doc, suite="other"), dict(doc, cells=doc["cells"][:2]),
                   dict(doc, cells=[dict(cell, ref_ms=-1.0)] * 3),
                   dict(doc, cells=[dict(cell, pallas_ms=float("nan"))] * 3),
                   "not a document"):
        errors = kernels_micro.validate_bench(broken)
        assert errors and errors == jax_micro.validate_bench(broken)


def test_micro_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="card"):
        kernels_micro.run(device="cpu")
