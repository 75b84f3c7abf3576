"""LM training in the port against the JAX package, on the CPU at reduced
size: `cfg.remat`, `grad_multiplier_tree` with the masked AdamW update,
rwkv6 training under `use_pallas` (its frozen prefix on the WKV kernel
route), and the `train_lm` example (its step builder against the
reference's pieces, and the example's save and resume). The models, params
and the jitted reference come from tests/test_torch_lm_grads.py.

Tolerances: gradients as there (the loss within 1e-5, each leaf within
1e-5 + 1e-4 x its largest |g|); `remat="full"` bitwise; the masked update
bitwise on frozen slices and within rtol 1e-5 / atol 1e-6 of JAX's on the
rest, from the same gradients; the example's losses within rtol 1e-4.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.freeze_plan import FreezePlan as JaxFreezePlan
from repro.core.freeze_plan import \
    grad_multiplier_tree as jax_grad_multiplier_tree
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch import tree_leaves
from repro_torch.bridge import adamw_state_from_jax, params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.core.freeze_plan import FreezePlan, grad_multiplier_tree
from repro_torch.examples import train_lm
from repro_torch.kernels.rwkv import ops as wkv_ops
from repro_torch.models import build_model, transformer
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.runtime.train_loop import grads_of
from test_torch_lm_grads import (FP32, JAMBA, LOSS_TOL, RWKV, _batch,
                                 _hold_grads, _jax, _named, _pair, _plans,
                                 _torch, one_torch_thread)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# remat


@pytest.mark.parametrize("arch", ["gemma2-2b", JAMBA, RWKV])
def test_remat_leaves_gradients_bitwise_unchanged(arch, monkeypatch):
    """Under `remat="full"` each group's forward is recomputed in the
    backward (every block runs twice); the gradients are those of
    `remat="none"` bit for bit, with and without a plan."""
    _, _, _, model, params = _pair(arch)
    cfg = model.cfg
    G = model.num_freeze_units
    batch = _torch(_batch(cfg))
    runs = {"block": 0}
    apply_block = transformer._apply_block

    def counted_block(*a, **kw):
        runs["block"] += 1
        return apply_block(*a, **kw)

    monkeypatch.setattr(transformer, "_apply_block", counted_block)
    for spec in (None, _plans(G)["prefix_embed"]):
        plan = FreezePlan(*spec) if spec else None
        plain = build_model(cfg.replace(remat="none"), device="cpu")
        remat_model = build_model(cfg.replace(remat="full"), device="cpu")
        runs.update(block=0)
        want = grads_of(plain.loss, params, batch, plan)
        assert runs["block"] == cfg.num_layers
        runs.update(block=0)
        got = grads_of(remat_model.loss, params, batch, plan)
        assert runs["block"] > cfg.num_layers  # recomputed in the backward
        assert torch.equal(got[0], want[0])
        for (name, a), (_, b) in zip(_named(got[2]), _named(want[2])):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("remat, error", [
    ("dots", None), ("Full", ValueError), ("offload", ValueError)])
def test_remat_refuses_what_it_does_not_run(remat, error):
    """A value the reference does not know raises, where it would quietly
    run `full`; the reference's `dots` runs, and its gradients are
    `none`'s bitwise (tests/test_torch_remat.py holds them against the
    reference's)."""
    _, _, _, model, params = _pair("gemma2-2b")
    batch = _torch(_batch(model.cfg))
    odd = build_model(model.cfg.replace(remat=remat), device="cpu")
    if error is None:
        got = grads_of(odd.loss, params, batch, None)
        want = grads_of(build_model(model.cfg.replace(remat="none"),
                                    device="cpu").loss, params, batch, None)
        assert torch.equal(got[0], want[0])
        for (name, a), (_, b) in zip(_named(got[2]), _named(want[2])):
            assert torch.equal(a, b), name
        return
    with pytest.raises(error, match="remat"):
        grads_of(odd.loss, params, batch, None)


# ---------------------------------------------------------------------------
# grad_multiplier_tree and the masked AdamW update


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-moe-30b-a3b"])
def test_grad_multipliers_pin_frozen_slices(arch):
    """The port's multipliers are the reference's, laid out per layer; the
    masked AdamW update leaves frozen params and moments bitwise where
    they were and moves the rest as JAX's update does, from the same
    gradients and a state with moments in it."""
    jmodel, jparams, vg, model, params = _pair(arch)
    cfg = model.cfg
    G = model.num_freeze_units
    spec = (tuple(i == G - 1 for i in range(G)), True, True)
    plan, jplan = FreezePlan(*spec), JaxFreezePlan(*spec)
    masks = grad_multiplier_tree(plan, params)
    jmasks = jax_grad_multiplier_tree(jplan, jparams)
    want_masks = params_from_jax(  # each multiplier spread over its leaf
        jax.tree.map(lambda m, p: np.broadcast_to(m, p.shape), jmasks,
                     jparams), cfg, device="cpu")
    for (name, m), (_, w) in zip(_named(masks), _named(want_masks)):
        assert m.dim() == 0 and torch.all(w == m), name
        parts = name.split("/")
        frozen = plan.groups[int(parts[2]) // transformer.group_size(cfg)] \
            if parts[1] == "blocks" else plan.embed and parts[1] == "embed"
        assert float(m) == (0.0 if frozen else 1.0), name

    jcfg, pcfg = JaxAdamWConfig(lr=1e-2), AdamWConfig(lr=1e-2)
    batch = _batch(cfg)
    _, g0 = vg(jparams, _jax(batch), None)
    jp1, js1 = jax_adamw_update(g0, jax_adamw_init(jparams, jcfg), jparams,
                                jcfg)  # a state with moments in it
    _, g1 = vg(jp1, _jax(_batch(cfg, seed=9)), None)
    jp2, js2 = jax_adamw_update(g1, js1, jp1, jcfg, lr_scale=0.5,
                                masks=jmasks)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    p1 = params_from_jax(to_np(jp1), cfg, device="cpu")
    s1 = adamw_state_from_jax(to_np(js1), cfg, device="cpu")
    p2, s2 = adamw_update(params_from_jax(to_np(g1), cfg, device="cpu"), s1,
                          p1, pcfg, lr_scale=0.5, masks=masks)
    want_p = params_from_jax(to_np(jp2), cfg, device="cpu")
    want_s = adamw_state_from_jax(to_np(js2), cfg, device="cpu")
    assert int(s2.step) == int(want_s.step) == 2
    mask_of = dict(_named(masks))
    for tree, before, want in ((p2, p1, want_p), (s2.m, s1.m, want_s.m),
                               (s2.v, s1.v, want_s.v)):
        for (name, got), (_, old), (_, w) in zip(
                _named(tree), _named(before), _named(want)):
            if float(mask_of[name]) == 0.0:
                assert torch.equal(got, old), name
                assert torch.equal(w, old), name
            else:
                torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6,
                                           msg=name)
    moved = [n for (n, a), (_, b) in zip(_named(p2), _named(p1))
             if not torch.equal(a, b)]
    assert moved and all(float(mask_of[n]) == 1.0 for n in moved)


# ---------------------------------------------------------------------------
# rwkv6 under use_pallas: a train step takes WKV6 on a frozen prefix only


@pytest.fixture
def counted_wkv(monkeypatch):
    calls = []
    plain = wkv_ops.wkv

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(wkv_ops, "wkv", counting)
    return calls


@pytest.mark.parametrize("spec,launches", [
    (None, 0),
    (((True, False, False), True, False), 1),   # prefix behind the embed
    (((True, True, False), True, False), 2),
    (((True, False, False), False, False), 0),  # the embed trains
])
def test_rwkv6_trains_under_use_pallas(spec, launches, counted_wkv):
    """The WKV kernel has no backward: a train step takes it only on a
    frozen prefix that starts at a frozen embedding, one call a layer
    there, and the gradients are JAX's (at S = 16, one chunk, where the
    chunked form's clamp does not bite and equals the kernel's exact
    recurrence)."""
    jmodel, jparams, vg, model, params = _pair(RWKV)
    kmodel = build_model(model.cfg.replace(use_pallas=True, ssm_chunk=128),
                         device="cpu")
    plan = FreezePlan(*spec) if spec else None
    jplan = JaxFreezePlan(*spec) if spec else None
    batch = _batch(model.cfg, S=16)
    (want, _), jgrads = vg(jparams, _jax(batch), jplan)
    got, _, grads = grads_of(kmodel.loss, params, _torch(batch), plan)
    assert len(counted_wkv) == launches
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    _hold_grads(grads, params_from_jax(jax.tree.map(np.asarray, jgrads),
                                      model.cfg, device="cpu"),
                model.cfg, plan)


def test_rwkv6_loss_backward_under_use_pallas():
    """`loss.backward()` through the model with params that require grad,
    which raised before the route rule covered rwkv6."""
    cfg = get_reduced(RWKV).replace(use_pallas=True, **FP32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for t in tree_leaves(params):
        t.requires_grad_(True)
    for plan in (None, FreezePlan((True, False, False), True, False)):
        loss, _ = model.loss(params, _torch(_batch(cfg, S=16)), plan)
        loss.backward()
    assert params["blocks"][2]["mix"]["wr"].grad is not None
    assert params["blocks"][0]["mix"]["wr"].grad is not None  # from `None`


# ---------------------------------------------------------------------------
# the train_lm example


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_steps_match_the_reference():
    """The `tiny` preset in fp32 for 12 steps, the half-prefix plan with
    the embedding frozen from step 6: the port's step builder against the
    reference's pieces (its example's config and `synthetic_batch`,
    `model.loss` and `repro.optim`), losses within rtol 1e-4."""
    ref = _reference_example()
    steps, freeze_at = 12, 6
    jcfg = ref.ModelConfig(name="train-lm-tiny", family="dense",
                           remat="none", **ref.PRESETS["tiny"]).replace(**FP32)
    cfg = train_lm.preset_config("tiny").replace(**FP32)
    assert train_lm.PRESETS == ref.PRESETS
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    jopt_cfg, opt_cfg = JaxAdamWConfig(lr=3e-3), train_lm.OPT_CFG
    jstate = jax_adamw_init(jparams, jopt_cfg)
    state = adamw_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                 device="cpu")

    def jax_step(plan):
        def step(params, opt_state, batch, lr_scale):
            (loss, _), grads = jax.value_and_grad(
                lambda p: jmodel.loss(p, batch, plan), has_aux=True)(params)
            params, opt_state = jax_adamw_update(grads, opt_state, params,
                                                 jopt_cfg, lr_scale=lr_scale)
            return params, opt_state, loss
        return jax.jit(step)

    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    G = model.num_freeze_units
    jplan = plan = None
    cache = {}
    for step in range(steps):
        if step == freeze_at:
            plan = train_lm.half_prefix_plan(G)
            jplan = JaxFreezePlan(groups=plan.groups, embed=True)
        if plan not in cache:
            cache[plan] = (jax_step(jplan),
                           train_lm.make_step(model, opt_cfg, plan))
        jbatch = ref.synthetic_batch(jrng, cfg.vocab_size, 4, 64)
        batch = train_lm.synthetic_batch(rng, cfg.vocab_size, 4, 64, "cpu")
        assert all(np.array_equal(np.asarray(jbatch[k]), batch[k].numpy())
                   for k in batch)
        jparams, jstate, jloss = cache[plan][0](
            jparams, jstate, jbatch,
            jax_cosine_schedule(step, warmup=20, total=steps))
        params, state, loss = cache[plan][1](
            params, state, batch,
            train_lm.cosine_schedule(step, warmup=train_lm.WARMUP,
                                     total=steps))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   err_msg=f"step {step}")
    assert len(cache) == 2


def test_train_lm_example_saves_and_resumes(tmp_path, capsys):
    """`python -m repro_torch.examples.train_lm --device cpu` trains (its
    loss falls), saves its last step and, run again with more steps,
    resumes from it; the manager keeps two checkpoints."""
    ckpt = tmp_path / "ckpt"
    flags = ["--device", "cpu", "--freeze-at", "12", "--ckpt-dir", str(ckpt)]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm",
         "--steps", "24", *flags], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[0] == "model: train-lm-tiny  params=1.5M  groups=4"
    assert out[1].startswith("step    0 loss=")
    assert out[2] == "step 12: freezing prefix 2/4 groups + embed " \
                     "(recompile, cached)"
    assert out[3].startswith("step   20 loss=")
    assert out[4].startswith("step   23 loss=")
    assert out[5].startswith("done: loss ")
    assert sorted(p.name for p in ckpt.iterdir()) == ["ckpt_0000000023"]

    train_lm.main(["--steps", "36", *flags])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "resumed from step 23"
    assert out[2].startswith("step   35 loss=") and out[3].startswith("done")
    assert sorted(p.name for p in ckpt.iterdir()) == ["ckpt_0000000023",
                                                      "ckpt_0000000035"]
