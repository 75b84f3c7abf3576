"""The CNNs (MobileNetV2, ResNet) and the round hooks in the port against
the JAX package on the CPU: params initialised in JAX and carried across
by `repro_torch.bridge`, the same numpy images through `predict`,
`features`, `loss` and its gradients under freeze plans, SimFreeze's
layerwise CKA (the JAX side through its Pallas kernel in interpret mode,
as its own tests run it), JAX's asymmetric "SAME" padding at odd sizes,
and fake quantization and the SimSiam step of the round hooks, with the
reference's augmentation draws passed in."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import semi as jax_semi
from repro.core.freeze_plan import LayerFreezePlan as JaxLayerFreezePlan
from repro.models import build_model as jax_build_model
from repro.models import cnn as jax_cnn
from repro.runtime import executor as jax_executor
from repro_torch import tree_leaves, tree_map
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
import repro_torch.core.cka as cka
from repro_torch.core import semi
from repro_torch.core.freeze_plan import LayerFreezePlan
from repro_torch.models import build_model, cnn
from repro_torch.runtime import executor
from repro_torch.runtime.train_loop import grads_of

RTOL, ATOL = 2e-4, 2e-5
# CKA values in [0, 1], the kernel tolerance of tests/test_kernels.py
CKA_RTOL = 1e-4
ARCHS = ["mobilenetv2", "resnet50"]
CPU = "cpu"
# `repro.core` exports a function named `cka` over its module of that name
jax_cka = importlib.import_module("repro.core.cka")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, image_size=32, batch=6):
    jcfg = jax_get_reduced(arch).replace(image_size=image_size)
    cfg = get_reduced(arch).replace(image_size=image_size)
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device=CPU)
    rng = np.random.default_rng(5)
    b = {"images": rng.normal(size=(batch, image_size, image_size, 3))
         .astype(np.float32),
         "labels": rng.integers(0, cfg.num_classes, batch).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return jmodel, jparams, model, params, b, tb


_PAIRS = {}


@pytest.fixture(params=ARCHS)
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = _pair(request.param)
    return _PAIRS[request.param]


def test_predict_matches_jax(pair):
    jmodel, jparams, model, params, b, tb = pair
    want = np.asarray(jmodel.predict(jparams, b))
    got = model.predict(params, tb)
    assert not got.requires_grad and got.is_inference()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_features_are_nhwc_and_match_jax(pair):
    jmodel, jparams, model, params, b, tb = pair
    want = jmodel.features(jparams, b)
    got = model.features(params, tb)
    # one activation per freeze unit but the head
    assert len(got) == len(want) == model.num_freeze_units - 1
    assert model.num_freeze_units == jmodel.num_freeze_units
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape  # NHWC, as the reference's
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
        # flattened in the reference's order: SimSiam's `pooled` and the
        # CKA probe read the flat features
        np.testing.assert_allclose(
            cka._flatten_features(g).numpy(),
            np.asarray(jax_cka._flatten_features(w)), rtol=RTOL, atol=ATOL)


def _plans(n):
    return {"all-active": (False,) * n,
            "frozen-prefix": (True, True) + (False,) * (n - 2),
            "frozen-middle": (False, False, True) + (False,) * (n - 3)}


def _unit_of(path, n):
    """Freeze unit of a leaf path /units/<i>/... or /head/..."""
    parts = path.split("/")
    return int(parts[2]) if parts[1] == "units" else n - 1


def _leaves_in_order(tree):
    """Leaves in `_leaf_paths` order (dict insertion order, not the
    sorted order of `jax.tree.leaves`)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves_in_order(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves_in_order(v)]
    return [tree]


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


# MobileNetV2 leaves whose gradient cancels (reduced width; reference
# values of the all-active plan in `test_loss_and_gradients_match_jax`)
CANCELLING = {"mobilenetv2": ("/units/0/bn/scale", "exp_bn/scale",
                              "pw_bn/bias")}


def _close_per_leaf(got, want, arch, n):
    """Each leaf of `got` within 1e-4 of the largest entry of its leaf in
    `want`, but for the leaves of `CANCELLING`: those are below 1e-4 of
    their freeze unit's largest gradient on both sides, and within it of
    each other. Returns the largest reference entry of each unit."""
    paths = _leaf_paths(want)
    leaves = [(_unit_of(p, n), p, g.numpy(), w.numpy()) for p, g, w in zip(
        paths, tree_leaves(got), tree_leaves(want))]
    unit_max = {}
    for unit, _, _, w in leaves:
        unit_max[unit] = max(unit_max.get(unit, 0.0), np.abs(w).max())
    for unit, path, g, w in leaves:
        if not unit_max[unit]:
            assert not g.any(), path  # frozen, or before the first trained
        elif path.endswith(CANCELLING.get(arch, ())):
            scale = 1e-4 * unit_max[unit]
            assert np.abs(w).max() <= scale and np.abs(g).max() <= scale, \
                path
            np.testing.assert_allclose(g, w, rtol=0, atol=scale,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)
            assert np.abs(w).max() > 0, path
    return unit_max


@pytest.mark.parametrize("plan_name", ["all-active", "frozen-prefix",
                                       "frozen-middle"])
def test_loss_and_gradients_match_jax(pair, plan_name):
    """Gradients within 1e-4 of the largest reference gradient of the
    leaf, as tests/test_torch_train.py holds the ViT's, but for three
    kinds of MobileNetV2 leaf whose gradient is a sum of large terms
    that cancel, so that both sides give mostly rounding noise there:
    the projection BN bias (`pw_bn/bias`), a per-channel shift that the
    next unit's convolution and BN remove (zero in exact arithmetic;
    reference 6.1e-8 in unit 2, whose largest gradient is 0.36), and a
    BN scale ahead of relu6 and a depthwise convolution (the stem's
    `bn/scale` and `exp_bn/scale`): relu6 is positively homogeneous
    below 6 and the depthwise convolution and its BN remove a
    per-channel scale, so only the clip at 6 is left (reference 5.9e-6
    in unit 2, 9.3e-6 in the stem, whose largest is 0.59). Those are held
    to 1e-4 of their unit's largest gradient. ResNet has none such."""
    jmodel, jparams, model, params, b, tb = pair
    n = model.num_freeze_units
    flags = _plans(n)[plan_name]
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, b, JaxLayerFreezePlan(flags))[0])(jparams)
    loss, metrics, grads = grads_of(model.loss, params, tb,
                                    LayerFreezePlan(flags))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(metrics) == {"loss", "acc", "logits"}
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg,
                           device=CPU)
    arch = "resnet50" if model.cfg.name.startswith("resnet") \
        else "mobilenetv2"
    unit_max = _close_per_leaf(grads, want, arch, n)
    first_trained = flags.index(False)
    for u in range(n):
        frozen = flags[u] or u < first_trained
        assert (unit_max[u] == 0) == frozen, u  # exactly zero when frozen


def test_layerwise_cka_matches_jax_through_the_kernels(pair):
    """SimFreeze's probe on two points in time: the JAX side through its
    Pallas kernel in interpret mode, the port's `use_kernel` path, which
    takes the plain version on CPU tensors. CNN maps flatten to
    [B, H*W*C] with d > n, CKA's example route on the card."""
    jmodel, jparams, model, params, b, tb = pair
    moved = jax.tree.map(lambda a: a * 1.05 + 0.01, jparams)
    tmoved = params_from_jax(jax.tree.map(np.asarray, moved), model.cfg,
                             device=CPU)
    want = jax_cka.layerwise_cka(jmodel.features(jparams, b),
                                 jmodel.features(moved, b), use_kernel=True)
    feats_a, feats_b = model.features(params, tb), model.features(tmoved, tb)
    got = cka.layerwise_cka(feats_a, feats_b, use_kernel=True)
    assert all(f.shape[0] < f[0].numel() for f in feats_a)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=CKA_RTOL)
    assert min(float(w) for w in want) < 0.999  # the params did move


@pytest.mark.parametrize("arch,size", [("mobilenetv2", 33), ("resnet50", 35)])
def test_same_padding_at_odd_sizes_matches_jax(arch, size):
    """JAX's "SAME" pads a stride-2 window on the high side where the
    total pad is odd (the ResNet stem's 7x7 and its max-pool, MobileNetV2's
    stride-2 3x3 convs); at odd sizes the totals change parity."""
    assert cnn._same_pad(32, 3, 2) == (0, 1)
    assert cnn._same_pad(32, 7, 2) == (2, 3)
    assert cnn._same_pad(32, 1, 2) == (0, 0)
    assert cnn._same_pad(33, 3, 2) == (1, 1)
    jmodel, jparams, model, params, b, tb = _pair(arch, image_size=size,
                                                  batch=4)
    np.testing.assert_allclose(model.predict(params, tb).numpy(),
                               np.asarray(jmodel.predict(jparams, b)),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(model.features(params, tb), jmodel.features(jparams, b)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("arch,units", [("mobilenetv2", 20), ("resnet50", 18)])
def test_full_width_structure_matches_jax(arch, units):
    """The full-width unit lists, `width_mult` rounding and param shapes
    (from shapes only: nothing is computed at full width here)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    spec = cnn.resnet_static_spec if arch == "resnet50" \
        else cnn.mbv2_static_spec
    jspec = jax_cnn.resnet_static_spec if arch == "resnet50" \
        else jax_cnn.mbv2_static_spec
    assert spec(cfg) == jspec(jcfg)
    model = build_model(cfg, device="meta")
    assert model.num_freeze_units == units
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = model.init(torch.Generator())
    assert {p: tuple(t.shape) for p, t in zip(_leaf_paths(got),
                                                 tree_leaves(got))} == \
        {p: s.shape for p, s in zip(_leaf_paths(want),
                                    _leaves_in_order(want))}
    half = get_config("mobilenetv2").replace(width_mult=0.5)
    assert cnn.mbv2_static_spec(half) == jax_cnn.mbv2_static_spec(
        jax_get_config("mobilenetv2").replace(width_mult=0.5))


def _full_width_runs(arch):
    """The full-width model at 64x64 on 4 images in both packages, each
    in float32 and float64 (the JAX side under `jax.enable_x64`, from
    the same params): loss, predict, features and the gradients under a
    frozen first half, all as float64 numpy."""
    jcfg = jax_get_config(arch).replace(image_size=64)
    cfg = get_config(arch).replace(image_size=64)
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = params_from_jax(jparams, cfg, device=CPU)
    rng = np.random.default_rng(5)
    b = {"images": rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
         "labels": rng.integers(0, cfg.num_classes, 4).astype(np.int32)}
    n = model.num_freeze_units
    flags = (True,) * (n // 2) + (False,) * (n - n // 2)
    paths = _leaf_paths(params)  # the JAX layout: the same leaf shapes

    def as64(tree):
        return [np.asarray(t, np.float64) for t in tree]

    def jax_run(dtype):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), jparams)
        jb = {"images": jnp.asarray(b["images"], dtype),
              "labels": jnp.asarray(b["labels"])}
        loss, grads = jax.value_and_grad(lambda q: jmodel.loss(
            q, jb, JaxLayerFreezePlan(flags))[0])(p)
        by_path = dict(zip(_leaf_paths(grads), _leaves_in_order(grads)))
        return {"loss": float(loss), "predict": as64([jmodel.predict(p, jb)]),
                "features": as64(jmodel.features(p, jb)),
                "grads": as64(by_path[path] for path in paths)}

    def port_run(dtype):
        p = tree_map(lambda t: t.to(dtype), params)
        tb = {"images": torch.from_numpy(b["images"]).to(dtype),
              "labels": torch.from_numpy(b["labels"])}
        loss, _, grads = grads_of(model.loss, p, tb, LayerFreezePlan(flags))
        return {"loss": float(loss),
                "predict": as64([model.predict(p, tb)]),
                "features": as64(f.detach() for f in model.features(p, tb)),
                "grads": as64(tree_leaves(grads))}

    runs = {"jax32": jax_run(jnp.float32), "port32": port_run(torch.float32),
            "port64": port_run(torch.float64)}
    with jax.enable_x64(True):
        runs["jax64"] = jax_run(jnp.float64)
    return runs, paths, n


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_matches_jax_to_its_own_rounding(arch):
    """The full-width models (every unit at full width, the only
    MobileNetV2 residual adds and ResNet identity shortcuts under test)
    at 64x64 on 4 images: predict, features, loss and gradients under a
    frozen half, against the JAX package run in float64.

    In float64 the port matches it: each output and feature map within
    1e-11 of its largest entry, each gradient leaf within 1e-6 of its
    own (of its unit's for the leaves of `CANCELLING`: full-width
    `pw_bn/bias` is zero in exact arithmetic, about 1e-17 here). The
    gradients are held looser because both packages take the
    cross-entropy in float32 (measured: outputs within 3.3e-13, leaves
    within 4.4e-8). In float32 the results are sensitive to summation
    order (batch-statistic BN on 2x2 maps at the end, gradients off by
    up to 13% of their unit's largest in either package), so the port's
    float32 results are held to the reference's own float32 error
    against float64: within 4 times it per output, per map, per freeze
    unit and for the loss (measured: at most 1.45 times)."""
    runs, paths, n = _full_width_runs(arch)
    ref = runs["jax64"]
    np.testing.assert_allclose(runs["port64"]["loss"], ref["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(runs["port32"]["loss"], runs["jax32"]["loss"],
                               rtol=1e-5)
    for key in ("predict", "features"):
        for i, (got, want) in enumerate(zip(runs["port64"][key], ref[key])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-11 * np.abs(want).max(),
                                       err_msg=f"{key} {i}")
    units = [_unit_of(path, n) for path in paths]
    unit_max = {}
    for u, w in zip(units, ref["grads"]):
        unit_max[u] = max(unit_max.get(u, 0.0), np.abs(w).max())
    for path, u, got, want in zip(paths, units, runs["port64"]["grads"],
                                  ref["grads"]):
        scale = unit_max[u] if path.endswith(CANCELLING.get(arch, ())) \
            else np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                                   err_msg=path)
        assert (scale > 0) == (unit_max[u] > 0), path
    assert sum(m == 0 for m in unit_max.values()) == n // 2  # frozen half

    def err(run, key, groups):
        out = {}
        for g, got, want in zip(groups, runs[run][key], ref[key]):
            out[g] = max(out.get(g, 0.0), float(np.abs(got - want).max()))
        return out

    for key in ("predict", "features", "grads"):
        groups = units if key == "grads" else range(len(ref[key]))
        own, port = err("jax32", key, groups), err("port32", key, groups)
        for g, e in port.items():
            assert e <= 4 * own[g] + 1e-7, (key, g, e, own[g])
        assert max(own.values()) > 0
    assert abs(runs["port32"]["loss"] - ref["loss"]) <= \
        4 * abs(runs["jax32"]["loss"] - ref["loss"]) + 1e-7


def test_bridge_refuses_params_of_another_config():
    jparams = jax.tree.map(np.asarray, jax_build_model(
        jax_get_reduced("mobilenetv2")).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="do not fit"):
        params_from_jax(jparams, get_reduced("resnet50"), device=CPU)
    with pytest.raises(ValueError, match="do not fit"):
        params_from_jax(jparams, get_config("mobilenetv2"), device=CPU)
    out = params_from_jax(jparams, get_reduced("mobilenetv2"), device=CPU)
    assert all(t.dtype == torch.float32 for t in tree_leaves(out))


# ---------------------------------------------------------------------------
# the round hooks


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_and_its_straight_through_gradient_match_jax(bits):
    x = np.random.default_rng(3).normal(size=(64, 33)).astype(np.float32)
    x[0, 0] = 0.5  # a tie that rounds half to even in both
    want, vjp = jax.vjp(lambda a: jax_executor.fake_quant(a, bits),
                        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = executor.fake_quant(t, bits)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    cot = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    (gw,) = vjp(jnp.asarray(cot))
    (gg,) = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(gw))
    assert len(np.unique(got.detach().numpy())) <= 2 ** bits
    ints = torch.arange(3)
    assert executor.fake_quant(ints, bits) is ints


def test_quantized_model_matches_jax(pair):
    jmodel, jparams, model, params, b, tb = pair
    jq, q = jax_executor.quantized_model(jmodel, 8), \
        executor.quantized_model(model, 8)
    np.testing.assert_allclose(q.predict(params, tb).numpy(),
                               np.asarray(jq.predict(jparams, b)),
                               rtol=RTOL, atol=ATOL)
    jl = jq.loss(jparams, b)[0]
    np.testing.assert_allclose(float(q.loss(params, tb)[0]), float(jl),
                               rtol=1e-6)
    assert q.features is model.features  # fake-quant wraps loss/predict


def reference_draws(images):
    """The two views' augmentation draws of the reference's semi step,
    from its fixed key (`SimSiamHook._semi_update`, ROADMAP C.7), as
    `semi.AugmentDraws`."""
    B, H = images.shape[0], images.shape[1]
    rng = jax.random.PRNGKey(int(np.random.default_rng(0).integers(1 << 30)))
    out = []
    for key in jax.random.split(rng):
        k1, k2, k3 = jax.random.split(key, 3)
        off = np.asarray(jax.random.randint(k1, (2,), 0, 2 * max(H // 8, 1)))
        bright = 1.0 + 0.2 * jax.random.uniform(k3, (B, 1, 1, 1), minval=-1.0)
        out.append(semi.AugmentDraws(
            (int(off[0]), int(off[1])), bool(jax.random.bernoulli(k2)),
            torch.from_numpy(np.array(bright))))
    return tuple(out)


def reference_head(feat_dim):
    """The reference's SimSiam head (`init_simsiam_head(PRNGKey(1))`)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_semi.init_simsiam_head(jax.random.PRNGKey(1),
                                       feat_dim).items()}


def test_augment_with_the_reference_draws_matches_jax():
    images = np.random.default_rng(2).normal(size=(5, 32, 32, 3)) \
        .astype(np.float32)
    rng = jax.random.PRNGKey(int(np.random.default_rng(0).integers(1 << 30)))
    draws = reference_draws(images)
    for key, d in zip(jax.random.split(rng), draws):
        want = np.asarray(jax_semi.augment(key, jnp.asarray(images)))
        got = semi.augment(torch.from_numpy(images), d).numpy()
        np.testing.assert_array_equal(got, want)


def test_draw_augment_stays_in_range():
    images = torch.rand((4, 32, 32, 3))
    d = semi.draw_augment(torch.Generator().manual_seed(3), images.shape)
    again = semi.draw_augment(torch.Generator().manual_seed(3), images.shape)
    a = semi.augment(images, d)
    assert torch.equal(a, semi.augment(images, again))
    assert a.shape == images.shape
    gen = torch.Generator().manual_seed(0)
    draws = [semi.draw_augment(gen, (4, 32, 32, 3)) for _ in range(64)]
    assert all(0 <= o < 8 for d in draws for o in d.offset)
    assert {d.flip for d in draws} == {False, True}
    bright = torch.cat([d.bright for d in draws])
    assert bright.shape == (256, 1, 1, 1)
    assert 0.8 <= float(bright.min()) and float(bright.max()) <= 1.2
    first = executor.draw_views(torch.zeros(4, 32, 32, 3))
    again = executor.draw_views(torch.zeros(4, 32, 32, 3))
    assert first[0].offset == again[0].offset and \
        torch.equal(first[1].bright, again[1].bright)  # C.7: alike each call


def test_simsiam_step_matches_jax(pair):
    """One semi step of the two hooks on the same params and images, the
    port given the reference's draws and head: the same new params,
    within the gradient test's tolerance on the moves (1e-4 of the
    unit's largest move) plus two ulps of the param."""
    jmodel, jparams, model, params, b, tb = pair
    jhook, hook = jax_executor.SimSiamHook(0.5), executor.SimSiamHook(0.5)
    jhook.bind(jmodel)
    hook.bind(model)
    hook.draws, hook.init_head = reference_draws, reference_head
    jnew = jhook._semi_update(jparams, {"images": jnp.asarray(b["images"])})
    new = hook._semi_update(params, {"images": tb["images"]})
    assert hook._feat_dim == jhook._feat_dim == min(
        model.features(params, tb)[-1][0].numel(), 256)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), model.cfg,
                           device=CPU)
    assert not any(t.requires_grad for t in tree_leaves(new))
    n = model.num_freeze_units
    paths = _leaf_paths(want)
    move = {}
    for path, w, p in zip(paths, tree_leaves(want), tree_leaves(params)):
        u = _unit_of(path, n)
        move[u] = max(move.get(u, 0.0), float((w - p).abs().max()))
    for path, g, w in zip(paths, tree_leaves(new), tree_leaves(want)):
        # two float32 ulps of the param (the rounding of p - 1e-3 g)
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=2.0 ** -22,
            atol=1e-4 * move[_unit_of(path, n)], err_msg=path)
    # every unit but the head (SimSiam trains the backbone) moved
    assert all(move[u] > 0 for u in range(n - 1)) and move[n - 1] == 0


def test_simsiam_hook_claims_batches_as_jax():
    """The labeled/unlabeled split: `default_rng(round_index + 17)` per
    round, image batches only."""
    jhook, hook = jax_executor.SimSiamHook(0.5), executor.SimSiamHook(0.5)
    claimed = {"jax": [], "port": []}
    for name, h in (("jax", jhook), ("port", hook)):
        h._semi_update = lambda p, batch, name=name: claimed[name].append(1) \
            or "semi"
        for r in range(3):
            h.on_round_start(r)
            for _ in range(5):
                claimed[name].append(h.process_batch(
                    None, {"images": 0}, {"images": 0}) == "semi")
            claimed[name].append(h.process_batch(None, {"tokens": 0}, {}))
    assert claimed["jax"] == claimed["port"]
    assert claimed["port"].count(True) > 0


def test_hooks_build_from_their_specs():
    from repro_torch.runtime.config import HookSpec, build_hook

    q = build_hook(HookSpec("fake-quant", {"bits": 4}))
    s = build_hook(HookSpec("simsiam", {"fraction": 0.25}))
    assert isinstance(q, executor.FakeQuantHook) and q.bits == 4
    assert isinstance(s, executor.SimSiamHook) and s.unlabeled_fraction == 0.25
    model = build_model(get_reduced("mobilenetv2"), device=CPU)
    wrapped = q.bind(model)
    assert dataclasses.replace(wrapped, loss=model.loss,
                               predict=model.predict) == model
