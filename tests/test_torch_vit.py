"""DeiT in the port against the JAX model: params initialised in JAX,
carried across by `repro_torch.bridge`, and run through `predict`,
`features` and `loss` in both packages on the same numpy images."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.freeze_plan import LayerFreezePlan as JaxLayerFreezePlan
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.freeze_plan import LayerFreezePlan
from repro_torch.models import build_model
from repro_torch.models.vit import patches

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_reduced("deit-tiny").replace(use_pallas=True)
    cfg = get_reduced("deit-tiny").replace(use_pallas=True)
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(5)
    batch = {"images": rng.normal(size=(6, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, cfg.num_classes, 6).astype(np.int32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, jparams, model, params, batch, tbatch


def test_predict_matches_jax(pair):
    jmodel, jparams, model, params, batch, tbatch = pair
    want = np.asarray(jmodel.predict(jparams, batch))
    got = model.predict(params, tbatch)
    assert not got.requires_grad and got.is_inference()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_features_match_jax(pair):
    jmodel, jparams, model, params, batch, tbatch = pair
    want = jmodel.features(jparams, batch)
    got = model.features(params, tbatch)
    # L+1 activations for L+2 freeze units: the head gets no CKA
    assert len(got) == len(want) == model.cfg.num_layers + 1
    assert model.num_freeze_units == model.cfg.num_layers + 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("frozen", [(), (True, True, False, False, False, False)])
def test_loss_matches_jax(pair, frozen):
    jmodel, jparams, model, params, batch, tbatch = pair
    jplan = JaxLayerFreezePlan(frozen) if frozen else None
    plan = LayerFreezePlan(frozen) if frozen else None
    jl, jm = jmodel.loss(jparams, batch, jplan)
    l, m = model.loss(params, tbatch, plan)
    np.testing.assert_allclose(float(l), float(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]))
    np.testing.assert_allclose(m["logits"].detach().numpy(),
                               np.asarray(jm["logits"]), rtol=RTOL, atol=ATOL)


def test_patch_reshape_is_the_valid_convolution():
    # the stride-p VALID convolution of the JAX model, patch by patch
    rng = np.random.default_rng(1)
    p, d = 4, 8
    images = rng.normal(size=(2, 10, 12, 3)).astype(np.float32)  # ragged H
    w = rng.normal(size=(p, p, 3, d)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        images, w, (p, p), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = patches(torch.from_numpy(images), p) @ torch.from_numpy(
        w.reshape(p * p * 3, d))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(2, -1, d),
                               rtol=1e-5, atol=1e-5)


def test_bridge_rejects_params_of_another_config(pair):
    _, jparams, _, _, _, _ = pair
    with pytest.raises(ValueError):
        params_from_jax(jax.tree.map(np.asarray, jparams),
                        get_config("deit-tiny"), device="cpu")


def test_full_width_deit_builds_from_get_config():
    cfg = get_config("deit-tiny")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert params["pos"].shape == (1, 197, 192)
    assert params["patch"]["w"].shape == (16 * 16 * 3, 192)
    assert len(params["blocks"]) == 12 and model.num_freeze_units == 14
