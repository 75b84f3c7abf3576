"""BERT in the port against the JAX model: params initialised in JAX,
carried across by `repro_torch.bridge`, and run through `predict`,
`features`, `loss` and its gradients in both packages on the same numpy
token batches.

The reduced model (4 layers, d 64, vocab 512) is held within attention's
tolerance (rtol 2e-4, atol 2e-5) in `predict` and `features`, with and
without the attention kernel (JAX's Pallas kernel in interpret mode, the
port's wrapper taking its plain version on the CPU), and its loss and
gradients under three freeze plans within 1e-5. The full-width bert-base
runs one `predict` and `features` at [2, 32] against the JAX package in
float64. Also: the bridge, the FLOP count against the matmul FLOPs XLA
compiles for the reference (equal under every plan; XLA's whole count
also has elementwise work, ROADMAP C.8), and the probe's CKA route at
the full-width probe shape."""
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core.freeze_plan import LayerFreezePlan as JaxLayerFreezePlan
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import train_loop as jax_train_loop
from repro_torch import tree_leaves, tree_map
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import cka as core_cka
from repro_torch.core.freeze_plan import LayerFreezePlan
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops
from repro_torch.models import bert, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import (TrainStepCache, as_tensor,
                                            grads_of)
from test_torch_train import (_flop_ratio_gaps, _xla_recomputed,
                              _xla_step_flops)

CPU = "cpu"
RTOL, ATOL = 2e-4, 2e-5
GRAD_ATOL = 1e-5
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n, cfg, seq=SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (n, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.num_classes, n).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _reduced(use_pallas):
    """(JAX model, its params, the port's model, the bridged params)."""
    jcfg = jax_get_reduced("bert-base").replace(use_pallas=use_pallas)
    cfg = get_reduced("bert-base").replace(use_pallas=use_pallas)
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device=CPU)
    return jmodel, jparams, model, params


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_predict_matches_jax(use_pallas):
    jmodel, jparams, model, params = _reduced(use_pallas)
    batch = _batch(5, 6, model.cfg)
    want = np.asarray(jmodel.predict(jparams, batch))
    got = model.predict(params, _tensors(batch))
    assert not got.requires_grad and got.is_inference()
    assert got.shape == (6, model.cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_features_match_jax(use_pallas):
    jmodel, jparams, model, params = _reduced(use_pallas)
    batch = _batch(6, 6, model.cfg)
    want = jmodel.features(jparams, batch)
    got = model.features(params, _tensors(batch))
    # the embedding output and one map a block; the head gets no CKA
    assert len(got) == len(want) == model.cfg.num_layers + 1
    assert model.num_freeze_units == model.cfg.num_layers + 2
    for g, w in zip(got, want):
        assert g.shape == (6, SEQ, model.cfg.d_model)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_int64_tokens_give_the_int32_result():
    _, _, model, params = _reduced(False)
    batch = _tensors(_batch(7, 4, model.cfg))
    wide = dict(batch, tokens=batch["tokens"].long())
    assert torch.equal(model.predict(params, batch),
                       model.predict(params, wide))


def test_attention_kernel_serves_forwards_only(monkeypatch):
    """`predict` and `features` route attention through the kernel's
    wrapper under `use_pallas`, one call a block; `loss` never does, so
    the kernel never runs inside a train step."""
    calls = []
    flash = att_ops.flash_attention

    def counting(*a, **k):
        calls.append(a[0].shape)
        return flash(*a, **k)

    monkeypatch.setattr(att_ops, "flash_attention", counting)
    _, _, model, params = _reduced(True)
    batch = _tensors(_batch(8, 4, model.cfg))
    model.predict(params, batch)
    model.features(params, batch)
    L, H = model.cfg.num_layers, model.cfg.num_heads
    assert calls == [(4, SEQ, H, model.cfg.d_model // H)] * (2 * L)
    grads_of(model.loss, params, batch, LayerFreezePlan((False,) * (L + 2)))
    assert len(calls) == 2 * L


PLANS = {
    "all-active": (False,) * 6,
    "prefix-frozen": (True, True, True, False, False, False),
    "all-but-head": (True,) * 5 + (False,),
}


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def _unit(path, n_units):
    if path.startswith("/embed"):
        return 0
    if path.startswith("/blocks"):
        return int(path.split("/")[2]) + 1
    if path.startswith("/head"):
        return n_units - 1
    return None  # the pooler belongs to no unit


@pytest.mark.parametrize("name", sorted(PLANS))
def test_loss_and_gradients_match_jax(name):
    """The loss and every gradient leaf within 1e-5 of JAX's; a leaf is
    zero exactly where JAX's is (frozen units, every unit before the
    first trained one, and the token and position rows the batch does
    not use). The key bias `bk` shifts all of a query's scores by one
    constant, which softmax removes: its gradient is zero in exact
    arithmetic and rounding noise on both sides."""
    jmodel, jparams, model, params = _reduced(False)
    flags = PLANS[name]
    batch = _batch(9, 8, model.cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jax_train_loop.as_jnp(batch),
                              JaxLayerFreezePlan(flags))[0])(jparams)
    loss, metrics, grads = grads_of(model.loss, params,
                                    as_tensor(batch, CPU),
                                    LayerFreezePlan(flags))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = jax.tree.map(np.asarray, jgrads)
    paths = _leaf_paths(want)
    first_trained = flags.index(False)
    for path in paths:
        g, w = _node(grads, path).numpy(), _node(want, path)
        assert g.shape == w.shape, path
        unit = _unit(path, len(flags))
        if unit is not None and (flags[unit] or unit < first_trained):
            assert not g.any() and not w.any(), path
            continue
        if path.endswith("attn/bk"):
            assert np.abs(g).max() <= GRAD_ATOL, path
            assert np.abs(w).max() <= GRAD_ATOL, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=path)
        assert np.abs(w).max() > 0, path
        np.testing.assert_array_equal(g[w == 0], 0, err_msg=path)
    if not flags[0]:
        tok = tree_leaves(grads["embed"]["tok"])[0].numpy()
        used = np.zeros(model.cfg.vocab_size, bool)
        used[batch["tokens"].ravel()] = True
        assert tok[used].any(axis=1).all() and not tok[~used].any()
        assert not grads["embed"]["pos"][SEQ:].any()


def test_bridge_carries_bert_params_and_refuses_others():
    _, jparams, model, params = _reduced(False)
    host = jax.tree.map(np.asarray, jparams)
    for path, t in zip(_leaf_paths(params), tree_leaves(params)):
        assert t.dtype == torch.float32 and t.device.type == CPU
        np.testing.assert_array_equal(t.numpy(), _node(host, path))
    with pytest.raises(ValueError, match="do not fit"):
        params_from_jax(host, get_config("bert-base"), device=CPU)
    with pytest.raises(ValueError, match="do not fit"):
        params_from_jax(host, get_reduced("bert-base").replace(d_ff=256),
                        device=CPU)


def test_init_matches_the_reference_layout():
    cfg = get_reduced("bert-base")
    model = build_model(cfg, device=CPU)
    got = model.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(jax_build_model(jax_get_reduced("bert-base")).init,
                          jax.random.PRNGKey(0))
    assert {p: tuple(_node(got, p).shape) for p in _leaf_paths(got)} == \
        {p: _node(want, p).shape for p in _leaf_paths(want)}
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(again)))
    _, _, full, params, _ = _full_width()
    want = jax.eval_shape(jax_build_model(jax_get_config("bert-base")).init,
                          jax.random.PRNGKey(0))
    assert {p: tuple(_node(params, p).shape) for p in _leaf_paths(want)} \
        == {p: _node(want, p).shape for p in _leaf_paths(want)}
    assert full.num_freeze_units == 14
    assert sum(t.numel() for t in tree_leaves(params)) == 109_496_084


def _node(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _xla_dot_flops(compiled) -> int:
    """2 x output size x contracted size, summed over the `dot`s of a
    compiled XLA program: its matmul FLOPs, the part of its
    `cost_analysis` count that is not elementwise."""
    shapes, total = {}, 0
    lines = compiled.as_text().splitlines()
    for line in lines:
        m = re.match(r"\s*(?:ROOT )?%([\w.\-]+) = \w+\[([\d,]*)\]", line)
        if m:
            shapes[m.group(1)] = [int(v) for v in m.group(2).split(",") if v]
    for line in lines:
        m = re.match(r"\s*(?:ROOT )?%[\w.\-]+ = \w+\[([\d,]*)\].* dot\("
                     r"%([\w.\-]+), .*lhs_contracting_dims=\{([\d,]*)\}", line)
        if m:
            out = [int(v) for v in m.group(1).split(",") if v]
            lhs = shapes[m.group(2)]
            total += 2 * math.prod(out) * math.prod(
                lhs[int(i)] for i in m.group(3).split(","))
    return total


def _xla_grad(jmodel, flags, batch):
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    plan = JaxLayerFreezePlan(flags)
    return jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b, plan)[0])).lower(
        params, jax_train_loop.as_jnp(batch)).compile()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_flop_count_is_xlas_matmul_count(name):
    """Under every plan the matmul part of the port's count of a step
    equals the FLOPs of the `dot`s XLA compiles for the reference's
    gradient, to the FLOP (453,439,488 all active at batch 16 x 32), and
    the whole step's count is within 3% of XLA's count of the reference's
    whole step less the work XLA recomputes (ROADMAP C.8)."""
    cfg = get_reduced("bert-base")
    jmodel = jax_build_model(jax_get_reduced("bert-base"))
    batch = _batch(0, 16, cfg)
    steps = TrainStepCache(build_model(cfg, device=CPU), AdamWConfig())
    flags = PLANS[name]
    plan = LayerFreezePlan(flags)
    whole = steps.flops(plan, batch)
    assert steps.flop_counts[plan].matmul == \
        _xla_dot_flops(_xla_grad(jmodel, flags, batch))
    xla, again = _xla_step_flops(jmodel, JaxAdamWConfig(),
                                 JaxLayerFreezePlan(flags), batch)
    assert whole == pytest.approx(xla - again, rel=0.03)


def test_xla_counts_elementwise_work_faster_than_depth():
    """ROADMAP C.8: XLA's whole count of the gradient adds elementwise
    work (LayerNorm, GELU, softmax backward) to the dots, and on the
    post-LN bert that work grows faster than the depth: 15.9M FLOPs a
    layer outside the dots at one block, 19.1M at two, 23.0M at three
    (batch 16 x 32, reduced widths). The growth is XLA's recomputation:
    less the instructions its fusion pass copies (`_xla_recomputed`,
    which names them), the work grows by the same amount a layer, within
    3% (4,134,200 FLOPs). The port's elementwise count of the same
    gradient grows by one amount a layer, to the FLOP (4,386,112: 6.1%
    more than XLA's, the per-op rules of `runtime/flops.py` against
    XLA's simplified HLO). So the ratios between plans of the port's
    whole-step count and of XLA's count less its recomputation agree
    within 7%, where XLA's whole count parted by 10.5% and 15.6%."""
    from repro.roofline.analysis import cost_analysis_dict
    from repro_torch.runtime.flops import count_flops

    cfg = get_reduced("bert-base")
    batch = _batch(0, 16, cfg)
    extra, kept, port = [], [], []
    for layers in (1, 2, 3):
        flags = (False,) * (layers + 2)
        jmodel = jax_build_model(jax_get_reduced("bert-base").replace(
            num_layers=layers))
        compiled = _xla_grad(jmodel, flags, batch)
        again, copies = _xla_recomputed(compiled)
        assert copies and all(name for name, _ in copies)
        extra.append(cost_analysis_dict(compiled)["flops"]
                     - _xla_dot_flops(compiled))
        kept.append(extra[-1] - again)
        model = build_model(cfg.replace(num_layers=layers), device=CPU)
        meta = tree_map(lambda t: torch.empty_like(t, device="meta"),
                        model.init(torch.Generator()))
        mbatch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype,
                                 device="meta") for k, v in batch.items()}
        port.append(count_flops(grads_of, model.loss, meta, mbatch,
                                LayerFreezePlan(flags)).elementwise)
    per_layer = [e / n for n, e in zip((1, 2, 3), extra)]
    assert 0 < per_layer[0] < per_layer[1] < per_layer[2]
    step = [kept[1] - kept[0], kept[2] - kept[1]]
    assert step[1] == pytest.approx(step[0], rel=0.03)
    assert port[2] - port[1] == port[1] - port[0]
    assert port[1] - port[0] == pytest.approx(step[0], rel=0.07)
    gaps, _ = _flop_ratio_gaps(jax_get_reduced("bert-base"), cfg, batch)
    assert max(gaps) < 0.07


@functools.lru_cache(maxsize=None)
def _full_width():
    """Full-width bert-base in both packages from the JAX init, and a
    [2, 32] token batch."""
    jcfg, cfg = jax_get_config("bert-base"), get_config("bert-base")
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device=CPU)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = params_from_jax(jparams, cfg, device=CPU)
    return jmodel, jparams, model, params, _batch(3, 2, cfg)


def test_full_width_matches_jax_in_float64():
    """`predict` and the 13 feature maps of the full-width model at
    [2, 32], each package in float32 and float64 from the same params
    (the JAX side under `jax.enable_x64`). Both take LayerNorm in float32
    whatever the input dtype, and the port its attention core too, so
    the float64 runs agree only to float32 rounding: the port's float64
    run is held within 1e-6 of the largest entry of JAX's (measured
    3.5e-7), and the port's float32 run within 4 times JAX's own float32
    error against JAX's float64 run, plus 1e-6 of the largest entry for
    the embedding's map, which both packages' float32 runs reach through
    the same float32 LayerNorm (JAX's own error there is 0, the port's
    7.2e-7; elsewhere at most 1.14 times JAX's)."""
    jmodel, jparams, model, params, batch = _full_width()

    def jax_run(dtype):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), jparams)
        jb = {"tokens": jnp.asarray(batch["tokens"])}
        return [np.asarray(jmodel.predict(p, jb), np.float64)] + \
            [np.asarray(f, np.float64) for f in jmodel.features(p, jb)]

    def port_run(dtype):
        p = tree_map(lambda t: t.to(dtype), params)
        tb = {"tokens": torch.from_numpy(batch["tokens"])}
        return [model.predict(p, tb).double().numpy()] + \
            [f.double().numpy() for f in model.features(p, tb)]

    jax32, port32, port64 = jax_run(jnp.float32), port_run(torch.float32), \
        port_run(torch.float64)
    with jax.enable_x64(True):
        jax64 = jax_run(jnp.float64)
    assert len(jax64) == 1 + 13 and jax64[0].shape == (2, 20)
    for i, (g64, g32, j32, ref) in enumerate(zip(port64, port32, jax32,
                                                 jax64)):
        assert g64.shape == g32.shape == ref.shape
        np.testing.assert_allclose(g64, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"output {i}")
        own, err = np.abs(j32 - ref).max(), np.abs(g32 - ref).max()
        assert err <= 4 * own + 1e-6 * np.abs(ref).max(), (i, own, err)


def test_probe_maps_at_full_width_take_the_example_route(monkeypatch):
    """A probe pass of the full-width model on a batch of 16 x 32 tokens
    runs one CKA a map, 13, each on n = 512 rows of d = 768: dx + dy =
    1536 > n, so every one takes the kernel's example route."""
    _, _, model, params, _ = _full_width()
    batch = _tensors(_batch(4, 16, model.cfg))
    routes = []
    terms = cka_ops.cka_terms

    def counting(x, y):
        routes.append((x.shape, cka_ops.feature_route(
            x.shape[0], x.shape[1], y.shape[1])))
        return terms(x, y)

    monkeypatch.setattr(cka_ops, "cka_terms", counting)
    feats = model.features(params, batch)
    sims = core_cka.layerwise_cka(feats, feats, use_kernel=True)
    assert routes == [((512, 768), False)] * 13
    np.testing.assert_allclose([float(s) for s in sims], 1.0, atol=1e-5)
    assert bert.MAX_POS == 512
