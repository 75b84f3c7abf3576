"""The mamba and MoE blocks in the port against the JAX package, on the
CPU at reduced size: `models/mamba.py`, `models/moe.py` and the LMs built
from them, jamba (mamba, attention and MoE in groups of 8), qwen3-moe and
kimi-k2. Params are JAX's seed-0 init, carried across by
`repro_torch.bridge.params_from_jax`; inputs are numpy arrays from a seed.

Tolerances: fp32 rtol = atol = 1e-4 (tests/test_torch_lm.py); bf16 3e-2,
held on one block. The port's in-chunk scan sums in another order than
JAX's `associative_scan`, so the scan agrees to rounding. The models run
at `ssm_chunk` 8, so a 24-token prompt is three chunks and the state
carried between chunks is held too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.freeze_plan import FreezePlan as JaxFreezePlan
from repro.models import build_model as jax_build_model
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.runtime.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.core.freeze_plan import FreezePlan
from repro_torch.models import build_model, mamba, moe, transformer
from repro_torch.runtime.serve import ServeEngine

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
FP32 = dict(dtype="float32", param_dtype="float32")
CHUNK = dict(ssm_chunk=8)
JAMBA, QWEN3, KIMI = ("jamba-1.5-large-398b", "qwen3-moe-30b-a3b",
                      "kimi-k2-1t-a32b")
ARCHS = (JAMBA, QWEN3, KIMI)
S = 24

# the reference's functions, jitted: one compile a call site instead of a
# compile for every op and every mamba layer's chunk scan, eagerly
jax_mamba_train = jax.jit(jax_mamba.mamba_train, static_argnums=(1, 3, 4))
jax_mamba_decode = jax.jit(jax_mamba.mamba_decode, static_argnums=1)
jax_moe_ffn = jax.jit(jax_moe.moe_ffn, static_argnums=1)
jax_apply_block = jax.jit(jax_transformer._apply_block,
                          static_argnums=(1, 3, 5))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(B, S, seed=4):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _randn(shape, seed=3):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jitted(jmodel):
    return dataclasses.replace(
        jmodel, init=jax.jit(jmodel.init),
        loss=jax.jit(jmodel.loss, static_argnums=2),
        features=jax.jit(jmodel.features), prefill=jax.jit(jmodel.prefill),
        decode=jax.jit(jmodel.decode))


def _pair(arch, dtype_kw=FP32, **kw):
    jcfg = jax_get_reduced(arch).replace(**dtype_kw, **kw)
    cfg = get_reduced(arch).replace(**dtype_kw, **kw)
    jmodel = _jitted(jax_build_model(jcfg))
    model = build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jmodel, jparams, model, params


_PAIRS = {}


def _cached_pair(arch, bf16=False):
    """The pair at ssm_chunk 8, made once a module; jamba at 16 layers,
    two groups of 8. In bf16 (the configs' default dtypes) JAX's params
    are its fp32 init cast to the bf16 init's leaf dtypes, which is what
    the bf16 init draws (fp32 normals times a scale, then cast)."""
    if (arch, bf16) not in _PAIRS:
        kw = dict(num_layers=16) if arch == JAMBA else {}
        if not bf16:
            _PAIRS[arch, bf16] = _pair(arch, **CHUNK, **kw)
        else:
            jcfg = jax_get_reduced(arch).replace(**CHUNK, **kw)
            cfg = get_reduced(arch).replace(**CHUNK, **kw)
            jmodel = _jitted(jax_build_model(jcfg))
            shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
            jparams = jax.tree.map(lambda a, s: a.astype(s.dtype),
                                   _cached_pair(arch)[1], shapes)
            params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
            _PAIRS[arch, bf16] = (jmodel, jparams,
                                  build_model(cfg, device="cpu"), params)
    return _PAIRS[arch, bf16]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _cached_pair(request.param)


def _jax_block(jparams, cfg, layer):
    """JAX's params of `layer` (offset layer % g of group layer // g)."""
    g = transformer.group_size(cfg)
    return jax.tree.map(lambda a: a[layer // g],
                        jparams["blocks"][layer % g])


def _close(got, want, tol, err_msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=err_msg, **tol)


def _close_caches(got, jcache, cfg, tol):
    """The port's per-layer caches against JAX's stacked ones."""
    g = transformer.group_size(cfg)
    assert len(got) == cfg.num_layers
    for i, c in enumerate(got):
        want = jax.tree.map(lambda a: a[i // g], jcache[i % g])
        assert set(c) == set(want), i
        for kind, leaves in c.items():
            for name, t in leaves.items():
                _close(t, want[kind][name], tol, f"layer {i} {kind}.{name}")


# ---------------------------------------------------------------------------
# init and the bridge


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sig(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_structure_shapes_and_dtypes(arch):
    """The port's own init against JAX's (bf16, the configs' default),
    JAX's shapes bridged as zeros: the router, `dt_proj`, `dt_bias`,
    `A_log` and `D_skip` fp32, the rest bf16."""
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    bridged = params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), cfg,
        device="cpu")
    own = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert _sig(own) == _sig(bridged)
    moe_blk = next(b for b in own["blocks"] if "router" in b["ffn"])
    assert moe_blk["ffn"]["router"].dtype == torch.float32
    assert moe_blk["ffn"]["wd"].dtype == torch.bfloat16
    if arch == JAMBA:
        mix = own["blocks"][0]["mix"]
        assert {n: mix[n].dtype for n in ("dt_proj", "dt_bias", "A_log",
                                          "D_skip", "in_proj")} == {
            "dt_proj": torch.float32, "dt_bias": torch.float32,
            "A_log": torch.float32, "D_skip": torch.float32,
            "in_proj": torch.bfloat16}


def test_bridge_carries_expert_and_mamba_leaves_in_layer_order():
    """jamba's group of 8: layer i is JAX's offset i % 8 of group i // 8;
    [G, E, ...] expert leaves cross as [E, ...] in bf16 and the fp32
    mamba leaves as fp32, exactly. Two groups, so the order shows."""
    jmodel, jparams, model, params = _cached_pair(JAMBA, bf16=True)
    cfg = model.cfg
    assert transformer.group_size(cfg) == 8 and len(params["blocks"]) == 16
    for i, blk in enumerate(params["blocks"]):
        want = _jax_block(jparams, cfg, i)
        if cfg.layer_is_moe(i % 8):
            assert blk["ffn"]["wg"].dtype == torch.bfloat16
            assert blk["ffn"]["wg"].shape == (cfg.num_experts, cfg.d_model,
                                              cfg.expert_ff)
            np.testing.assert_array_equal(
                blk["ffn"]["wg"].float().numpy(),
                np.asarray(want["ffn"]["wg"].astype(jnp.float32)))
        if cfg.layer_kind(i % 8) == "mamba":
            assert blk["mix"]["A_log"].dtype == torch.float32
            np.testing.assert_array_equal(blk["mix"]["dt_proj"].numpy(),
                                          np.asarray(want["mix"]["dt_proj"]))


# ---------------------------------------------------------------------------
# the MoE layer


def _jax_kept(jp, jcfg, xt, capacity):
    """JAX's routing step by step, as `repro.models.moe._moe_dispatch`
    writes it: each expert's set of kept tokens (positive gate among its
    C strongest)."""
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    gates, eidx = jax.lax.top_k(probs, jcfg.experts_per_token)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    T = xt.shape[0]
    gate_te = jnp.zeros((T, jcfg.num_experts)).at[
        jnp.arange(T)[:, None], eidx].set(gates)
    gval, tok = jax.lax.top_k(gate_te.T, capacity)
    gval, tok = np.asarray(gval), np.asarray(tok)
    return [set(tok[e][gval[e] > 0].tolist()) for e in range(len(tok))]


@pytest.mark.parametrize("arch,layer,capacity_factor", [
    (QWEN3, 0, 1.25), (QWEN3, 1, 0.5), (JAMBA, 1, 0.5)])
def test_moe_ffn_matches_jax_with_drops(arch, layer, capacity_factor):
    """The layer's output and aux loss within 1e-4, and each expert's set
    of kept tokens equal to JAX's. At capacity factor 0.5 pairs are
    dropped for want of slots (qwen3-moe: C = 8 slots an expert for 96
    routed pairs over 8 experts); at 1.25 (C = 15) where the random
    router overflows an expert (qwen3-moe's layer drops 3)."""
    jmodel, jparams, model, params = _cached_pair(arch)
    jcfg = jmodel.cfg.replace(capacity_factor=capacity_factor)
    cfg = model.cfg.replace(capacity_factor=capacity_factor)
    jp = _jax_block(jparams, jcfg, layer)["ffn"]
    p = params["blocks"][layer]["ffn"]
    x = _randn((2, S, cfg.d_model))
    want, want_aux = jax_moe_ffn(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    _close(got, want, FP32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **FP32_TOL)

    T = 2 * S
    C = moe.moe_capacity(cfg, T)
    assert C == jax_moe.moe_capacity(jcfg, T)
    _, _, tok_idx, gval = moe.route(p, cfg, torch.from_numpy(x).reshape(T, -1),
                                    C)
    kept = moe.kept_pairs(tok_idx, gval, T)
    assert [set(kept[:, e].nonzero().flatten().tolist())
            for e in range(cfg.num_experts)] == \
        _jax_kept(jp, jcfg, jnp.asarray(x).reshape(T, -1), C)
    routed = T * cfg.experts_per_token
    dropped = routed - int(kept.sum())
    assert dropped >= routed - cfg.num_experts * C
    if capacity_factor == 0.5:
        assert routed - cfg.num_experts * C > 0


def test_moe_capacity_matches_jax():
    jcfg, cfg = jax_get_reduced(QWEN3), get_reduced(QWEN3)
    for T in (1, 4, 7, 48, 2048):
        assert moe.moe_capacity(cfg, T) == jax_moe.moe_capacity(jcfg, T)


# ---------------------------------------------------------------------------
# the mamba block


@pytest.mark.parametrize("S_,chunk", [(24, 8), (30, 16), (32, 16)])
def test_mamba_train_matches_jax(S_, chunk):
    """Prefill output and final state (h, conv) within 1e-4: three chunks
    of 8, one chunk of 30 (not a power of two), two of 16. Then three
    `mamba_decode` steps from that state, output and state."""
    jmodel, jparams, model, params = _cached_pair(JAMBA)
    jp, p = _jax_block(jparams, jmodel.cfg, 0)["mix"], \
        params["blocks"][0]["mix"]
    x = _randn((2, S_, model.cfg.d_model))
    want, jstate = jax_mamba_train(jp, jmodel.cfg, jnp.asarray(x),
                                         chunk, return_state=True)
    got, state = mamba.mamba_train(p, model.cfg, torch.from_numpy(x), chunk,
                                   return_state=True)
    _close(got, want, FP32_TOL)
    for name in ("h", "conv"):
        assert state[name].dtype == torch.float32
        _close(state[name], jstate[name], FP32_TOL, name)
    for t in range(3):
        xd = _randn((2, 1, model.cfg.d_model), seed=10 + t)
        want, jstate = jax_mamba_decode(jp, jmodel.cfg,
                                              jnp.asarray(xd), jstate)
        got, state = mamba.mamba_decode(p, model.cfg, torch.from_numpy(xd),
                                        state)
        _close(got, want, FP32_TOL, f"decode step {t}")
        for name in ("h", "conv"):
            _close(state[name], jstate[name], FP32_TOL, f"step {t} {name}")


def test_scan_is_the_sequential_recurrence():
    """The log-depth scan against the recurrence token by token, in
    float64, over a length that is not a power of two."""
    rng = np.random.default_rng(0)
    a = -torch.from_numpy(rng.uniform(0, 2, (2, 13, 3, 4)))
    b = torch.from_numpy(rng.normal(size=(2, 13, 3, 4)))
    a_cum, b_cum = mamba._scan(a, b)
    h, s = torch.zeros_like(b[:, 0]), torch.zeros_like(a[:, 0])
    for t in range(13):
        h = torch.exp(a[:, t]) * h + b[:, t]
        s = s + a[:, t]
        torch.testing.assert_close(b_cum[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(a_cum[:, t], s, rtol=1e-12, atol=1e-12)


def test_softplus_is_jaxs_above_torchs_threshold():
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.9, 20.1, 25.0, 60.0], np.float32)
    np.testing.assert_allclose(
        mamba._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------
# ROADMAP C.11 and C.12, pinned on both sides


@pytest.mark.parametrize("S_,raises", [(32, False), (30, False), (12, False),
                                       (37, True)])
def test_mamba_raises_where_chunks_do_not_split_the_prompt(S_, raises):
    """C.11: at chunk 16, S = 37 makes 2 chunks of 18, which do not make
    37; the reference's reshape raises (TypeError) and the port's raises
    the same way (RuntimeError), no padding. 32, 30 and 12 pass."""
    jmodel, jparams, model, params = _cached_pair(JAMBA)
    jp, p = _jax_block(jparams, jmodel.cfg, 0)["mix"], \
        params["blocks"][0]["mix"]
    x = _randn((1, S_, model.cfg.d_model))
    if raises:
        with pytest.raises(TypeError):
            jax_mamba_train(jp, jmodel.cfg, jnp.asarray(x), 16)
        with pytest.raises(RuntimeError):
            mamba.mamba_train(p, model.cfg, torch.from_numpy(x), 16)
    else:
        want, _ = jax_mamba_train(jp, jmodel.cfg, jnp.asarray(x), 16)
        got, _ = mamba.mamba_train(p, model.cfg, torch.from_numpy(x), 16)
        _close(got, want, FP32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_a_two_token_prefill(arch):
    """C.12: after a prefill of 2 < mamba_conv - 1 tokens, jamba's conv
    state holds 1 row, and its decode raises on both sides (JAX
    ValueError, torch RuntimeError); qwen3-moe and kimi-k2, which have no
    mamba block, generate the reference's tokens."""
    jmodel, jparams, model, params = _cached_pair(arch)
    prompt = _tokens(2, 2, seed=8)
    if arch == JAMBA:
        with pytest.raises(ValueError):
            JaxServeEngine(jmodel, max_len=8).generate(jparams, prompt,
                                                       steps=2)
        with pytest.raises(RuntimeError):
            ServeEngine(model, max_len=8).generate(params, prompt, steps=2)
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)})
        assert cache[0]["mamba"]["conv"].shape[1] == 1
    else:
        want = JaxServeEngine(jmodel, max_len=8).generate(jparams, prompt,
                                                          steps=3)
        got = ServeEngine(model, max_len=8).generate(params, prompt, steps=3)
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the LM functions against JAX, fp32


def test_prefill_and_decode_match_jax(lm):
    jmodel, jparams, model, params = lm
    tok = _tokens(2, S)
    want, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tok)})
    _close(got, want, FP32_TOL)
    _close_caches(cache, jcache, model.cfg, FP32_TOL)

    jcache = JaxServeEngine(jmodel)._extend_cache(jcache, S + 4)
    cache = ServeEngine(model)._extend_cache(cache, S + 4)
    for t in range(2):
        nxt = _tokens(2, 1, seed=5 + t)
        want, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache,
                                     jnp.int32(S + t))
        got, cache = model.decode(params, torch.from_numpy(nxt), cache, S + t)
        _close(got, want, FP32_TOL, f"decode {t}")
    _close_caches(cache, jcache, model.cfg, FP32_TOL)


def test_serve_engine_generates_jax_tokens(lm):
    jmodel, jparams, model, params = lm
    prompt = _tokens(2, 12, seed=9)
    want = JaxServeEngine(jmodel, max_len=32).generate(jparams, prompt,
                                                       steps=6)
    engine = ServeEngine(model, max_len=32)
    got, logits = engine.generate(params, prompt, steps=6, return_logits=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(logits.argmax(-1), got)


def test_features_match_jax_one_per_group(lm):
    jmodel, jparams, model, params = lm
    tok = {"tokens": _tokens(2, S)}
    want = jmodel.features(jparams, {k: jnp.asarray(v) for k, v in
                                     tok.items()})
    got = model.features(params, {k: torch.from_numpy(v) for k, v in
                                  tok.items()})
    assert len(got) == len(want) == model.num_freeze_units == \
        transformer.num_groups(model.cfg)
    for g, w in zip(got, want):
        _close(g, w, FP32_TOL)


@pytest.mark.parametrize("arch,plan", [
    (JAMBA, None), (JAMBA, ((True, False), True, False)), (QWEN3, None),
    (QWEN3, ((True, False), True, False)), (QWEN3, ((False, True), False,
                                                    True))],
    ids=["jamba-none", "jamba-front-frozen", "qwen3-none",
         "qwen3-front-frozen", "qwen3-back-frozen"])
def test_lm_loss_with_aux_matches_jax_under_group_plans(arch, plan):
    """The first value is loss + router_aux_coef * aux, as JAX's; aux, the
    summed router losses, is in the metrics. jamba runs 2 groups of 8
    (16 layers), qwen3-moe 2 groups of 1."""
    jmodel, jparams, model, params = _cached_pair(arch)
    assert model.num_freeze_units == 2
    rng = np.random.default_rng(4)
    batch = {"tokens": _tokens(2, S), "targets": _tokens(2, S, seed=5),
             "mask": (np.arange(S)[None] < rng.integers(S // 2, S + 1, (2, 1))
                      ).astype(np.float32)}
    jplan = JaxFreezePlan(*plan) if plan else None
    tplan = FreezePlan(*plan) if plan else None
    want, wm = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jplan)
    got, m = model.loss(params, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, tplan)
    np.testing.assert_allclose(float(got), float(want), **FP32_TOL)
    for name in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(m[name]), float(wm[name]),
                                   err_msg=name, **FP32_TOL)
    assert float(m["aux_loss"]) > 0
    np.testing.assert_allclose(
        float(got), float(m["loss"]) + model.cfg.router_aux_coef
        * float(m["aux_loss"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# bf16, one block


@pytest.mark.parametrize("arch,layer", [(JAMBA, 1), (JAMBA, 4), (QWEN3, 0)],
                         ids=["jamba-mamba-moe", "jamba-attn-mlp",
                              "qwen3-attn-moe"])
def test_bf16_block_matches_jax(arch, layer):
    """One block in bf16, prefill mode, on the same bf16 input: output,
    router loss and cache within 3e-2."""
    jmodel, jparams, model, params = _cached_pair(arch, bf16=True)
    cfg = model.cfg
    g = transformer.group_size(cfg)
    x = jnp.asarray(_randn((2, S, cfg.d_model))).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    positions = jnp.broadcast_to(jnp.arange(S), (2, S))
    want, jcache, want_aux = jax_apply_block(
        _jax_block(jparams, cfg, layer), jmodel.cfg, x, layer % g, positions,
        "prefill", None, None)
    got, cache, aux = transformer._apply_block(
        params["blocks"][layer], cfg, xt, layer % g, "prefill", None,
        torch.arange(S).expand(2, S))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    if cfg.layer_is_moe(layer % g):
        np.testing.assert_allclose(float(aux), float(want_aux), **BF16_TOL)
    else:  # a dense FFN has no router loss: None here, 0 in JAX
        assert aux is None and float(want_aux) == 0.0
    for kind, leaves in cache.items():
        for name, t in leaves.items():
            _close(t, jcache[kind][name], BF16_TOL, f"{kind}.{name}")


# ---------------------------------------------------------------------------
# serving


def test_cache_extension_leaves_mamba_states_alone():
    """`ServeEngine._extend_cache` pads the attention layer's k/v to
    max_len and hands every mamba state (h, conv) back as it is."""
    _, _, model, params = _cached_pair(JAMBA)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(
        _tokens(2, 12))})
    out = ServeEngine(model)._extend_cache(cache, 40)
    g = transformer.group_size(model.cfg)
    for i, (before, after) in enumerate(zip(cache, out)):
        if model.cfg.layer_kind(i % g) == "mamba":
            for name in ("h", "conv"):
                assert after["mamba"][name] is before["mamba"][name]
        else:
            assert after["attn"]["k"].shape[1] == 40
            assert torch.equal(after["attn"]["k"][:, :12],
                               before["attn"]["k"])


def test_kernel_route_takes_flash_once_a_jamba_prefill(monkeypatch):
    """Under `use_pallas` a jamba prefill takes the flash wrapper once a
    group, on its attention layer at offset 4, and gives the plain
    result."""
    from repro_torch.kernels.attention import ops as att_ops

    calls = []
    plain_flash = att_ops.flash_attention

    def counting(*args, **kw):
        calls.append(kw)
        return plain_flash(*args, **kw)

    monkeypatch.setattr(att_ops, "flash_attention", counting)
    _, _, model, params = _cached_pair(JAMBA)
    kern = build_model(model.cfg.replace(use_pallas=True), device="cpu")
    tok = {"tokens": torch.from_numpy(_tokens(2, S))}
    want, _ = model.prefill(params, tok)
    assert not calls
    got, _ = kern.prefill(params, tok)
    assert len(calls) == 2 and all(c["causal"] for c in calls)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _moe_pair():
    jcfg = jax_get_reduced("qwen3-moe-30b-a3b").replace(**FP32)
    cfg = get_reduced("qwen3-moe-30b-a3b").replace(**FP32)
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                   (4, 16, jcfg.d_model)))
    return jcfg, cfg, jp, p, x


def test_group_local_dispatch_matches_reference():
    """`_moe_dispatch(groups=2)`: experts pick their capacity within each
    group (reference `moe.py:88-112`), at 1e-5 of the reference's; at
    ample capacity it is the global route (`tests/test_moe.py:28`)."""
    jcfg, cfg, jp, p, x = _moe_pair()
    for groups, cap in ((2, 32), (2, 8), (1, 64)):
        want, waux = jax_moe._moe_dispatch(jp, jcfg, jnp.asarray(x),
                                           groups=groups, capacity=cap)
        got, aux = moe._moe_dispatch(p, cfg, torch.from_numpy(x),
                                     groups=groups, capacity=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=f"{groups} {cap}")
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    local, _ = moe._moe_dispatch(p, cfg, torch.from_numpy(x), groups=2,
                                 capacity=32)
    glob, _ = moe._moe_dispatch(p, cfg, torch.from_numpy(x), groups=1,
                                capacity=64)
    np.testing.assert_allclose(local.numpy(), glob.numpy(), rtol=0,
                               atol=1e-5)


_LOCAL_RANK = """
from repro_torch.configs import get_reduced
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe

cfg = get_reduced("qwen3-moe-30b-a3b").replace(dtype="float32",
                                               param_dtype="float32")
p = {k: torch.from_numpy(inp[k]) for k in ("router", "wg", "wu", "wd")}
x = torch.from_numpy(inp["x"])
mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
half = x.shape[0] // 2
out = {}
for name, c in (("local", cfg.replace(moe_local_dispatch=True)),
                ("global", cfg)):
    with torch.no_grad(), spmd.step(mesh):
        y, aux = moe.moe_ffn(p, c, x[rank * half:(rank + 1) * half])
    out[name] = [y.tolist(), float(aux)]
"""


def test_moe_ffn_reads_the_data_axis_only_under_local_dispatch(tmp_path):
    """`moe_ffn` in the sharded step on a (data, model) = (2, 1) gloo
    world, each rank its half of the batch: under
    `cfg.moe_local_dispatch` every expert picks its capacity within its
    rank's tokens (`_moe_dispatch(groups=2)`, the reference's group-local
    routing, on the whole batch), else within the whole batch's
    (`groups=1`); outside a sharded step the flag is not read and routing
    is global."""
    from torch_ranks import run_ranks

    _, cfg, _, p, x = _moe_pair()
    local = cfg.replace(moe_local_dispatch=True)
    xt = torch.from_numpy(x)
    glob, gaux = moe._moe_dispatch(p, cfg, xt, groups=1,
                                   capacity=moe.moe_capacity(cfg, 64))
    out, aux = moe.moe_ffn(p, local, xt)   # no sharded step
    assert torch.equal(out, glob) and torch.equal(aux, gaux)

    cap = max(8, moe.moe_capacity(cfg, 64) // 2)
    want = {"local": moe._moe_dispatch(p, cfg, xt, groups=2, capacity=cap),
            "global": (glob, gaux)}
    outs = run_ranks(2, _LOCAL_RANK, {"x": x, **{k: v.numpy() for k, v in
                                                 p.items()}}, tmp_path)
    for name, (w, waux) in want.items():
        got = np.concatenate([np.asarray(o[name][0], np.float32)
                              for o in outs])
        np.testing.assert_array_equal(got, w.numpy(), err_msg=name)
        assert all(o[name][1] == float(waux) for o in outs), name
    # the two routings part on these tokens
    assert not torch.equal(want["local"][0], glob)
