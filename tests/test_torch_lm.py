"""The attention LMs in the port against the JAX package, on the CPU at
reduced size: gemma2-2b/27b, granite-20b, qwen1.5-32b, qwen2-vl-72b and
musicgen-medium. RoPE and M-RoPE, the GQA attention blocks (windows,
softcaps, biases), the gated MLP, the frontend stub, the LM functions,
`ServeEngine.generate`, the flash-kernel route under `use_pallas` and the
`serve_lm` example. Params are JAX's seed-0 init, carried across by
`repro_torch.bridge.params_from_jax`; inputs are numpy arrays from a seed.

Tolerances: fp32 outputs rtol = atol = 1e-4; bf16 3e-2, the prefill /
decode tolerance of tests/test_models.py, held on one block (the two
frameworks round bf16 products in other places, and over layers a one-ulp
flip compounds, as tests/test_torch_rwkv.py shows for rwkv6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core.freeze_plan import FreezePlan as JaxFreezePlan
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models import transformer as jax_transformer
from repro.runtime.serve import ServeEngine as JaxServeEngine
from repro_torch import tree_leaves
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core.freeze_plan import FreezePlan, lm_segments
from repro_torch.examples import serve_lm
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.models import attention, build_model, common, transformer
from repro_torch.runtime.serve import ServeEngine

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
FP32 = dict(dtype="float32", param_dtype="float32")
ATTENTION_LMS = ("gemma2-2b", "gemma2-27b", "granite-20b", "qwen1.5-32b",
                 "qwen2-vl-72b", "musicgen-medium")
# jamba's mamba blocks, qwen3-moe's and kimi-k2's MoE blocks (held to JAX
# in tests/test_torch_moe_mamba.py)
MAMBA_MOE_LMS = ("jamba-1.5-large-398b", "qwen3-moe-30b-a3b",
                 "kimi-k2-1t-a32b")
S = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(B, S, vocab=256, seed=4):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _batch(cfg, B, S, seed=4):
    """Tokens, targets, a mask and, with a frontend, its embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": _tokens(B, S, seed=seed),
             "targets": _tokens(B, S, seed=seed + 1),
             "mask": (np.arange(S)[None] < rng.integers(S // 2, S + 1, (B, 1))
                      ).astype(np.float32)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(arch, dtype_kw=FP32, **kw):
    jcfg = jax_get_reduced(arch).replace(**dtype_kw, **kw)
    cfg = get_reduced(arch).replace(**dtype_kw, **kw)
    jmodel, model = jax_build_model(jcfg), build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module", params=ATTENTION_LMS)
def lm(request):
    return _pair(request.param)


def _jax_layer_caches(jcache, g, num_layers):
    """JAX's stacked caches (a tuple over group offsets of {"attn": {k, v}}
    with leaves [G, ...]) as the port's list of per-layer dicts."""
    return [{"attn": {n: np.asarray(jcache[i % g]["attn"][n])[i // g]
                      for n in ("k", "v")}} for i in range(num_layers)]


def _close_caches(got, jcache, cfg, tol):
    want = _jax_layer_caches(jcache, transformer.group_size(cfg),
                             cfg.num_layers)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for n in ("k", "v"):
            np.testing.assert_allclose(g["attn"][n].float().numpy(),
                                       w["attn"][n].astype(np.float32),
                                       err_msg=n, **tol)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_configs_carry_the_reference_values(arch, size):
    cfg = (get_config if size == "full" else get_reduced)(arch)
    jcfg = (jax_get_config if size == "full" else jax_get_reduced)(arch)
    jfields = {f.name for f in dataclasses.fields(jcfg)}
    for f in dataclasses.fields(cfg):
        assert f.name in jfields, f.name
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert transformer.group_size(cfg) == jax_transformer.group_size(jcfg)
    for i in range(cfg.num_layers):
        assert (cfg.layer_kind(i), cfg.layer_is_moe(i), cfg.layer_window(i)) \
            == (jcfg.layer_kind(i), jcfg.layer_is_moe(i), jcfg.layer_window(i))
    assert (cfg.q_dim, cfg.kv_dim, cfg.expert_ff) == \
        (jcfg.q_dim, jcfg.kv_dim, jcfg.expert_ff)


def test_archs_are_the_references():
    from repro.configs import ARCHS as JAX_ARCHS

    assert ARCHS == JAX_ARCHS


def test_lm_segments_match_jax():
    from repro.core.freeze_plan import lm_segments as jax_lm_segments

    for groups in [(), (False,), (True, True, False, True, False, False)]:
        assert lm_segments(FreezePlan(groups)) == \
            jax_lm_segments(JaxFreezePlan(groups))


# ---------------------------------------------------------------------------
# positions and the frontend


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_and_mrope_match_jax(theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9))
    pos3 = rng.integers(0, 4000, (3, 2, 9))
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta).numpy(),
        np.asarray(jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta)), **FP32_TOL)
    np.testing.assert_allclose(
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), theta,
                           (2, 3, 3)).numpy(),
        np.asarray(jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                          theta, (2, 3, 3))), **FP32_TOL)
    np.testing.assert_array_equal(
        common.rope_freqs(16, theta), jax_common.rope_freqs(16, theta))


def test_mrope_matches_rope_for_text():
    """The reference's test_mrope_matches_rope_for_text: with the same
    position on all three axes M-RoPE is RoPE."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 7, 4, 16)).astype(np.float32))
    pos3 = common.default_mrope_positions(2, 7)
    assert pos3.shape == (3, 2, 7)
    np.testing.assert_array_equal(
        pos3.numpy(), np.asarray(jax_common.default_mrope_positions(2, 7)))
    np.testing.assert_allclose(
        common.apply_mrope(x, pos3, 10000.0, (2, 3, 3)).numpy(),
        common.apply_rope(x, pos3[0], 10000.0).numpy(), rtol=1e-6, atol=1e-6)


def test_rope_keeps_the_input_dtype():
    x = torch.ones((1, 3, 2, 8), dtype=torch.bfloat16)
    out = common.apply_rope(x, torch.arange(3)[None], 10000.0)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_frontend_prefix_matches_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    cfg = model.cfg
    assert params["embed"]["frontend_proj"].shape == (cfg.frontend_dim,
                                                      cfg.d_model)
    batch = _batch(cfg, 2, 6)
    want = jax_common.embed_tokens(jparams["embed"], jmodel.cfg,
                                   jnp.asarray(batch["tokens"]),
                                   jnp.asarray(batch["frontend_embeds"]))
    got = common.embed_tokens(params["embed"], cfg,
                              torch.from_numpy(batch["tokens"]),
                              torch.from_numpy(batch["frontend_embeds"]))
    assert got.shape == (2, cfg.frontend_tokens + 6, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


# ---------------------------------------------------------------------------
# params, init and caches


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sig(v) for v in tree]
    return (tuple(tree.shape), tree.dtype, tree.device.type)


@pytest.mark.parametrize("arch", ATTENTION_LMS)
def test_init_matches_jax_structure_shapes_and_dtypes(arch):
    """The port's own init against JAX's init (bf16, the configs'
    default), its shapes taken by `eval_shape` and bridged as zeros."""
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    bridged = params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), cfg,
        device="cpu")
    own = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert _sig(own) == _sig(bridged)
    assert own["embed"]["tok"].dtype == torch.bfloat16
    assert own["blocks"][0]["ln1"].dtype == torch.float32


def test_bridge_unstacks_groups_of_two_in_layer_order():
    """gemma2's group of 2: layer i is JAX's offset i % 2 of group i // 2,
    bf16 leaves crossing exactly; qwen's biases cross too."""
    jmodel, jparams, model, params = _pair("gemma2-2b", {})
    assert transformer.group_size(model.cfg) == 2
    for i, blk in enumerate(params["blocks"]):
        want = np.asarray(jparams["blocks"][i % 2]["mix"]["wq"][i // 2]
                          .astype(jnp.float32))
        assert blk["mix"]["wq"].dtype == torch.bfloat16
        np.testing.assert_array_equal(blk["mix"]["wq"].float().numpy(), want)
        assert set(blk) == {"ln1", "ln2", "ln1_post", "ln2_post", "mix",
                            "ffn"}
    _, _, _, qwen = _pair("qwen1.5-32b", {})
    assert {"bq", "bk", "bv"} <= set(qwen["blocks"][2]["mix"])


def test_cache_init_and_extension():
    cfg = get_reduced("gemma2-2b")
    caches = transformer.init_lm_cache(cfg, 3, 20, torch.bfloat16,
                                       device="cpu")
    assert len(caches) == cfg.num_layers
    for c in caches:
        for n in ("k", "v"):
            t = c["attn"][n]
            assert t.shape == (3, 20, cfg.num_kv_heads, cfg.head_dim)
            assert t.dtype == torch.bfloat16 and not t.any()
    engine = ServeEngine(build_model(cfg, device="cpu"), max_len=32)
    out = engine._extend_cache(caches, 32)
    assert out[1]["attn"]["v"].shape == (3, 32, cfg.num_kv_heads,
                                         cfg.head_dim)


def test_full_config_counts_gemma2_2b_params():
    """gemma2-2b's 2.61e9 params from the init's own shapes, scaled from a
    one-group, narrow-vocab draw of the same widths."""
    cfg = get_config("gemma2-2b")
    small = cfg.replace(num_layers=2, vocab_size=8, param_dtype="float32")
    params = build_model(small, device="cpu").init(
        torch.Generator().manual_seed(0))
    group = sum(t.numel() for t in tree_leaves(params["blocks"]))
    total = cfg.vocab_size * cfg.d_model + cfg.d_model + 13 * group
    assert 2.60e9 < total < 2.62e9
    # the reference's analytic count leaves out the post-norms and the
    # final norm
    assert total - jax_get_config("gemma2-2b").param_count() == \
        cfg.d_model * (2 * cfg.num_layers + 1)


# ---------------------------------------------------------------------------
# the LM functions against JAX, fp32


def test_prefill_and_decode_match_jax(lm):
    jmodel, jparams, model, params = lm
    cfg = model.cfg
    batch = _batch(cfg, 2, S)
    del batch["targets"], batch["mask"]
    want, jcache = jmodel.prefill(jparams, _jax(batch))
    got, cache = model.prefill(params, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    _close_caches(cache, jcache, cfg, FP32_TOL)

    L = S + cfg.frontend_tokens
    jcache = JaxServeEngine(jmodel)._extend_cache(jcache, L + 4)
    cache = ServeEngine(model)._extend_cache(cache, L + 4)
    nxt = _tokens(2, 1, seed=5)
    want, jcache = jmodel.decode(jparams, jnp.asarray(nxt), jcache,
                                 jnp.int32(L))
    got, cache = model.decode(params, torch.from_numpy(nxt), cache, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    _close_caches(cache, jcache, cfg, FP32_TOL)


def test_features_match_jax_one_per_group(lm):
    jmodel, jparams, model, params = lm
    batch = _batch(model.cfg, 2, S)
    want = jmodel.features(jparams, _jax(batch))
    got = model.features(params, _torch(batch))
    assert len(got) == len(want) == model.num_freeze_units == \
        transformer.num_groups(model.cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32_TOL)


@pytest.mark.parametrize("groups,embed,head", [
    ((), False, False), ((True, False), True, False),
    ((False, True), False, True)])
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-vl-72b"])
def test_lm_loss_value_matches_jax_under_group_plans(arch, groups, embed,
                                                    head):
    """gemma2 runs 2 groups of 2 layers, qwen2-vl 2 groups of 1 with a
    frontend prefix that the loss drops before the head."""
    jmodel, jparams, model, params = _pair(arch)
    assert model.num_freeze_units == 2
    batch = _batch(model.cfg, 2, S)
    jplan = JaxFreezePlan(groups, embed, head) if groups else None
    plan = FreezePlan(groups, embed, head) if groups else None
    want, wm = jmodel.loss(jparams, _jax(batch), jplan)
    got, m = model.loss(params, _torch(batch), plan)
    np.testing.assert_allclose(float(got), float(want), **FP32_TOL)
    np.testing.assert_allclose(float(m["logits_mean"]),
                               float(wm["logits_mean"]), **FP32_TOL)


def test_frozen_group_gets_no_gradient():
    _, _, model, params = _pair("gemma2-2b")
    params = {k: v for k, v in params.items()}
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss(params, _torch(_batch(model.cfg, 2, 8)),
                         FreezePlan((True, False), True, False))
    loss.backward()
    frozen = tree_leaves(params["blocks"][:2]) + tree_leaves(params["embed"])
    assert all(t.grad is None for t in frozen)
    assert all(t.grad is not None for t in tree_leaves(params["blocks"][2:]))


# ---------------------------------------------------------------------------
# the blockwise attention and ROADMAP C.10


BLOCKS = dict(attn_chunk=16, attn_q_block=8, attn_k_block=8)


def _qkv(B, Sq, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, Sq, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Sq, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("Sq", [32, 30])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 50.0)])
def test_attend_blockwise_matches_jax(Sq, window, softcap):
    jcfg = jax_get_reduced("gemma2-2b").replace(
        attn_logit_softcap=softcap, **FP32, **BLOCKS)
    cfg = get_reduced("gemma2-2b").replace(attn_logit_softcap=softcap,
                                           **FP32, **BLOCKS)
    q, k, v = _qkv(2, Sq, 4, 2, 16)
    pos = np.arange(Sq)
    want = jax_attention._attend_blockwise(jcfg, *map(jnp.asarray, (q, k, v)),
                                           jnp.asarray(pos),
                                           jnp.asarray(pos), window)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    got = attention._attend_blockwise(cfg, *args, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    dense = attention._attend_dense(cfg, *args, window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **FP32_TOL)


def test_blockwise_prefill_matches_jax():
    """A 32-token prompt past attn_chunk = 16 prefills through the blocks,
    the window of 12 masking keys on the local layers; a decode after it
    masks the cache by the same window."""
    jmodel, jparams, model, params = _pair("gemma2-2b", sliding_window=12,
                                           **BLOCKS)
    tok = _tokens(2, 32)
    want, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tok)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    jcache = JaxServeEngine(jmodel)._extend_cache(jcache, 40)
    cache = ServeEngine(model)._extend_cache(cache, 40)
    nxt = _tokens(2, 1, seed=7)
    want, _ = jmodel.decode(jparams, jnp.asarray(nxt), jcache, jnp.int32(32))
    got, _ = model.decode(params, torch.from_numpy(nxt), cache, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_blockwise_raises_where_blocks_do_not_split_the_prompt():
    """ROADMAP C.10: at S = 37 the blocks are 37 // (37 // 8) = 9 long, and
    4 of them do not make 37: the reference's reshape raises, and the
    port's raises the same way (no padding)."""
    jcfg = jax_get_reduced("gemma2-2b").replace(**FP32, **BLOCKS)
    cfg = get_reduced("gemma2-2b").replace(**FP32, **BLOCKS)
    q, k, v = _qkv(1, 37, 4, 2, 16)
    pos = np.arange(37)
    with pytest.raises(TypeError):
        jax_attention._attend_blockwise(jcfg, *map(jnp.asarray, (q, k, v)),
                                        jnp.asarray(pos), jnp.asarray(pos), 0)
    with pytest.raises(RuntimeError):
        attention._attend_blockwise(
            cfg, *[torch.from_numpy(a) for a in (q, k, v, pos, pos)], 0)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        model.prefill(params, {"tokens": torch.from_numpy(_tokens(1, 37))})


# ---------------------------------------------------------------------------
# bf16


@pytest.mark.parametrize("arch", ATTENTION_LMS)
@pytest.mark.parametrize("offset", [0, 1])
def test_bf16_block_matches_jax(arch, offset):
    """One attention block in bf16, prefill mode, on the same bf16 input:
    output and cache within 3e-2 (offset 0 is gemma2's local layer)."""
    jmodel, jparams, model, params = _pair(arch, {})
    cfg = model.cfg
    assert params["blocks"][offset]["mix"]["wq"].dtype == torch.bfloat16
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    g = transformer.group_size(cfg)
    jblock = jax.tree.map(lambda a: a[offset // g],
                          jparams["blocks"][offset % g])
    positions = jnp.broadcast_to(jnp.arange(S), (2, S))
    want, jcache, _ = jax_transformer._apply_block(
        jblock, jmodel.cfg, x, offset % g, positions, "prefill", None, None)
    got, cache, _ = transformer._apply_block(
        params["blocks"][offset], cfg, xt, offset % g, "prefill", None,
        torch.arange(S).expand(2, S))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(
            cache["attn"][n].float().numpy(),
            np.asarray(jcache["attn"][n].astype(jnp.float32)), **BF16_TOL)


# ---------------------------------------------------------------------------
# serving


def test_serve_engine_generates_jax_tokens(lm):
    jmodel, jparams, model, params = lm
    prompt = _tokens(2, 12, seed=9)
    want = JaxServeEngine(jmodel, max_len=32).generate(jparams, prompt,
                                                       steps=6)
    engine = ServeEngine(model, max_len=32)
    got, logits = engine.generate(params, prompt, steps=6, return_logits=True)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(logits.argmax(-1), got)
    assert engine.stats.prefill_tokens == 24 and engine.stats.decode_steps == 6


@pytest.mark.parametrize("arch", ATTENTION_LMS)
@pytest.mark.parametrize("dtype_kw,tol", [(FP32, FP32_TOL), ({}, BF16_TOL)],
                         ids=["fp32", "bf16"])
def test_prefill_decode_consistency(arch, dtype_kw, tol):
    """A prefill of S-1 tokens, then a decode of the last one into the
    extended cache, gives the logits of the full prefill."""
    cfg = get_reduced(arch).replace(**dtype_kw)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(2, S, seed=S))
    full, _ = model.prefill(params, {"tokens": tok})
    _, cache = model.prefill(params, {"tokens": tok[:, :-1]})
    cache = ServeEngine(model)._extend_cache(cache, S)
    dec, _ = model.decode(params, tok[:, -1:], cache, S - 1)
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(),
                               **tol)


# ---------------------------------------------------------------------------
# the flash-kernel route


@pytest.fixture
def counted_flash(monkeypatch):
    calls = []
    plain = att_ops.flash_attention

    def counting(*args, **kw):
        calls.append(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(att_ops, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-20b"])
def test_kernel_route_gives_the_plain_result(arch, counted_flash):
    """Under `use_pallas` the prefill and feature forwards take the flash
    wrapper (its plain version on CPU tensors), one call a layer, with
    causal masks, the layer's window and the softcap; the results are the
    plain path's."""
    cfg = get_reduced(arch).replace(**FP32)
    plain = build_model(cfg, device="cpu")
    kern = build_model(cfg.replace(use_pallas=True), device="cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    tok = {"tokens": torch.from_numpy(_tokens(2, S))}
    want, wcache = plain.prefill(params, tok)
    assert not counted_flash
    got, cache = kern.prefill(params, tok)
    assert [c["window"] for c in counted_flash] == \
        [cfg.layer_window(i % transformer.group_size(cfg))
         for i in range(cfg.num_layers)]
    assert all(c["causal"] and c["softcap"] == cfg.attn_logit_softcap
               for c in counted_flash)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tree_leaves(cache), tree_leaves(wcache)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    counted_flash.clear()
    for g, w in zip(kern.features(params, tok), plain.features(params, tok)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert len(counted_flash) == cfg.num_layers


@pytest.mark.parametrize("positions, flash_calls", [
    (np.arange(S) + 5, 1),             # consecutive: the kernel's masks
    (np.repeat(np.arange(S // 2), 2), 0),  # a repeating (M-RoPE-like) axis
    (np.arange(S)[::-1].copy(), 0),
])
def test_kernel_route_needs_consecutive_positions(positions, flash_calls,
                                                  counted_flash):
    """The kernel masks by index, so under `use_pallas` attention takes it
    only where the positions are consecutive; elsewhere the plain path
    runs. Either way the result is the plain path's."""
    cfg = get_reduced("gemma2-2b").replace(**FP32)
    p = attention.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, S, cfg.d_model)).astype(np.float32))
    pos = torch.from_numpy(np.stack([positions, positions]))
    window = 8  # shorter than S, so the window masks keys
    want = attention.attention_train(p, cfg, x, pos, window)
    got = attention.attention_train(p, cfg.replace(use_pallas=True), x, pos,
                                    window)
    assert len(counted_flash) == flash_calls
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_loss_path_stays_plain_under_use_pallas(counted_flash):
    """With grad enabled and params that require it, attention takes the
    plain path (the kernel has no backward), and the loss has gradients."""
    cfg = get_reduced("gemma2-2b").replace(use_pallas=True, **FP32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for t in tree_leaves(params):
        t.requires_grad_(True)
    loss, _ = model.loss(params, _torch(_batch(cfg, 2, S)))
    loss.backward()
    assert not counted_flash
    assert params["blocks"][0]["mix"]["wq"].grad is not None


# ---------------------------------------------------------------------------
# the mamba and MoE architectures and the example


@pytest.mark.parametrize("arch", MAMBA_MOE_LMS)
def test_mamba_and_moe_architectures_build_and_cache(arch):
    """The three archs build, draw their params and their caches: one
    cache a layer, mamba states fp32 and O(1) in length, attention k/v
    in the cache dtype; MoE FFNs hold [E, ...] expert weights."""
    cfg = get_reduced(arch)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    caches = transformer.init_lm_cache(cfg, 1, 8, torch.bfloat16,
                                       device="cpu")
    assert len(params["blocks"]) == len(caches) == cfg.num_layers
    g = transformer.group_size(cfg)
    for i, (blk, c) in enumerate(zip(params["blocks"], caches)):
        kind = cfg.layer_kind(i % g)
        assert set(c) == {"mamba" if kind == "mamba" else "attn"}
        if kind == "mamba":
            assert c["mamba"]["h"].dtype == torch.float32
            assert c["mamba"]["conv"].shape[1] == cfg.mamba_conv - 1
        else:
            assert c["attn"]["k"].shape == (1, 8, cfg.num_kv_heads,
                                            cfg.head_dim)
        if cfg.layer_is_moe(i % g):
            assert blk["ffn"]["wg"].shape == (cfg.num_experts, cfg.d_model,
                                              cfg.expert_ff)
        else:
            assert blk["ffn"]["wg"].shape == (cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("arch", ["gemma2-2b", "musicgen-medium"])
def test_serve_lm_example_runs_on_the_cpu(arch, capsys):
    serve_lm.main(["--arch", arch, "--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={arch}-reduced batch=4 prefill=12 decode=4"
    assert out[1].startswith("generated ids[0]: [") and \
        len(eval(out[1].split(": ", 1)[1])) == 4
    assert "stats=ServeStats(prefill_tokens=48, decode_steps=4)" in out[2]


def test_serve_lm_example_runs_kimi_k2_on_the_cpu(capsys):
    serve_lm.main(["--arch", "kimi-k2-1t-a32b", "--device", "cpu",
                   "--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=kimi-k2-1t-a32b-reduced batch=4 prefill=12 decode=4"
    assert "stats=ServeStats(prefill_tokens=48, decode_steps=4)" in out[2]
