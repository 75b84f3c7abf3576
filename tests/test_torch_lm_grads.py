"""The gradients of the port's `lm_loss` against JAX's, on the CPU at
reduced size, for all ten LM architectures: gemma2-2b/27b, granite-20b,
qwen1.5-32b, qwen2-vl-72b and musicgen-medium with their frontend
embeddings, rwkv6-3b (chunked), jamba (the chunked mamba scan, attention
and MoE), qwen3-moe and kimi-k2 (router, capacity drops and the router aux
term), with no plan and under group plans (a frozen prefix behind a
frozen embedding; a frozen middle or last group with a frozen head).
Params are JAX's seed-0 init in fp32, carried across by
`repro_torch.bridge`; inputs are numpy arrays from a seed. The reference's
loss and gradient are jitted, one compile a plan. The helpers here serve
tests/test_torch_lm_train.py too.

Tolerances: the loss within rtol = atol = 1e-5; each gradient leaf
within 1e-5 + 1e-4 x the largest |g| of JAX's leaf; a frozen leaf's
gradient exactly zero on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.freeze_plan import FreezePlan as JaxFreezePlan
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.core.freeze_plan import FreezePlan
from repro_torch.models import build_model, transformer
from repro_torch.runtime.train_loop import grads_of

FP32 = dict(dtype="float32", param_dtype="float32")
CHUNK = dict(ssm_chunk=8)  # mamba and rwkv: three chunks of a 24-token batch
JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-3b"
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
S = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=2, S=S, seed=4):
    """Tokens, targets, a mask and, with a frontend, its embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "mask": (np.arange(S)[None] < rng.integers(S // 2, S + 1,
                                                        (B, 1))
                      ).astype(np.float32)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_PAIRS = {}


def _pair(arch):
    """(JAX model, JAX params, its jitted value-and-grad, port model,
    bridged params) at reduced size in fp32, once a module; jamba at 16
    layers, two groups of 8."""
    if arch not in _PAIRS:
        kw = dict(**FP32, **CHUNK)
        if arch == JAMBA:
            kw["num_layers"] = 16
        jmodel = jax_build_model(jax_get_reduced(arch).replace(**kw))
        model = build_model(get_reduced(arch).replace(**kw), device="cpu")
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 model.cfg, device="cpu")
        vg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True),
                     static_argnums=2)
        _PAIRS[arch] = (jmodel, jparams, vg, model, params)
    return _PAIRS[arch]


def _plans(G):
    """The plans each arch is held under: none; a frozen prefix behind a
    frozen embedding (the activation gradient stops there); a frozen
    middle (or, with two groups, the last) group and a frozen head."""
    later = tuple(i == min(1, G - 1) for i in range(G))
    return {"none": None,
            "prefix_embed": (tuple(i == 0 for i in range(G)), True, False),
            "middle_head": (later, False, True)}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _named(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _is_frozen(name, cfg, plan) -> bool:
    if plan is None:
        return False
    g = transformer.group_size(cfg)
    parts = name.split("/")
    if parts[1] == "blocks":
        return plan.groups[int(parts[2]) // g]
    if parts[1] == "embed":  # an untied head is frozen by `head` alone
        return plan.head if parts[2] == "head" else plan.embed
    return False


def _hold_grads(got, want, cfg, plan):
    """Every leaf of the port's gradient against JAX's (bridged)."""
    pairs = {n: t for n, t in _named(want)}
    checked = 0
    for name, g in _named(got):
        w = pairs[name].float().numpy()
        g = g.float().numpy()
        if _is_frozen(name, cfg, plan):
            assert not g.any() and not w.any(), f"frozen {name} moved"
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 + 1e-4 * scale, \
            f"{name}: max_abs_err {err:.3g} (max |g| {scale:.3g})"
        checked += 1
    assert checked and len(pairs) == len(_named(got))


@pytest.mark.parametrize("plan_name", ["none", "prefix_embed", "middle_head"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_gradients_match_jax(arch, plan_name):
    jmodel, jparams, vg, model, params = _pair(arch)
    G = model.num_freeze_units
    assert G >= 2
    spec = _plans(G)[plan_name]
    plan = FreezePlan(*spec) if spec else None
    jplan = JaxFreezePlan(*spec) if spec else None
    batch = _batch(model.cfg)
    (want, _), jgrads = vg(jparams, _jax(batch), jplan)
    got, metrics, grads = grads_of(model.loss, params, _torch(batch), plan)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    _hold_grads(grads, params_from_jax(jax.tree.map(np.asarray, jgrads),
                                      model.cfg, device="cpu"),
                model.cfg, plan)
    if model.cfg.num_experts:
        assert float(metrics["aux_loss"]) > 0  # the router term is in it
