"""The sharded LM step (`repro_torch.distributed.spmd`, run by
`launch/train.py::_loss_and_grads` and the dry run) on gloo worlds of 4
((data, model) = (2, 2)) and 8 ((2, 4)) against the JAX package, for
reduced gemma2-2b (GQA: its 2 KV heads do not divide a `model` of 4),
qwen3-moe (experts on `model`, global routing over the data axes),
rwkv6-3b (its heads on `model`) and jamba (mamba channels, attention and
MoE), and on a world of 8 with two data axes ((pod, data, model) =
(2, 2, 2): the data shards pod-major) for qwen3-moe, in fp32, from the
JAX package's seed-0 params bridged as tests/test_torch_launch.py
bridges them, on a batch of 4 rows:

- the loss and every gradient leaf (gathered whole for the comparison)
  against the reference's `jax.value_and_grad` on the same params and
  batch, with no plan and under a frozen prefix behind a frozen
  embedding, at tests/test_torch_lm_grads.py's tolerances (the loss
  within rtol = atol = 1e-5; each leaf within 1e-5 + 1e-4 x the largest
  |g|; a frozen leaf's gradient exactly zero); each gradient placed as
  its param is;
- a frozen leaf sends nothing (ROADMAP C.17): it reaches `spmd.use`
  detached, and the step runs one gradient redistribute (DTensor's
  `Redistribute.backward`: the reduce-scatter or all-reduce over the data
  axes) for each use of an active leaf and none for a frozen one;
- no param is gathered whole: `DTensor.full_tensor` is not called in the
  step, and every all-gather the step issues (gemma2-2b on the world of 8)
  is at most one param's use-time size (its FSDP shards gathered, its
  `model` shard kept), their sum at most the params' use-time sizes and
  below their whole sizes;
- a decode of one row, whose rows the data axes do not split, gathers no
  FSDP shard of a weight (`spmd.matmul`): no DTensor redistribute, every
  all-gather and all-reduce at most one token's widest activation; a
  decode whose rows are split still gathers at each use; a step whose
  rows are not split (every rank on the whole batch) gives the
  reference's loss and gradients;
- remat full and dots (gemma2-2b): the recompute's gathers and
  collectives give remat none's loss and gradient shards bitwise;
- serving on the same meshes: `lm_prefill`'s logits, and one `lm_decode`
  step's logits and new caches on a cache placed by `cache_specs` (the
  batch over the data axes, or for a batch of one the sequence; KV heads
  or hd over `model`), against the reference's `prefill` and `decode` on
  the same params, tokens and caches within the serving tests'
  rtol = atol = 1e-4, and against the port's plain path within 1e-6 +
  1e-5 x their largest |value| (the sums over `model` add in another
  order);
- MoE dispatch on the shards, global and group-local, against the
  reference's `_moe_dispatch` of the whole batch on the same params and
  tokens (outputs within tests/test_torch_moe_mamba.py's atol 1e-5, the
  aux loss within rtol 1e-6) and against the port's, the same pairs
  dropped; the kernels refusing a DTensor; and
  `examples/train_sharded.run` on the (2, 2) world against the plain
  loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.freeze_plan import FreezePlan as JaxFreezePlan
from repro.models import moe as jax_moe
from repro_torch import tree_leaves, tree_map
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import ckpt
from repro_torch.core.freeze_plan import FreezePlan
from repro_torch.models import transformer as T
from test_torch_lm_grads import (JAMBA, LOSS_TOL, RWKV, _batch, _hold_grads,
                                 _jax, _named, _pair, _plans,
                                 one_torch_thread)  # noqa: F401
from torch_ranks import run_ranks

ARCHS4 = ("gemma2-2b", "qwen3-moe-30b-a3b", RWKV, JAMBA)
QWEN3 = "qwen3-moe-30b-a3b"
# world: (mesh shape, archs); the mesh's axes are the last of
# (pod, data, model)
WORLDS = {"4": ((2, 2), ARCHS4), "8": ((2, 4), ARCHS4),
          "8p": ((2, 2, 2), (QWEN3,))}
CASES = [(w, a) for w, (_, archs) in WORLDS.items() for a in archs]
GEMMA_WORLDS = [w for w, (_, archs) in WORLDS.items() if "gemma2-2b" in archs]
PLANS = ("none", "prefix_embed")
ROWS = 4              # the batch's rows, split over every world's data axes
DECODE_ROWS = (4, 1)  # a decode's batch split over the data axes, and one
CACHE_LEN = 32
SERVE_TOL = (1e-6, 1e-5)   # atol, and rtol of the largest |value|
JAX_SERVE_TOL = dict(rtol=1e-4, atol=1e-4)   # the serving tests' FP32_TOL

RANK = """
from contextlib import nullcontext

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._redistribute import Redistribute
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree_leaves, tree_map
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.freeze_plan import FreezePlan
from repro_torch.distributed import sharding as sh, spmd
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, transformer as T
from repro_torch.runtime.train_loop import grads_of

shape = tuple(int(a) for a in inp["shape"])
mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):], device="cpu")
index, n = train._data_shards(mesh)
DIR = str(inp["dir"])
sends = [0]
redistribute_backward = Redistribute.backward


def counted_backward(ctx, g):
    sends[0] += 1
    return redistribute_backward(ctx, g)


Redistribute.backward = staticmethod(counted_backward)
uses = {"active": 0, "frozen": 0, "local": 0, "whole": 0}
real_use = spmd.use


def use(p):
    if isinstance(p, DTensor):
        uses["active" if p.requires_grad else "frozen"] += 1
        out = real_use(p)
        uses["local"] += out.numel()
        return out
    return real_use(p)


spmd.use = use


class Gathers(TorchDispatchMode):
    # the elements of each all-gather's result (`sizes`) and each
    # all-reduce's (`reduced`)
    def __init__(self):
        super().__init__()
        self.sizes, self.reduced = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "all_gather_into_tensor":
            self.sizes.append(out.numel())
        elif name == "all_reduce":
            self.reduced.append(out.numel())
        return out


redistributes = [0]
real_redistribute = DTensor.redistribute


def counted_redistribute(self, *a, **k):
    redistributes[0] += 1
    return real_redistribute(self, *a, **k)


DTensor.redistribute = counted_redistribute


def no_full_tensor(*a, **k):
    raise AssertionError("a param gathered whole in the step")


def full(t, batch_split, vocab_split):
    pl = [Shard(0) if batch_split else Replicate()] * (len(shape) - 1) + [
        Shard(t.dim() - 1) if vocab_split else Replicate()]
    return DTensor.from_local(t, mesh, pl, run_check=False).full_tensor()


def save(name, tree):
    # the first rank's copy of a whole tree, for the test to read
    if rank == 0:
        ckpt.save(DIR + "/" + name, tree)


out = {}
for arch in [str(a) for a in inp["archs"]]:
    kw = dict(dtype="float32", param_dtype="float32", ssm_chunk=8)
    if arch.startswith("jamba"):
        kw["num_layers"] = 16
    cfg = get_reduced(arch).replace(**kw)
    model = build_model(cfg, device="cpu")
    like = model.init(torch.Generator().manual_seed(0))
    params, _ = ckpt.restore(DIR + "/" + arch, like, device="cpu")
    placed = sh.place(params, sh.param_specs(params, cfg, mesh), mesh)
    batch = {k: torch.from_numpy(inp[arch + "/" + k]) for k in
             ("tokens", "targets", "mask")}
    B = batch["tokens"].shape[0]
    rows = slice(index * B // n, (index + 1) * B // n)
    local = {k: v[rows] for k, v in batch.items()}
    G = model.num_freeze_units
    res = {}
    for name in ("none", "prefix_embed"):
        plan = None if name == "none" else FreezePlan(
            groups=tuple(i == 0 for i in range(G)), embed=True)
        sends[0] = 0
        uses.update(active=0, frozen=0, local=0)
        gathers = Gathers() if arch == "gemma2-2b" else nullcontext()
        real_full = DTensor.full_tensor
        DTensor.full_tensor = no_full_tensor
        try:
            with gathers:
                loss, grads = train._loss_and_grads(model, placed, local,
                                                    plan, mesh)
        finally:
            DTensor.full_tensor = real_full
        placed_ok = all(g.placements == p.placements for g, p in zip(
            tree_leaves(grads), tree_leaves(placed), strict=True))
        if name == "none":
            loss_none, grads_none = loss, grads
        save(f"{arch}_{name}_grads", tree_map(lambda g: g.full_tensor(),
                                               grads))
        res[name] = {"loss": float(loss), "sends": sends[0],
                     "uses": dict(uses), "placed": placed_ok,
                     "gathers": getattr(gathers, "sizes", None)}
    # rows not split: every rank's loss the whole batch's, the weights
    # kept where they lie (`spmd.matmul`) in the forward and the backward
    with spmd.step(mesh, rows=False):
        s_loss, _, s_grads = grads_of(model.loss, placed, batch, None)
    save(f"{arch}_stationary_grads", tree_map(lambda g: g.full_tensor(),
                                              s_grads))
    res["stationary"] = {"loss": float(s_loss), "placed": all(
        g.placements == p.placements for g, p in zip(
            tree_leaves(s_grads), tree_leaves(placed), strict=True))}
    if arch == "gemma2-2b":
        # remat: the recompute gathers again and runs the same collectives
        res["remat"] = {}
        for remat in ("full", "dots"):
            rm = build_model(cfg.replace(remat=remat), device="cpu")
            r_loss, r_grads = train._loss_and_grads(rm, placed, local, None,
                                                    mesh)
            same = bool(torch.equal(r_loss, loss_none)) and all(
                torch.equal(a.to_local(), b.to_local()) for a, b in zip(
                    tree_leaves(r_grads), tree_leaves(grads_none),
                    strict=True))
            res["remat"][remat] = same
    sizes = [(p.numel(), real_use(p).numel(), p.to_local().numel())
             for p in tree_leaves(placed)]
    res["whole_numel"] = sum(a for a, _, _ in sizes)
    res["use_numel_max"] = max(b for _, b, _ in sizes)
    # the smallest param that FSDP splits, its shards gathered
    res["fsdp_numel_min"] = min(b for _, b, c in sizes if b != c)

    # serving: prefill, then one decode step on a placed cache; the
    # sharded results saved whole for the test to hold against JAX's
    serve = {}
    with torch.no_grad():
        want, _ = T.lm_prefill(params, cfg, batch)
        with spmd.step(mesh):
            got, _ = T.lm_prefill(placed, cfg, local)
        got = full(got, True, got.shape[-1] != cfg.vocab_size)
        save(f"{arch}_prefill", {"logits": got})
        serve["prefill"] = [float((got - want).abs().max()),
                            float(want.abs().max())]
        L = int(inp["cache_len"])
        for Bd in [int(b) for b in inp["decode_rows"]]:
            cache, _ = ckpt.restore(
                DIR + f"/{arch}_cache{Bd}",
                T.init_lm_cache(cfg, Bd, L, torch.float32, "cpu"),
                device="cpu")
            tok = torch.from_numpy(inp[f"{arch}/decode{Bd}"])
            pos = L - 3
            want, wcache = T.lm_decode(params, cfg, tok, cache, pos)
            cs = ShapeConfig("d", L, Bd, "decode")
            pcache = sh.place(cache, sh.cache_specs(cfg, cs, mesh, cache),
                              mesh)
            split = Bd % n == 0
            ltok = tok[index * Bd // n:(index + 1) * Bd // n] if split \
                else tok
            moved = Gathers()
            redistributes[0] = 0
            real_full = DTensor.full_tensor
            DTensor.full_tensor = no_full_tensor
            try:
                with moved, spmd.step(mesh, rows=split):
                    got, gcache = T.lm_decode(placed, cfg, ltok, pcache, pos)
            finally:
                DTensor.full_tensor = real_full
            serve[f"moved{Bd}"] = {"gathers": moved.sizes,
                                   "reduced": moved.reduced,
                                   "redistributes": redistributes[0]}
            got = full(got, split, got.shape[-1] != cfg.vocab_size)
            gcache = tree_map(lambda t: t.full_tensor(), gcache)
            save(f"{arch}_decode{Bd}", {"logits": got, "cache": gcache})
            err = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1.0)
                      for a, b in zip(tree_leaves(gcache),
                                      tree_leaves(wcache), strict=True))
            serve[f"decode{Bd}"] = [float((got - want).abs().max()),
                                    float(want.abs().max()), err]
    res["serve"] = serve

    # MoE dispatch on the shards against the port's whole-batch routing:
    # global, and group-local with one group a data shard
    if cfg.num_experts:
        from repro_torch.models import moe
        i = int(inp[arch + "/moe_block"])
        ffn, placed_ffn = params["blocks"][i]["ffn"], placed["blocks"][i]["ffn"]
        x = torch.from_numpy(inp[arch + "/moe_x"])
        tokens = x.shape[0] * x.shape[1]
        res["moe"] = {}
        for name, local_cfg, groups, cap in (
                ("global", cfg, 1, moe.moe_capacity(cfg, tokens)),
                ("local", cfg.replace(moe_local_dispatch=True), n,
                 max(8, moe.moe_capacity(cfg, tokens) // n))):
            want, waux = moe._moe_dispatch(ffn, cfg, x, groups=groups,
                                           capacity=cap)
            dropped = 0
            for xg in x.reshape(groups, -1, cfg.d_model):
                _, _, tok, gval = moe.route(ffn, cfg, xg, cap)
                dropped += xg.shape[0] * cfg.experts_per_token - int(
                    moe.kept_pairs(tok, gval, xg.shape[0]).sum())
            xr = x[index * x.shape[0] // n:(index + 1) * x.shape[0] // n]
            with torch.no_grad(), spmd.step(mesh):
                got, aux = moe.moe_ffn(spmd.use_tree(placed_ffn), local_cfg,
                                       xr)
            got = full(got, True, False)
            save(f"{arch}_moe_{name}", {"out": got, "aux": aux})
            res["moe"][name] = [float((got - want).abs().max()),
                                float(want.abs().max()),
                                abs(float(aux) - float(waux)), dropped]
    out[arch] = res

if shape == (2, 2):
    # the example's run on this world's (2, 2) mesh
    from repro_torch.examples import train_sharded
    out["example"] = train_sharded.run(
        get_reduced("gemma2-2b").replace(use_pallas=True), shape, steps=4,
        batch=4, seq=16, freeze_at=2, device=torch.device("cpu"))
    out["example_gaps"] = [train_sharded.step_gaps(
        get_reduced("gemma2-2b").replace(use_pallas=True, dtype="float32",
                                         param_dtype="float32"), shape,
        batch=4, seq=16, device=torch.device("cpu"), frozen=frozen)
        for frozen in (False, True)]
"""

_RUNS = {}


def _moe_block(cfg) -> int:
    """The first layer with an MoE FFN."""
    return next(i for i in range(cfg.num_layers) if cfg.layer_is_moe(i))


def _world(world, tmp_path_factory):
    """The rank program's outputs on the world's mesh for its archs and
    the reference's params, batches, caches and MoE tokens, once a
    module."""
    if world not in _RUNS:
        shape, archs = WORLDS[world]
        d = tmp_path_factory.mktemp(f"spmd{world}")
        inputs = {"shape": np.array(shape), "archs": np.array(archs),
                  "dir": np.array(str(d)), "cache_len": np.array(CACHE_LEN),
                  "decode_rows": np.array(DECODE_ROWS)}
        for arch in archs:
            _, jparams, _, model, params = _pair(arch)
            cfg = model.cfg
            ckpt.save(str(d / arch), params)
            for k, v in _batch(cfg, B=ROWS).items():
                inputs[f"{arch}/{k}"] = v
            for Bd in DECODE_ROWS:
                cache, tok = _decode_inputs(cfg, Bd)
                ckpt.save(str(d / f"{arch}_cache{Bd}"), cache)
                inputs[f"{arch}/decode{Bd}"] = tok
            if cfg.num_experts:
                inputs[f"{arch}/moe_block"] = np.array(_moe_block(cfg))
                inputs[f"{arch}/moe_x"] = _moe_x(cfg)
        outs = run_ranks(int(np.prod(shape)), RANK, inputs, d, timeout=600)
        _RUNS[world] = (d, outs)
    return _RUNS[world]


def _decode_inputs(cfg, Bd):
    """A decode's caches (random, in the port's per-layer form) and its
    tokens, from a seed."""
    rng = np.random.default_rng(Bd)
    cache = tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        tuple(t.shape)).astype(np.float32)),
        T.init_lm_cache(cfg, Bd, CACHE_LEN, torch.float32, "cpu"))
    tok = rng.integers(0, cfg.vocab_size, (Bd, 1)).astype(np.int32)
    return cache, tok


def _moe_x(cfg):
    """MoE tokens [ROWS, 12, D] that share a direction, so they prefer
    the same experts and global routing drops pairs over capacity."""
    rng = np.random.default_rng(6)
    return (rng.standard_normal((ROWS, 12, cfg.d_model))
            + rng.standard_normal(cfg.d_model)).astype(np.float32)


def _kinded(c: dict) -> dict:
    """A port layer's cache as the reference keys it (an rwkv state is
    the layer's dict itself in the port)."""
    return c if {"attn", "mamba"} & set(c) else {"rwkv": c}


def _jax_cache(cache, cfg):
    """The port's per-layer caches as the reference's stacked ones: a
    tuple over group offsets of leaves [G, ...]."""
    g = T.group_size(cfg)
    return tuple(jax.tree.map(
        lambda *a: jnp.stack([jnp.asarray(x.numpy()) for x in a]),
        *[_kinded(cache[i]) for i in range(o, cfg.num_layers, g)])
        for o in range(g))


def _port_cache(jcache, cfg):
    """The reference's stacked caches as the port's per-layer ones."""
    g = T.group_size(cfg)
    out = []
    for i in range(cfg.num_layers):
        c = jax.tree.map(lambda a: np.asarray(a[i // g]), jcache[i % g])
        out.append(c["rwkv"] if "rwkv" in c else c)
    return out


_SERVE = {}


def _jax_serve(arch):
    """The reference's prefill and decode, jitted, once an arch."""
    if arch not in _SERVE:
        jmodel = _pair(arch)[0]
        _SERVE[arch] = (jax.jit(jmodel.prefill), jax.jit(jmodel.decode))
    return _SERVE[arch]


@pytest.mark.parametrize("world,arch", CASES)
def test_sharded_step_matches_the_reference(arch, world, tmp_path_factory):
    """With no plan and under the frozen prefix, against JAX's
    `value_and_grad` on the same params and batch (the plan as JAX's
    `FreezePlan`), at tests/test_torch_lm_grads.py's tolerances."""
    d, outs = _world(world, tmp_path_factory)
    jmodel, jparams, vg, model, params = _pair(arch)
    cfg = model.cfg
    G = model.num_freeze_units
    batch = _batch(cfg, B=ROWS)
    for name in PLANS:
        spec = _plans(G)[name]
        plan = FreezePlan(*spec) if spec else None
        (want, _), jgrads = vg(jparams, _jax(batch),
                               JaxFreezePlan(*spec) if spec else None)
        want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads),
                                     cfg, device="cpu")
        for o in outs:
            r = o[arch][name]
            np.testing.assert_allclose(r["loss"], float(want), **LOSS_TOL)
            assert r["placed"], f"{arch} {name}: a gradient off its placement"
        assert len({o[arch][name]["loss"] for o in outs}) == 1
        got, _ = ckpt.restore(str(d / f"{arch}_{name}_grads"), params,
                              device="cpu")
        _hold_grads(got, want_grads, cfg, plan)


@pytest.mark.parametrize("world,arch", CASES)
def test_frozen_leaves_send_nothing(arch, world, tmp_path_factory):
    """C.17 on the sharded step: one gradient redistribute for each use of
    an active leaf, none for a frozen one (which reaches its gather
    detached); a frozen prefix has frozen uses and sends fewer."""
    _, outs = _world(world, tmp_path_factory)
    for o in outs:
        none, prefix = o[arch]["none"], o[arch]["prefix_embed"]
        assert none["uses"]["frozen"] == 0
        assert none["sends"] == none["uses"]["active"] > 0
        assert prefix["uses"]["frozen"] > 0
        assert prefix["sends"] == prefix["uses"]["active"]
        assert prefix["uses"]["active"] + prefix["uses"]["frozen"] == \
            none["uses"]["active"]
        assert prefix["sends"] < none["sends"]


@pytest.mark.parametrize("world", GEMMA_WORLDS)
def test_remat_recomputes_the_sharded_step_bitwise(world, tmp_path_factory):
    """gemma2-2b's sharded step under remat full and dots (each group's
    gathers and collectives run again in the backward's recompute): the
    loss and every gradient shard bitwise remat none's."""
    _, outs = _world(world, tmp_path_factory)
    for o in outs:
        assert o["gemma2-2b"]["remat"] == {"full": True, "dots": True}


def test_no_param_is_gathered_whole(tmp_path_factory):
    """gemma2-2b on (2, 4): the step's all-gathers are its params' FSDP
    gathers (no other all-gather runs in its blocks there), each at most
    the largest param's use-time size; together at most the use-time
    sizes of the params' uses and below the params' whole sizes, which
    the gathering step (commit c267de1) took whole."""
    _, outs = _world("8", tmp_path_factory)
    for o in outs:
        r = o["gemma2-2b"]
        for name in PLANS:
            sizes = r[name]["gathers"]
            assert sizes and max(sizes) <= r["use_numel_max"]
            assert sum(sizes) <= r[name]["uses"]["local"]
            assert sum(sizes) < r["whole_numel"]


def _activation_width(cfg, tp: int) -> int:
    """The most elements a layer of `cfg` joins for one token on a
    `model` of `tp`: the model width, an FFN's hidden dim, mamba's
    in_proj output (x and z), the query heads, the router's experts, and
    the rank's experts' hidden buffers (their capacity slots for one
    token)."""
    from repro_torch.models import mamba, moe

    E = cfg.num_experts
    slots = (E // tp if E % tp == 0 else E) * moe.moe_capacity(cfg, 1) \
        if E else 0
    return max(cfg.d_model, cfg.d_ff, 2 * mamba.d_inner(cfg),
               cfg.num_heads * cfg.head_dim, E, slots * cfg.expert_ff)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_decode_of_one_row_keeps_the_weights_where_they_lie(
        world, tmp_path_factory):
    """A decode of one row (its rows not split over the data axes) on the
    (2, 2), (2, 4) and (2, 2, 2) worlds gathers no FSDP shard of a
    product's weight: no DTensor redistribute and no `full_tensor` in
    the step, and every all-gather and all-reduce at most one token's
    widest activation, below the smallest FSDP-split param with its
    shards gathered. A decode whose rows are split still takes the
    params through `use`'s gather (DTensor redistributes)."""
    _, outs = _world(world, tmp_path_factory)
    for arch in WORLDS[world][1]:
        cfg = _pair(arch)[3].cfg
        width = _activation_width(cfg, WORLDS[world][0][-1])
        for o in outs:
            r = o[arch]
            assert width < r["fsdp_numel_min"], (arch, width)
            one = r["serve"]["moved1"]
            assert one["redistributes"] == 0, (arch, one)
            assert one["gathers"] and one["reduced"], (arch, one)
            assert max(one["gathers"] + one["reduced"]) <= width, (arch, one)
            assert r["serve"][f"moved{ROWS}"]["redistributes"] > 0, arch


@pytest.mark.parametrize("world,arch", CASES)
def test_unsplit_rows_keep_the_gradients_of_the_reference(
        arch, world, tmp_path_factory):
    """The loss and gradients of a step whose rows are not split (every
    rank on the whole batch; `spmd.matmul` on the weights' FSDP shards,
    its joins' adjoints in the backward) against the reference's
    `jax.value_and_grad`, at tests/test_torch_lm_grads.py's tolerances,
    each gradient placed as its param is."""
    d, outs = _world(world, tmp_path_factory)
    jmodel, jparams, vg, model, params = _pair(arch)
    cfg = model.cfg
    (want, _), jgrads = vg(jparams, _jax(_batch(cfg, B=ROWS)), None)
    for o in outs:
        np.testing.assert_allclose(o[arch]["stationary"]["loss"],
                                   float(want), **LOSS_TOL)
        assert o[arch]["stationary"]["placed"], arch
    got, _ = ckpt.restore(str(d / f"{arch}_stationary_grads"), params,
                          device="cpu")
    _hold_grads(got, params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                     device="cpu"), cfg, None)


@pytest.mark.parametrize("world,arch", CASES)
def test_sharded_serving_matches_the_reference(arch, world,
                                               tmp_path_factory):
    """`lm_prefill` and one `lm_decode` step in the sharded step (a decode
    cache placed by `cache_specs`, for a batch the data axes split and
    for a batch of one, whose cache they split by sequence): logits and
    new caches against the reference's `prefill` and `decode` on the same
    params, tokens and caches, and against the port's plain path on the
    whole batch."""
    d, outs = _world(world, tmp_path_factory)
    _, jparams, _, model, _ = _pair(arch)
    cfg = model.cfg
    prefill, decode = _jax_serve(arch)
    tokens = _batch(cfg, B=ROWS)["tokens"]
    want, _ = prefill(jparams, {"tokens": jnp.asarray(tokens)})
    like = {"logits": torch.zeros(ROWS, cfg.vocab_size)}
    got, _ = ckpt.restore(str(d / f"{arch}_prefill"), like, device="cpu")
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               err_msg="prefill", **JAX_SERVE_TOL)
    for Bd in DECODE_ROWS:
        cache, tok = _decode_inputs(cfg, Bd)
        want, jcache = decode(jparams, jnp.asarray(tok),
                              _jax_cache(cache, cfg),
                              jnp.int32(CACHE_LEN - 3))
        like = {"logits": torch.zeros(Bd, cfg.vocab_size), "cache": cache}
        got, _ = ckpt.restore(str(d / f"{arch}_decode{Bd}"), like,
                              device="cpu")
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                                   err_msg=f"decode {Bd}", **JAX_SERVE_TOL)
        wants = dict(_named(_port_cache(jcache, cfg)))
        gots = _named(got["cache"])
        assert len(gots) == len(wants)
        for path, g in gots:
            np.testing.assert_allclose(g.numpy(), wants[path],
                                       err_msg=f"cache {Bd} {path}",
                                       **JAX_SERVE_TOL)
    atol, rtol = SERVE_TOL
    for o in outs:
        s = o[arch]["serve"]
        for key in ("prefill",) + tuple(f"decode{b}" for b in DECODE_ROWS):
            err, scale = s[key][:2]
            assert err <= atol + rtol * scale, (key, s)
        for key in (f"decode{b}" for b in DECODE_ROWS):   # caches, scaled
            assert s[key][2] <= atol + rtol, (key, s)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_moe_dispatch_on_shards_drops_the_same_pairs(world,
                                                      tmp_path_factory):
    """qwen3-moe's and jamba's first MoE FFN in the sharded step, their
    experts on `model` and their tokens split over the data axes: global
    routing (each expert's global top-C from the shards' merged top-C;
    qwen3-moe drops pairs of these tokens there, counted on the whole
    batch) and group-local routing (one group a data shard), against the
    reference's `_moe_dispatch` of the whole batch on the same params
    and tokens (outputs within atol 1e-5 and the aux loss within rtol
    1e-6, as tests/test_torch_moe_mamba.py holds the port's) and
    against the port's (within 1e-6 + 1e-5 x their largest |value|: a
    pair dropped on one side only would move its token by a whole
    expert's output; the aux loss within 1e-6)."""
    d, outs = _world(world, tmp_path_factory)
    n = int(np.prod(WORLDS[world][0][:-1]))   # the data shards
    atol, rtol = SERVE_TOL
    for arch in {QWEN3, JAMBA} & set(WORLDS[world][1]):
        jmodel, jparams, _, model, _ = _pair(arch)
        cfg, jcfg = model.cfg, jmodel.cfg
        i, g = _moe_block(cfg), T.group_size(cfg)
        jffn = jax.tree.map(lambda a: a[i // g], jparams["blocks"][i % g])
        x = jnp.asarray(_moe_x(cfg))
        tokens = x.shape[0] * x.shape[1]
        cap = jax_moe.moe_capacity(jcfg, tokens)
        for name, groups, c in (("global", 1, cap),
                                ("local", n, max(8, cap // n))):
            want, waux = jax_moe._moe_dispatch(jffn["ffn"], jcfg, x,
                                               groups=groups, capacity=c)
            like = {"out": torch.zeros(x.shape), "aux": torch.zeros(())}
            got, _ = ckpt.restore(str(d / f"{arch}_moe_{name}"), like,
                                  device="cpu")
            np.testing.assert_allclose(got["out"].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{arch} {name}")
            np.testing.assert_allclose(float(got["aux"]), float(waux),
                                       rtol=1e-6)
        for o in outs:
            for name, (err, scale, aux, dropped) in o[arch]["moe"].items():
                # qwen3-moe's global routing drops pairs of these tokens
                assert dropped or arch == JAMBA or name == "local", \
                    (arch, name)
                assert err <= atol + rtol * scale, (arch, name, err, scale)
                assert aux <= 1e-6, (arch, name, aux)


def test_kernels_refuse_a_dtensor():
    """Neither kernel's wrapper takes a DTensor, on any device: a sharded
    step hands each rank's local tensors to it, and a DTensor has no data
    pointer for a kernel to read."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.kernels.attention import ops as att_ops
    from repro_torch.kernels.rwkv import ops as wkv_ops

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        gen = torch.Generator().manual_seed(0)

        def dt(*shape):
            return distribute_tensor(torch.randn(shape, generator=gen), mesh,
                                     [Replicate()])

        q = dt(1, 8, 2, 16)
        with torch.no_grad(), pytest.raises(TypeError, match="DTensor"):
            att_ops.flash_attention(q, q, q)
        r = dt(1, 8, 2, 16)
        with torch.no_grad(), pytest.raises(TypeError, match="DTensor"):
            wkv_ops.wkv(r, r, r, -torch.ones(1, 8, 2, 16), torch.ones(2, 16))
    finally:
        dist.destroy_process_group()


def test_step_context_reaches_autograd_threads():
    """The sharded step's groups are visible from any thread while the
    step runs: on the card autograd runs the backward, and under remat
    the recomputed forward with its collectives, on its own device
    thread (the CPU's backward runs in the caller's, so the gloo worlds
    above cannot show this)."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import spmd

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        seen = []
        with spmd.step(mesh) as ctx:
            t = threading.Thread(target=lambda: seen.append(
                (spmd.current(), spmd.tp())))
            t.start()
            t.join()
        assert ctx is not None and seen == [(ctx, 2)]
        assert spmd.current() is None
    finally:
        dist.destroy_process_group()


def test_train_sharded_example_runs_the_loop(tmp_path_factory):
    """`examples/train_sharded.run` on the (2, 2) gloo world: four steps,
    the half-prefix plan from the third, the losses those of the
    plain-tensor loop on one process within bf16's rounding, three step
    times, no kernel launched on the CPU. Its `step_gaps` in fp32 (the
    four-card run's witness), all active and under the half-prefix plan:
    step 0's loss within 1e-5 of the plain-tensor step's and every
    gradient leaf within 1e-5 + 1e-4 x its largest |g| (a frozen leaf's
    exactly zero), as tests/test_torch_lm_grads.py holds the port's to
    JAX's; the other ranks return None."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train

    _, outs = _world("4", tmp_path_factory)
    plain = train.train(get_reduced("gemma2-2b").replace(use_pallas=True),
                        steps=4, batch=4, seq=16, freeze_at=2, device="cpu")
    for o in outs:
        run = o["example"]
        assert run["flash_launches"] == 0 and run["peak_gb"] is None
        assert len(run["step_s"]) == 3
        np.testing.assert_allclose(run["losses"], plain["losses"], rtol=1e-2)
    for gaps in outs[0]["example_gaps"]:
        assert gaps["loss"] <= 1e-5, gaps["loss"]
        assert len(gaps["grads"]) == len(_named(_pair("gemma2-2b")[4]))
        for path, (err, scale) in gaps["grads"].items():
            assert err <= 1e-5 + 1e-4 * scale and (scale or not err), \
                (path, err, scale)
    frozen = outs[0]["example_gaps"][1]["grads"]
    # bf16 against fp32 on plain tensors: every leaf moved, frozen ones
    # not, the sharded step's fp32 gaps far below these
    from repro_torch.examples import train_sharded
    types = train_sharded.type_gaps(get_reduced("gemma2-2b"), batch=4,
                                    seq=16, device="cpu", frozen=True)
    assert 0 < types["loss"] < 1e-1
    assert {p for p, (e, _) in types["grads"].items() if e == 0} == \
        {p for p, (_, m) in frozen.items() if m == 0}
    assert train_sharded._over(outs[0]["example_gaps"][1], types)[1] < 1e-2
    assert sum(scale == 0.0 for _, scale in frozen.values()) > 0
    assert all(o["example_gaps"] == [None, None] for o in outs[1:])
