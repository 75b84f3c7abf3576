"""The port's distributed layer (`repro_torch.distributed`,
`repro_torch.optim.compression`, the shape vocabulary of
`repro_torch.configs`) against the JAX package on the CPU.

- The analytic parameter counts and the four LM shapes, equal to the
  integer for all ten archs and the paper models.
- The int8 and top-k codecs, bit for bit on fp32 inputs drawn from a seed
  (top-k: values, indices as a set, the decoded tensor).
- `param_specs`, `batch_specs`, `cache_specs` and `opt_state_specs`, leaf
  by leaf against the reference's on a `jax.sharding.AbstractMesh`, for
  all ten archs at full size on meshes (2, 4), (16, 16) and (2, 16, 16),
  FSDP on and off. The port's meshes are DeviceMeshes over a fake
  process group in this process (it carries no data, so specs only), and
  its params fake tensors; a block or cache leaf's spec is the
  reference's without its stacked [G] dim.
- The collectives, `hint`, elastic re-meshing and the sharded restore on
  CPU worlds of 4 and 8 gloo ranks (`torch_ranks.run_ranks`), against
  the reference's `sync_grads_shard_map` on 8 host devices (a
  subprocess, as `tests/test_distributed.py` runs it), numpy's mean, the
  reference's int8 codec and a checkpoint the reference wrote.
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.configs import LM_SHAPES as JAX_LM_SHAPES
from repro.configs import cell_is_applicable as jax_cell_is_applicable
from repro.distributed import sharding as jsh
from repro.models import transformer as jax_transformer
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import compression as jcomp
from repro_torch.configs import (ARCHS, LM_SHAPES, PAPER_MODELS,
                                 cell_is_applicable, get_config, get_shape)
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import compression
from torch_ranks import ROOT, run_ranks

MESHES = (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


# ---------------------------------------------------------------------------
# the shape vocabulary


@pytest.mark.parametrize("name", list(ARCHS) + list(PAPER_MODELS))
def test_param_counts_match_reference(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.moe_local_dispatch is jcfg.moe_local_dispatch is False


def test_lm_shapes_and_cells_match_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind, s.tokens)
            for s in LM_SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind, s.tokens)
         for s in JAX_LM_SHAPES]
    for s in JAX_LM_SHAPES:
        assert get_shape(s.name).tokens == s.tokens
        for a in ARCHS:
            assert cell_is_applicable(get_config(a), get_shape(s.name)) == \
                jax_cell_is_applicable(jax_get_config(a), s)
    with pytest.raises(KeyError):
        get_shape("train_8k")


# ---------------------------------------------------------------------------
# compression


def _grads(seed):
    rng = np.random.default_rng(seed)
    return ({"a": rng.standard_normal((64, 33)).astype(np.float32),
             "b": {"c": (rng.standard_normal(7) * 1e-3).astype(np.float32),
                   "d": np.zeros((3, 5), np.float32)}},
            {"a": (rng.standard_normal((64, 33)) * 1e-2).astype(np.float32),
             "b": {"c": rng.standard_normal(7).astype(np.float32) * 1e-4,
                   "d": np.zeros((3, 5), np.float32)}})


def _to(tree, fn):
    return jax.tree.map(fn, tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codec_is_the_reference_bit_for_bit(seed):
    g, r = _grads(seed)
    jq, js, jr = jcomp.int8_compress_tree(_to(g, jnp.asarray),
                                          _to(r, jnp.asarray))
    tq, ts, tr = compression.int8_compress_tree(_to(g, torch.from_numpy),
                                                _to(r, torch.from_numpy))
    jd = jcomp.int8_decompress_tree(jq, js)
    td = compression.int8_decompress_tree(tq, ts)
    for want, got in ((jq, tq), (js, ts), (jr, tr), (jd, td)):
        for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(
                _to(got, lambda x: x.numpy())), strict=True):
            assert w.dtype == t.dtype and np.array_equal(np.asarray(w), t)
    assert tq["a"].dtype == torch.int8
    zero = compression.init_residual(_to(g, torch.from_numpy))
    assert all(z.dtype == torch.float32 and not z.any()
               for z in (zero["a"], zero["b"]["c"]))


@pytest.mark.parametrize("frac", [0.01, 0.1])
def test_topk_codec_matches_reference(frac):
    g, r = _grads(3)
    jv, ji, jr = jcomp.topk_compress_tree(_to(g, jnp.asarray),
                                          _to(r, jnp.asarray), frac)
    tv, ti, tr = compression.topk_compress_tree(_to(g, torch.from_numpy),
                                                _to(r, torch.from_numpy),
                                                frac)
    for key in (("a",), ("b", "c")):
        pick = functools.partial(functools.reduce, lambda t, k: t[k], key)
        want_v, want_i = np.asarray(pick(jv)), np.asarray(pick(ji))
        order = np.argsort(want_i)
        got_i = pick(ti).numpy()
        assert set(got_i.tolist()) == set(want_i.tolist())
        np.testing.assert_array_equal(
            pick(tv).numpy()[np.argsort(got_i)], want_v[order])
        np.testing.assert_array_equal(pick(tr).numpy(),
                                      np.asarray(pick(jr)))
        shape = pick(g).shape
        np.testing.assert_array_equal(
            compression.topk_decode(pick(tv), pick(ti), shape).numpy(),
            np.asarray(jcomp.topk_decode(pick(jv), pick(ji), shape)))


# ---------------------------------------------------------------------------
# placement specs against the reference's, leaf by leaf


@contextmanager
def fake_mesh(shape, axes):
    """A DeviceMesh over a fake process group of its size (rank 0)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda: jax_transformer.init_lm(
        jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's params as fake tensors: shapes and dtypes, no memory."""
    with FakeTensorMode():
        return transformer.init_lm(torch.Generator(), get_config(arch))


def _flat(tree):
    """{path: leaf} of a reference tree of PartitionSpecs."""
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_flat(tree):
    out = {}
    sh.map_with_path(lambda names, s: out.setdefault(tuple(names), s), tree)
    return out


def _hold_params(port, ref, g):
    """Port specs (blocks a list of layers) against the reference's
    (blocks a list of g offsets whose leaves carry a [G] dim)."""
    want = _flat(ref)
    got = _port_flat(port)
    n = 0
    for path, spec in got.items():
        if path[0] == "blocks":
            ref_path = ("blocks", str(int(path[1]) % g)) + path[2:]
            assert tuple(spec) == tuple(want[ref_path])[1:], path
        else:
            assert tuple(spec) == tuple(want[path]), path
        n += 1
    assert n and len({p for p in want if p[0] != "blocks"}) == \
        len({p for p in got if p[0] != "blocks"})
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_leaf_by_leaf(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jparams, params = _jax_params(arch), _port_params(arch)
    g = len(jparams["blocks"])
    for shape, axes in MESHES:
        jmesh = jax.sharding.AbstractMesh(shape, axes)
        with fake_mesh(shape, axes) as mesh:
            for fsdp in (True, False):
                specs = sh.param_specs(params, cfg, mesh,
                                       sh.ShardingPolicy(fsdp=fsdp))
                want = jsh.param_specs(jparams, jcfg, jmesh,
                                       jsh.ShardingPolicy(fsdp=fsdp))
                assert _hold_params(specs, want, g) == \
                    len(jax.tree.leaves(params))
                # the moments take the reference's specs too
                jopt = jax.eval_shape(lambda: jax_adamw_init(
                    jparams, JaxAdamWConfig()))
                with FakeTensorMode():
                    opt = adamw_init(params, AdamWConfig())
                ospecs = sh.opt_state_specs(specs, opt, params)
                jospecs = jsh.opt_state_specs(want, jopt, jparams)
                assert tuple(ospecs.step) == tuple(jospecs.step) == ()
                _hold_params(ospecs.m, jospecs.m, g)
                _hold_params(ospecs.v, jospecs.v, g)


def test_granite_single_kv_head_is_not_sharded_on_heads():
    """`tests/test_distributed.py::test_param_specs_divisibility_fallback`
    on the port: granite's MQA kv = 1 keeps wk's heads dim whole."""
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        specs = sh.param_specs(_port_params("granite-20b"),
                               get_config("granite-20b"), mesh)
    blk = specs["blocks"][0]
    assert "model" in map(str, blk["mix"]["wq"])
    assert blk["mix"]["wk"][1] != "model"
    assert "model" in map(str, blk["ffn"]["wg"])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    g = jax_transformer.group_size(jcfg)
    for shape, axes in MESHES:
        jmesh = jax.sharding.AbstractMesh(shape, axes)
        with fake_mesh(shape, axes) as mesh:
            for s, js in zip(LM_SHAPES, JAX_LM_SHAPES):
                got = sh.batch_specs(cfg, s, mesh)
                want = jsh.batch_specs(jcfg, js, jmesh)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}
                L = min(s.seq_len, 8192)
                jcache = jax.eval_shape(lambda: jax_transformer.init_lm_cache(
                    jcfg, s.global_batch, L, jnp.bfloat16))
                cache = transformer.init_lm_cache(
                    cfg, s.global_batch, L, torch.bfloat16, device="meta")
                ref = _flat(jsh.cache_specs(jcfg, js, jmesh, jcache))
                port = _port_flat(sh.cache_specs(cfg, s, mesh, cache))
                for path, spec in port.items():
                    layer, name = int(path[0]), path[-1]
                    match = [v for p, v in ref.items()
                             if p[0] == str(layer % g) and p[-1] == name]
                    assert len(match) == 1, path
                    assert tuple(spec) == tuple(match[0])[1:], (path, s)


def test_placements_and_named():
    from torch.distributed.tensor import Replicate, Shard

    with fake_mesh((2, 2, 4), ("pod", "data", "model")) as mesh:
        assert sh.placements(mesh, sh.P(("pod", "data"), "model")) == \
            (Shard(0), Shard(0), Shard(1))
        assert sh.placements(mesh, sh.P(None, "data")) == \
            (Replicate(), Shard(1), Replicate())
        named = sh.named(mesh, {"a": sh.P("model"), "b": [sh.P()]})
        assert named["a"].placements == (Replicate(), Replicate(), Shard(0))
        assert named["b"][0].mesh is mesh
    assert sh.P(("data",), None) == sh.P("data", None)
    assert len(sh.P()) == 0 and hash(sh.P("a")) == hash(sh.P(("a",)))


# ---------------------------------------------------------------------------
# collectives, hint, elastic and the sharded restore on gloo worlds


def _reference_sync_on_8_devices() -> dict:
    """The reference's `sync_grads_shard_map` on 8 host devices, plain and
    compressed, on identical replicas (`tests/test_distributed.py:55`)."""
    prog = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import jax, jax.numpy as jnp, json, numpy as np
    from repro.distributed import collectives
    from repro.launch.mesh import make_mesh
    mesh = make_mesh((8,), ("data",))
    g = {"w": jnp.arange(32, dtype=jnp.float32).reshape(8, 4) / 7.0}
    plain, _ = collectives.sync_grads_shard_map(mesh, g)
    comp, res = collectives.sync_grads_shard_map(mesh, g, compress=True)
    print(json.dumps({"plain": np.asarray(plain["w"]).tolist(),
                      "comp": np.asarray(comp["w"]).tolist(),
                      "res": np.asarray(res["w"]).tolist()}))
    """)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


COLLECTIVES = """
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.distributed import collectives as col, sharding as sh
from repro_torch.launch.mesh import make_mesh

t = lambda a: torch.from_numpy(np.array(a))
mesh4 = make_mesh((4,), ("data",), device="cpu")
same = {"w": t(inp["same"])}
plain_same, _ = col.sync_grads(mesh4, same)
comp_same, res_same = col.sync_grads(mesh4, same, compress=True)
g = {"a": t(inp["a"][rank]), "b": {"c": t(inp["c"][rank])}}
r = {"a": t(inp["ra"][rank]), "b": {"c": t(inp["rc"][rank])}}
plain, kept = col.sync_grads(mesh4, g)
comp, res = col.sync_grads(mesh4, g, compress=True, residual=r)

calls = []
real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}
for name, fn in real.items():
    setattr(dist, name, lambda *a, _n=name, _f=fn, **k: (calls.append(_n),
                                                        _f(*a, **k))[1])
mask = {"a": torch.zeros(()), "b": {"c": torch.ones(())}}
frozen, _ = col.sync_grads(mesh4, g, freeze_mask=mask)
n_plain = list(calls); calls.clear()
frozen_c, frozen_res = col.sync_grads(mesh4, g, compress=True, residual=r,
                                      freeze_mask=mask)
n_comp = list(calls); calls.clear()
col.sync_grads(mesh4, g, compress=True,
               freeze_mask={"a": 0, "b": {"c": torch.zeros(3)}})
n_none = list(calls)
for name, fn in real.items():
    setattr(dist, name, fn)

mesh22 = make_mesh((2, 2), ("pod", "data"), device="cpu")
hier = col.hierarchical_grad_sync(mesh22, g)
x = distribute_tensor(t(inp["x"]), mesh22, [Replicate(), Replicate()])
with sh.activation_sharding(mesh22):
    hinted = sh.hint(x, sh.BATCH_AXES, None)
    odd = sh.hint(distribute_tensor(t(inp["x"][:3]), mesh22,
                                    [Replicate(), Replicate()]),
                  sh.BATCH_AXES, "model")
    plain_t = torch.ones(4)
    passed = sh.hint(plain_t, "data") is plain_t
outside = sh.hint(x, sh.BATCH_AXES) is x
out = {"plain_same": plain_same["w"].tolist(),
       "comp_same": comp_same["w"].tolist(),
       "res_same": res_same["w"].tolist(),
       "plain": [plain["a"].tolist(), plain["b"]["c"].tolist()],
       "kept_is_none": kept is None,
       "comp": [comp["a"].tolist(), comp["b"]["c"].tolist()],
       "res": [res["a"].tolist(), res["b"]["c"].tolist()],
       "frozen_a_zero": bool((frozen["a"] == 0).all()),
       "frozen_c": frozen["b"]["c"].tolist(),
       "frozen_c_comp": frozen_c["b"]["c"].tolist(),
       "frozen_res_a_kept": bool(torch.equal(frozen_res["a"], r["a"])),
       "frozen_c_a_zero": bool((frozen_c["a"] == 0).all()),
       "calls": [n_plain, n_comp, n_none],
       "hier": [hier["a"].tolist(), hier["b"]["c"].tolist()],
       "hinted": [p.dim if p.is_shard() else None for p in hinted.placements],
       "hinted_local": list(hinted.to_local().shape),
       "hinted_full": bool(torch.equal(hinted.full_tensor(), t(inp["x"]))),
       "odd": [p.dim if p.is_shard() else None for p in odd.placements],
       "passed": passed, "outside": outside}
"""


def _mean_decoded(qs, scales):
    deq = np.stack([np.asarray(q, np.float32) * np.float32(s)
                    for q, s in zip(qs, scales)])
    return deq.mean(axis=0)


def test_collectives_on_four_gloo_ranks(tmp_path):
    rng = np.random.default_rng(7)
    inp = {"same": (np.arange(32, dtype=np.float32).reshape(8, 4) / 7.0),
           "a": rng.standard_normal((4, 16, 8)).astype(np.float32),
           "c": rng.standard_normal((4, 5)).astype(np.float32),
           "ra": (rng.standard_normal((4, 16, 8)) * 1e-2).astype(np.float32),
           "rc": (rng.standard_normal((4, 5)) * 1e-2).astype(np.float32),
           "x": rng.standard_normal((8, 6)).astype(np.float32)}
    outs = run_ranks(4, COLLECTIVES, inp, tmp_path)
    ref = _reference_sync_on_8_devices()
    for rank, o in enumerate(outs):
        # identical replicas: the reference's result on 8 devices
        np.testing.assert_allclose(o["plain_same"], ref["plain"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(o["comp_same"], ref["comp"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(np.float32(o["res_same"]),
                                      np.float32(ref["res"]))
        # distinct gradients: numpy's mean, and the mean of the
        # reference's own int8 decode of every rank's gradients
        for i, key in enumerate(("a", "c")):
            np.testing.assert_allclose(o["plain"][i], inp[key].mean(axis=0),
                                       rtol=0, atol=1e-6)
        enc = [jcomp.int8_compress_tree(
            {"a": jnp.asarray(inp["a"][r]), "c": jnp.asarray(inp["c"][r])},
            {"a": jnp.asarray(inp["ra"][r]), "c": jnp.asarray(inp["rc"][r])})
            for r in range(4)]
        for i, key in enumerate(("a", "c")):
            want = _mean_decoded([e[0][key] for e in enc],
                                 [e[1][key] for e in enc])
            np.testing.assert_allclose(o["comp"][i], want, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(np.float32(o["res"][i]),
                                          np.asarray(enc[rank][2][key]))
        assert o["kept_is_none"]
        # frozen leaves: zeros, residual kept, nothing sent
        assert o["frozen_a_zero"] and o["frozen_c_a_zero"]
        assert o["frozen_res_a_kept"]
        np.testing.assert_allclose(o["frozen_c"], inp["c"].mean(axis=0),
                                   rtol=0, atol=1e-6)
        assert o["calls"] == [["all_reduce"], ["all_gather"] * 2, []]
        np.testing.assert_allclose(o["hier"][0], inp["a"].mean(axis=0),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(o["hier"][1], inp["c"].mean(axis=0),
                                   rtol=0, atol=1e-6)
        # hint: batch over (pod, data); a batch of 3 does not divide 4
        assert o["hinted"] == [0, 0]
        assert o["hinted_local"] == [2, 6] and o["hinted_full"]
        assert o["odd"] == [None, None]
        assert o["passed"] and o["outside"]


ELASTIC = """
from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.configs import get_reduced
from repro_torch.distributed import elastic, sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model

# tests/test_distributed.py::test_elastic_remesh_preserves_values
mesh_a = make_mesh((4, 2), ("data", "model"), device="cpu")
mesh_b = elastic.shrink_mesh(mesh_a, "data")
x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
spec = {"x": sh.P("data", "model")}
placed = sh.place({"x": x}, spec, mesh_a)
moved = elastic.remesh(placed, mesh_b, spec)
member = mesh_b.get_coordinate() is not None
out = {"member": member, "shape_b": list(mesh_b.shape),
       "local_a": list(placed["x"].to_local().shape)}
if member:
    out.update(ok=bool(torch.equal(moved["x"].full_tensor(), x)),
               ndev=mesh_b.size(), local_b=list(moved["x"].to_local().shape))

# a sharded restore onto the shrunk mesh (elastic_restore), and the
# reference's checkpoint restored onto a (2, 4) mesh
cfg = get_reduced("gemma2-2b")
model = build_model(cfg, device="cpu")
params = model.init(torch.Generator().manual_seed(0))
mgr = CheckpointManager(str(inp["dir"]) + f"/port_{rank}")
mgr.save(3, params, block=True)
tree, step = elastic.elastic_restore(mgr, params, cfg, mesh_b)
specs = sh.param_specs(params, cfg, mesh_b)
if member:
    leaves = [(n, t) for n, t in ckpt._flatten_with_names(tree)]
    want = dict(ckpt._flatten_with_names(params))
    out.update(step=step, restored=all(
        torch.equal(t.full_tensor(), want[n]) for n, t in leaves),
        sharded=sum(any(p.is_shard() for p in t.placements)
                    for _, t in leaves))
mesh_c = make_mesh((2, 4), ("data", "model"), device="cpu")
like = {"a": torch.zeros(8, 4), "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
got, s = ckpt.restore(str(inp["ref"]), like, shardings=sh.named(
    mesh_c, {"a": sh.P("data", "model"), "b": {"c": sh.P("model")}}))
out.update(ref_step=s, ref_a=got["a"].full_tensor().tolist(),
           ref_c=got["b"]["c"].full_tensor().float().tolist(),
           ref_local=list(got["a"].to_local().shape),
           ref_dtype=str(got["b"]["c"].dtype))
"""


def test_elastic_remesh_and_sharded_restore_on_eight_gloo_ranks(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 4)).astype(np.float32)
    c = rng.standard_normal(4).astype(np.float32)
    jax_ckpt.save(str(tmp_path / "ref"), {
        "a": jnp.asarray(a), "b": {"c": jnp.asarray(c, jnp.bfloat16)}},
        step=11)
    outs = run_ranks(8, ELASTIC, {"dir": np.array(str(tmp_path)),
                                  "ref": np.array(str(tmp_path / "ref"))},
                     tmp_path, timeout=240)
    members = [o for o in outs if o["member"]]
    assert len(members) == 4
    for o in outs:
        assert o["shape_b"] == [2, 2] and o["local_a"] == [2, 4]
        assert o["ref_step"] == 11 and o["ref_local"] == [4, 1]
        np.testing.assert_array_equal(np.float32(o["ref_a"]), a)
        np.testing.assert_array_equal(
            np.float32(o["ref_c"]),
            c.astype(ml_dtypes.bfloat16).astype(np.float32))
        assert o["ref_dtype"] == "torch.bfloat16"
    for o in members:
        assert o["ok"] and o["ndev"] == 4 and o["local_b"] == [4, 4]
        assert o["step"] == 3 and o["restored"] and o["sharded"] > 0
