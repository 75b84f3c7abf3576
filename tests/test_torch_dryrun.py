"""The port's dry run (`repro_torch.launch.specs`, `launch.dryrun`,
`harness.report`, `harness.run.roofline_table` and the
`distributed_dryrun` example) against the JAX package on the CPU.

- Specs at full size: on the 256- and 512-rank fake meshes, every leaf
  of `launch/specs.py`'s params, batches, caches and decode tokens has
  the reference's global shape, dtype and local shard shape (the
  reference's specs on a `jax.sharding.AbstractMesh`; a block or cache
  leaf the reference's without its stacked [G] dim).
- Reduced cells, port against reference: `run_cell` with `get_config`
  replaced by `get_reduced` in both packages (the reference's cells in
  one subprocess, started as the module begins): `memory_per_chip.
  argument` equal to the byte, `model_flops`, `status` and the record's
  keys equal; the probes' `outer + G * per_group` equal to the full
  count; the skip record of `long_500k` on an attention arch; the temp
  not above the gathering step's (commit c267de1; the sharded step's
  cells at full size are
  tests/test_torch_dryrun_sharded.py's).
- The report's markdown, summary and `roofline_table`'s rows identical
  to the reference's on the same records; `orchestrate` running two
  workers side by side; the example; `use_pallas` refused; a train
  step's loss and gradients alone (``update=False``); two equal steps
  in one process counted alike; an override of an unknown field
  refused.
"""
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import LM_SHAPES as JAX_LM_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models import transformer as jax_transformer
import repro_torch.configs as port_configs
from repro_torch.configs import ARCHS, LM_SHAPES, get_config, get_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.examples import distributed_dryrun
from repro_torch.harness import report
from repro_torch.harness import run as port_run
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.models import transformer
from torch_ranks import ROOT

# (arch, shape, freeze prefix): the cells held against the reference
CELLS = (("gemma2-2b", "train_4k", 0.0), ("gemma2-2b", "train_4k", 0.5),
         ("qwen3-moe-30b-a3b", "prefill_32k", 0.0),
         ("rwkv6-3b", "decode_32k", 0.0), ("gemma2-2b", "long_500k", 0.0))
# each cell's temp bytes at commit c267de1, whose step gathered every
# param whole
# (None: a skip); the sharded step's may not rise above them
TEMP_BEFORE = (67596611862.0, 36895582228.0, 2217132040.0, 547844.0, None)

REFERENCE = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun   # sets XLA_FLAGS first
    import repro.configs as C
    C.get_config = C.get_reduced
    out = [dryrun.run_cell(a, s, "single", freeze_prefix=p,
                           print_analysis=False)
           for a, s, p in json.loads(sys.argv[1])]
    print(json.dumps(out))
    """)

_REF = {}


@pytest.fixture(autouse=True, scope="module")
def reference_cells():
    """The reference's `CELLS`, in a subprocess started as the module
    begins (about a minute of XLA compiles), read when a test needs them."""
    _REF["proc"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    yield
    _REF["proc"].kill()
    _REF["proc"].communicate()


def _reference(i):
    if "records" not in _REF:
        out, err = _REF["proc"].communicate(timeout=600)
        assert _REF["proc"].returncode == 0, err[-3000:]
        _REF["records"] = json.loads(out.strip().splitlines()[-1])
    return _REF["records"][i]


@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setattr(port_configs, "get_config", get_reduced)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# specs at full size


def _jflat(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _pflat(tree):
    out = {}
    sh.map_with_path(lambda names, t: out.setdefault(tuple(names), t), tree)
    return out


def _shard(shape, spec, sizes):
    """The reference's local shard shape of `shape` placed by `spec`."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            out[d] //= sizes[a]
    return tuple(out)


def _hold(leaf, shape, dtype, spec, sizes, what):
    assert tuple(leaf.shape) == tuple(shape), what
    assert str(leaf.dtype).split(".")[-1] == jnp.dtype(dtype).name, what
    assert tuple(leaf.to_local().shape) == _shard(shape, spec, sizes), what


def _hold_stacked(port, jstructs, jspecs, g, sizes, layer_of):
    """Port leaves (one layer each) against the reference's (a [G] dim
    first), `layer_of(path)` the reference path of a port block path."""
    want, specs = _jflat(jstructs), _jflat(jspecs)
    n = 0
    for path, leaf in _pflat(port).items():
        ref = layer_of(path)
        if ref is None:
            _hold(leaf, want[path].shape, want[path].dtype, specs[path],
                  sizes, path)
        else:
            w = want[ref]
            _hold(leaf, w.shape[1:], w.dtype, tuple(specs[ref])[1:], sizes,
                  path)
        n += 1
    return n


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_specs_match_reference_at_full_size(mesh_name):
    shape, axes = dryrun.MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, axes)
    sizes = dict(zip(axes, shape))
    with dryrun.fake_world(mesh_name) as mesh:
        for arch in ARCHS:
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            g = jax_transformer.group_size(jcfg)
            jparams = jax.eval_shape(lambda: jax_transformer.init_lm(
                jax.random.PRNGKey(0), jcfg))
            params, _ = S.param_structs(cfg, mesh)
            n = _hold_stacked(
                params, jparams, jsh.param_specs(jparams, jcfg, jmesh), g,
                sizes, lambda p: ("blocks", str(int(p[1]) % g)) + p[2:]
                if p[0] == "blocks" else None)
            assert n == len(_pflat(params)) > 0
            for s, js in zip(LM_SHAPES, JAX_LM_SHAPES, strict=True):
                jb = jsh.batch_specs(jcfg, js, jmesh)
                B, L = s.global_batch, s.seq_len
                batch = (S.train_batch_specs if s.kind == "train"
                         else S.prefill_batch_specs)(cfg, s, mesh)
                for k, leaf in batch.items():
                    full = (B, L) if k != "frontend_embeds" else \
                        (B, cfg.frontend_tokens, cfg.frontend_dim)
                    dt = jnp.int32 if k != "frontend_embeds" else \
                        jnp.bfloat16
                    _hold(leaf, full, dt, tuple(jb[k]), sizes, (arch, k))
                if s.kind != "decode":
                    continue
                jcache = jax.eval_shape(lambda: jax_transformer.init_lm_cache(
                    jcfg, B, L, jnp.bfloat16))
                cache, _ = S.cache_structs(cfg, s, mesh)
                ref = {p: v for p, v in _jflat(jcache).items()}
                jspecs = _jflat(jsh.cache_specs(jcfg, js, jmesh, jcache))
                for path, leaf in _pflat(cache).items():
                    layer, name = int(path[0]), path[-1]
                    match = [p for p in ref if p[0] == str(layer % g)
                             and p[-1] == name]
                    assert len(match) == 1, path
                    w = ref[match[0]]
                    _hold(leaf, w.shape[1:], w.dtype,
                          tuple(jspecs[match[0]])[1:], sizes, (arch, path))
                tok = S.decode_token_specs(cfg, s, mesh)
                da = jsh.data_axes(jmesh)
                n_da = 1
                for a in da:
                    n_da *= sizes[a]
                spec = (da if n_da > 1 and B % n_da == 0 else None, None)
                _hold(tok, (B, 1), jnp.int32, spec, sizes, (arch, "tokens"))


# ---------------------------------------------------------------------------
# the port-only pieces


def test_cell_shapes_and_the_card_mesh(reduced):
    """`<kind>_<batch>x<seq>` shapes, and a cell on the (1, 1) mesh of a
    world of one: every byte of its arguments is the rank's."""
    s = dryrun.get_cell_shape("train_4x512")
    assert (s.kind, s.global_batch, s.seq_len, s.tokens) == \
        ("train", 4, 512, 2048)
    assert dryrun.get_cell_shape("decode_32k").seq_len == 32768
    rec = dryrun.run_cell("gemma2-2b", "train_4x64", "one",
                          print_analysis=False)
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["collective_counts"] == {}
    cfg = get_reduced("gemma2-2b")
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = transformer.init_lm(torch.Generator(), cfg)
    nbytes = sum(p.numel() * p.element_size()
                 for p in _pflat(params).values())
    assert rec["memory_per_chip"]["argument"] == 3 * nbytes + 4 + \
        2 * 4 * 64 * 4
    assert "probe_per_group" not in rec


def test_loss_and_gradients_alone(reduced):
    """``update=False``: the train step stops before AdamW. Its arguments
    are the params and the batch, no moments; its outputs the loss and
    the gradients; its peak at most the whole step's; the record says
    so. A step that is not a train step is refused."""
    whole = dryrun.run_cell("gemma2-2b", "train_4x64", "one",
                            print_analysis=False)
    alone = dryrun.run_cell("gemma2-2b", "train_4x64", "one", update=False,
                            print_analysis=False)
    assert alone["status"] == "ok" and alone["update"] is False
    assert "update" not in whole
    cfg = get_reduced("gemma2-2b")
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = transformer.init_lm(torch.Generator(), cfg)
    nbytes = sum(p.numel() * p.element_size()
                 for p in _pflat(params).values())
    mem = alone["memory_per_chip"]
    assert mem["argument"] == nbytes + 2 * 4 * 64 * 4
    assert mem["output"] == nbytes + 4          # the gradients, the loss
    assert 0 < mem["temp"] <= whole["memory_per_chip"]["temp"]
    assert alone["flops_per_chip"] < whole["flops_per_chip"]
    with pytest.raises(ValueError, match="train step"):
        dryrun.run_cell("gemma2-2b", "prefill_32k", "one", update=False,
                        print_analysis=False)


def test_two_equal_steps_count_alike(reduced):
    """Two equal steps in one process count the same FLOPs, bytes,
    collectives and peak: DTensor's sharding propagation, which runs an
    op on global-shaped fake tensors the first time it meets the op's
    shapes, is muted in the counter (`StepCostCounter.__enter__`). A
    torch release that moves that propagation out of the method the
    counter wraps makes the first step count more, and fails here."""
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.optim import AdamWConfig

    cfg = get_reduced("gemma2-2b")
    shape = dryrun.get_cell_shape("train_4k")
    with dryrun.fake_world("single") as mesh:
        runs = [dryrun.count_step(cfg, shape, mesh, ShardingPolicy(),
                                  AdamWConfig(lr=1e-4, clip_norm=0.0))
                for _ in range(2)]
    first, second = (r["counter"] for r in runs)
    assert first.collectives.counts and first.count.total > 0
    assert first.count.total == second.count.total
    assert first.bytes == second.bytes
    assert first.collectives.bytes_per_chip == \
        second.collectives.bytes_per_chip
    assert first.collectives.counts == second.collectives.counts
    assert runs[0]["memory"] == runs[1]["memory"]


def test_overrides_of_unknown_fields_are_refused(reduced, monkeypatch):
    """`REPRO_OVERRIDES` of a field the port's config lacks (the
    reference's `scan_unroll`: the port's layers are always a Python
    loop) fails, rather than being taken and ignored."""
    monkeypatch.setenv("REPRO_OVERRIDES", "scan_unroll=1")
    with pytest.raises(AttributeError, match="scan_unroll"):
        dryrun.run_cell("gemma2-2b", "train_4k", "single",
                        print_analysis=False)


def test_use_pallas_is_refused(reduced, monkeypatch):
    monkeypatch.setenv("REPRO_OVERRIDES", "use_pallas=true")
    with pytest.raises(NotImplementedError, match="data pointer"):
        dryrun.run_cell("gemma2-2b", "train_4k", "single",
                        print_analysis=False)


def test_orchestrate_runs_workers_side_by_side(tmp_path, monkeypatch):
    """Two full-width cells cut to two layers through REPRO_OVERRIDES, in
    two worker subprocesses at once: the records land, the summary counts
    them."""
    monkeypatch.setenv("REPRO_OVERRIDES", "num_layers=2")
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    cells = [("rwkv6-3b", "decode_32k", "single", "", ()),
             ("gemma2-2b", "long_500k", "single", "", ())]
    assert dryrun.orchestrate([], cells=cells, jobs=2, timeout=300,
                              results_dir=str(tmp_path)) == 0
    monkeypatch.setattr(report, "RESULTS_DIR", str(tmp_path))
    assert report.dryrun_summary("single") == \
        "single: 1 compiled, 1 skipped (documented), 0 errors"
    rec = json.loads((tmp_path / "rwkv6-3b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    # a cell whose record exists is not run again
    assert dryrun.orchestrate([], cells=cells[:1], jobs=1, timeout=1,
                              results_dir=str(tmp_path)) == 0


def test_example_runs_one_reduced_cell(reduced):
    buf = io.StringIO()
    with redirect_stdout(buf):
        distributed_dryrun.main(["--arch", "rwkv6-3b", "--shape",
                                 "decode_32k"])
    rec = json.loads(buf.getvalue())
    assert rec["status"] == "ok" and rec["mesh"] == "single"
    assert rec["dominant"] in ("compute", "memory", "collective")


# ---------------------------------------------------------------------------
# reduced cells against the reference

_PORT = {}


def _port(i):
    if i not in _PORT:
        arch, shape, prefix = CELLS[i]
        _PORT[i] = dryrun.run_cell(arch, shape, "single",
                                   freeze_prefix=prefix,
                                   print_analysis=False)
    return _PORT[i]


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{s}-{p}" for a, s, p in CELLS])
def test_reduced_cell_matches_reference(i, reduced):
    got, want = _port(i), _reference(i)
    assert got["status"] == want["status"]
    assert sorted(got) == sorted(want)
    if want["status"] == "skip":
        assert got["reason"] == want["reason"]
        return
    assert got["memory_per_chip"]["argument"] == \
        want["memory_per_chip"]["argument"]
    assert got["model_flops"] == want["model_flops"]
    assert got["chips"] == want["chips"] == 256
    assert got["remat"] == want["remat"] and got["fsdp"] == want["fsdp"]
    assert 0 < got["memory_per_chip"]["temp"] <= TEMP_BEFORE[i]
    if not CELLS[i][2]:
        G = transformer.num_groups(get_reduced(CELLS[i][0]))
        full = {"flops": got["flops_per_chip"],
                "bytes": got["bytes_per_chip"],
                "coll": got["collective_bytes_per_chip"]}
        for k, v in full.items():
            assert got["probe_outer"][k] + G * got["probe_per_group"][k] \
                == v, k


def _write(records, directory, *names):
    directory.mkdir(parents=True, exist_ok=True)
    for r in records:
        for name in names:
            (directory / name.format(**r)).write_text(json.dumps(r))


def test_report_matches_reference(tmp_path, monkeypatch):
    """`roofline_markdown`, `dryrun_summary` and `roofline_table` on the
    port's records of the reduced cells, one error record and a tagged
    one: the reference's strings and rows from the same files."""
    from benchmarks import report as jax_report
    from benchmarks import run as jax_run

    records = [_port(i) for i in range(len(CELLS)) if not CELLS[i][2]]
    records.append({"arch": "granite-20b", "shape": "train_4k",
                    "mesh": "single", "status": "error",
                    "error": "RuntimeError: out of memory somewhere deep",
                    "tag": ""})
    tagged = dict(_port(1), tag="half")
    ours = tmp_path / "port"
    theirs = tmp_path / "jax"
    for d in (ours, theirs / "results" / "dryrun"):
        _write(records, d, "{arch}__{shape}__{mesh}.json")
        _write([tagged], d, "{arch}__{shape}__{mesh}_half.json")
    monkeypatch.setattr(report, "RESULTS_DIR", str(ours))
    monkeypatch.setattr(jax_report, "HERE", str(theirs))
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(ours))
    monkeypatch.setattr(jax_run, "__file__", str(theirs / "run.py"))
    for mesh in ("single", "multi"):
        assert report.dryrun_summary(mesh) == jax_report.dryrun_summary(mesh)
    for tag in ("", "half"):
        assert report.roofline_markdown("single", tag) == \
            jax_report.roofline_markdown("single", tag)
    assert "| gemma2-2b | train_4k |" in report.roofline_markdown()
    outs = []
    for fn in (lambda: port_run.roofline_table(False),
               lambda: jax_run.roofline_table(False)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("roofline,") == 5
    assert "roofline" in port_run.TABLES
