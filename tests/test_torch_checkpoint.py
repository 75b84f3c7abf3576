"""The port's checkpoints (`repro_torch.checkpoint`) on the CPU: the
counterparts of tests/test_optim_ckpt.py's checkpoint tests (round trip,
corruption detected, rotation, async, a missing directory), atomic saves,
and the on-disk format shared with the reference in both directions: the
reference's `ckpt.validate` accepts a checkpoint the port wrote, with the
same manifest and the same npz members byte for byte, bf16 leaves
included, and the port restores one the reference wrote, each leaf's
bytes equal and bf16 as bf16. The reference's own restore hands bf16
leaves back as 2-byte void records (ROADMAP C.13), pinned here.

The tree is reduced gemma2-2b's bf16 params (JAX's seed-0 init, bridged)
with an AdamW state whose moments and step are not zero.
"""
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.optim import AdamWState as JaxAdamWState
from repro_torch.bridge import adamw_state_from_jax, params_from_jax
from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.configs import get_reduced
from repro_torch.optim import AdamWState


def _named(tree, prefix=""):
    if isinstance(tree, AdamWState):
        return [p for f in tree._fields
                for p in _named(getattr(tree, f), f"{prefix}/{f}")]
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _named(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.fixture(scope="module")
def state():
    """(params, AdamW state) of reduced gemma2-2b in bf16, as the port
    holds them: blocks a list of per-layer dicts."""
    cfg = get_reduced("gemma2-2b")
    jparams = jax.jit(jax_build_model(jax_get_reduced("gemma2-2b")).init)(
        jax.random.PRNGKey(0))
    jstate = JaxAdamWState(step=jnp.asarray(3, jnp.int32),
                           m=jax.tree.map(lambda p: p * 0.5, jparams),
                           v=jax.tree.map(lambda p: p * p, jparams))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return (params_from_jax(to_np(jparams), cfg, device="cpu"),
            adamw_state_from_jax(to_np(jstate), cfg, device="cpu"))


def _as_jax(tree):
    """The port's tree as a JAX tree of the same structure and dtypes."""
    if isinstance(tree, AdamWState):
        return JaxAdamWState(*(_as_jax(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_jax(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _bits(t: torch.Tensor) -> bytes:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
        .contiguous().numpy().tobytes()


def _same(a, b) -> None:
    na, nb = _named(a), _named(b)
    assert [n for n, _ in na] == [n for n, _ in nb]
    for (name, x), (_, y) in zip(na, nb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def test_state_has_bf16_leaves_and_a_step(state):
    params, opt = state
    dtypes = {t.dtype for _, t in _named(state)}
    assert {torch.bfloat16, torch.float32, torch.int32} <= dtypes
    assert int(opt.step) == 3 and isinstance(params["blocks"], list)


def test_checkpoint_roundtrip(tmp_path, state):
    path = str(tmp_path / "c1")
    ckpt.save(path, state, step=7)
    assert ckpt.load_step(path) == 7 and ckpt.validate(path)
    restored, step = ckpt.restore(path, state, device="cpu")
    assert step == 7
    assert isinstance(restored[1], AdamWState)
    assert list(restored[0]) == list(state[0])  # dicts keep their order
    _same(restored, state)


def test_checkpoint_corruption_detected(tmp_path, state):
    path = str(tmp_path / "c2")
    ckpt.save(path, state, step=1)
    assert ckpt.validate(path)
    # corrupt the payload (truncation = torn write)
    pz = os.path.join(path, "data.npz")
    with open(pz, "r+b") as f:
        f.truncate(os.path.getsize(pz) - 64)
    assert not ckpt.validate(path)


def test_checkpoint_flipped_byte_detected(tmp_path, state):
    """A changed record, not a truncation: the checksum catches it."""
    path = str(tmp_path / "c3")
    ckpt.save(path, state, step=1)
    pz = os.path.join(path, "data.npz")
    with zipfile.ZipFile(pz) as zf:
        info = zf.getinfo("leaf_0.npy")
        offset = info.header_offset + len(info.FileHeader()) + info.file_size - 1
    with open(pz, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 1]))
    assert not ckpt.validate(path)


def test_manager_restores_latest_valid_and_rotates(tmp_path, state):
    params, _ = state
    mgr = CheckpointManager(str(tmp_path), keep=2, use_async=False)
    for s in (1, 2, 3):
        mgr.save(s, {**params, "final_norm": params["final_norm"] + s})
    assert mgr.all_steps() == [2, 3]  # rotation dropped step 1
    # corrupt newest (truncate payload) -> restore falls back to step 2
    p3 = os.path.join(str(tmp_path), "ckpt_0000000003", "data.npz")
    with open(p3, "r+b") as f:
        f.truncate(os.path.getsize(p3) // 2)
    restored, step = mgr.restore_latest(params, device="cpu")
    assert step == 2
    torch.testing.assert_close(restored["final_norm"],
                               params["final_norm"] + 2, rtol=0, atol=0)


def test_async_checkpointer(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), keep=3, use_async=True)
    mgr.save(5, state)
    mgr.wait()
    restored, step = mgr.restore_latest(state, device="cpu")
    assert step == 5
    _same(restored, state)


def test_async_copies_before_returning(tmp_path, state):
    """The host copy is taken on the caller's thread: a tensor changed in
    place after `save` returns is written as it was."""
    t = {"w": torch.arange(6, dtype=torch.float32)}
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "a"), t, step=1)
    t["w"].add_(100)
    saver.wait()
    got, _ = ckpt.restore(str(tmp_path / "a"), t, device="cpu")
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_async_error_surfaces_at_next_wait(tmp_path):
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "no" / "such" / "dir" / "c"),
               {"w": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        saver.wait()
    saver.wait()  # raised once


def test_failed_save_leaves_the_previous_checkpoint(tmp_path, state,
                                                    monkeypatch):
    """A save that dies mid-write leaves neither a partial checkpoint nor
    its temp dir, and the checkpoint already at that path stays valid."""
    path = str(tmp_path / "c")
    ckpt.save(path, state, step=1)
    calls = []

    def dying(fid, t, a):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("host preempted")
        return write_leaf(fid, t, a)

    write_leaf = ckpt._write_leaf
    monkeypatch.setattr(ckpt, "_write_leaf", dying)
    with pytest.raises(OSError, match="preempted"):
        ckpt.save(path, state, step=2)
    assert sorted(os.listdir(tmp_path)) == ["c"]
    assert ckpt.validate(path) and ckpt.load_step(path) == 1


def test_restore_missing_returns_none(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    tree, step = mgr.restore_latest(state, device="cpu")
    assert tree is None and step == -1


def test_sharded_restore_waits_for_distributed(tmp_path, state):
    """The sharded restore is ported: `shardings` (a tree of
    `distributed.sharding.NamedSharding`) places each leaf as a DTensor on
    its mesh, here a (1, 1) mesh over a gloo world of one, with every
    value and dtype kept; `restore_latest` takes it too. The multi-rank
    case (a shrunk mesh, the reference's checkpoint) is held in
    tests/test_torch_distributed.py."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as launch_mesh

    path = str(tmp_path / "c")
    ckpt.save(path, state, step=4)
    CheckpointManager(str(tmp_path / "m")).save(4, state, block=True)
    launch_mesh.init_world("cpu")
    try:
        mesh = launch_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
        shardings = sh.named(mesh, sh.map_with_path(
            lambda _, t: sh.P(*([None] * t.ndim)), state))
        restored = [ckpt.restore(path, state, shardings=shardings),
                    CheckpointManager(str(tmp_path / "m")).restore_latest(
                        state, shardings=shardings)]
    finally:
        dist.destroy_process_group()
    for tree, step in restored:
        assert step == 4 and isinstance(tree[1], AdamWState)
        got, want = _named(tree), _named(state)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert isinstance(a, DTensor), name
            assert a.dtype == b.dtype and torch.equal(a.to_local(), b), name


def test_restore_refuses_another_structure(tmp_path, state):
    path = str(tmp_path / "c")
    ckpt.save(path, state[0])
    with pytest.raises(ValueError, match="leaves, expected"):
        ckpt.restore(path, state, device="cpu")


# ---------------------------------------------------------------------------
# the format, shared with the reference


def test_reference_validates_the_ports_checkpoint(tmp_path, state):
    """The reference writes the same tree (as JAX arrays) to the same
    manifest, checksums included, and the same npz members byte for
    byte; its `validate` accepts the port's checkpoint."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(ours, state, step=4, extra={"note": "x"})
    jax_ckpt.save(theirs, _as_jax(state), step=4, extra={"note": "x"})
    assert jax_ckpt.validate(ours)
    with open(os.path.join(ours, "manifest.json")) as f:
        mine = f.read()
    with open(os.path.join(theirs, "manifest.json")) as f:
        assert mine == f.read()
    assert '"dtype": "bfloat16"' in mine and '"name": "1/.step"' in mine
    with zipfile.ZipFile(os.path.join(ours, "data.npz")) as a, \
            zipfile.ZipFile(os.path.join(theirs, "data.npz")) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name


def test_port_restores_the_references_checkpoint(tmp_path, state):
    """Each leaf the reference wrote comes back in its dtype, bf16 as
    bf16, with its bytes equal, into the port's structure."""
    path = str(tmp_path / "ref")
    jtree = _as_jax(state)
    jax_ckpt.save(path, jtree, step=9)
    assert ckpt.validate(path)
    restored, step = ckpt.restore(path, state, device="cpu")
    assert step == 9
    jleaves = jax.tree.leaves(jtree)
    got = [t for _, t in ckpt._flatten_with_names(restored)]
    assert len(got) == len(jleaves)
    for t, j in zip(got, jleaves):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert _bits(t) == np.asarray(j).tobytes()
    _same(restored, state)


def test_reference_restore_returns_bf16_as_void_records(tmp_path, state):
    """ROADMAP C.13: the reference's `restore` hands a bf16 leaf back as an
    array of 2-byte void records, not bf16; the bytes are right, the
    dtype is lost. The port restores the same file as bf16 (above)."""
    path = str(tmp_path / "ref")
    jtree = _as_jax(state)
    jax_ckpt.save(path, jtree)
    restored, _ = jax_ckpt.restore(path, jtree)
    pairs = list(zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)))
    bf16 = [(r, j) for r, j in pairs if j.dtype == jnp.bfloat16]
    assert bf16
    for r, j in bf16:
        assert r.dtype.kind == "V" and r.dtype.itemsize == 2
        assert r.tobytes() == np.asarray(j).tobytes()
    assert all(r.dtype == j.dtype for r, j in pairs
               if j.dtype != jnp.bfloat16)
