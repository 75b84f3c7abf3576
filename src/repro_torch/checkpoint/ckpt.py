"""Fault-tolerant checkpointing, ported from `repro.checkpoint.ckpt`, in
the reference's on-disk format.

- atomic: writes go to a temp dir, fsync'd, then renamed; a manifest with
  per-leaf checksums validates integrity on restore (a torn write from a
  preempted host is detected and the checkpoint is skipped).
- async: `AsyncCheckpointer` copies device tensors to the host on the
  caller's thread, then writes on a worker thread, so the training loop
  is blocked only for the device->host copy.
- sharded and elastic restore: `restore(..., shardings=)` places each
  leaf by its `distributed.sharding.NamedSharding` on any mesh, each rank
  keeping its own shard (`distributed/elastic.py::elastic_restore`).

Format, as the reference writes it: ``data.npz`` holding ``leaf_{i}`` in
JAX's flattening order (dict keys sorted, lists, tuples and NamedTuple
fields in order, None an empty subtree), and ``manifest.json`` with the
step, each leaf's name (its path joined by "/", a NamedTuple field as
".field"), shape, dtype string and the first 16 hex digits of the sha256
of its bytes. numpy has no bfloat16 of its own: the reference's npz holds
a bf16 leaf as 2-byte void records (``'<V2'``), and so does the port's,
byte for byte. Restore gives torch tensors in the manifest's dtype, bf16
included, on the device the caller names. No external deps.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's `tree_flatten_with_path` order, named as
    the reference names them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [pair for key, sub in items
            for pair in _flatten_with_names(sub, prefix + (key,))]


def _unflatten(like, leaves):
    """A tree of `like`'s structure (dicts keep their own key order)
    holding `leaves`, given in `_flatten_with_names` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype ("bfloat16" for torch's bf16, as
    `str` of the reference's ml_dtypes array gives)."""
    return str(t.dtype).removeprefix("torch.")


def _host(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor of its own, safe to write while the caller
    goes on."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _raw(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a numpy array: itself, or for bf16 its bits as
    int16 (numpy has no bf16)."""
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()[:16]


def _write_leaf(fid, t: torch.Tensor, a: np.ndarray) -> None:
    """One ``.npy`` member as `np.savez` writes the reference's leaf: a bf16
    leaf as a '<V2' header and its raw records."""
    if t.dtype == torch.bfloat16:
        np.lib.format.write_array_header_1_0(
            fid, {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(a.shape)})
        fid.write(memoryview(np.ascontiguousarray(a)).cast("B"))
    else:
        np.lib.format.write_array(fid, a, allow_pickle=True)


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_host(path: str, named, step: int, extra: Optional[dict]) -> None:
    """Atomic save of (name, CPU tensor) pairs."""
    manifest = {"step": step, "leaves": {}, "extra": extra or {},
                "format": "full", "treedef": None}
    parent = os.path.dirname(os.path.abspath(path)) or "."
    tmp = tempfile.mkdtemp(dir=parent)
    try:
        data = os.path.join(tmp, "data.npz")
        with zipfile.ZipFile(data, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for i, (name, t) in enumerate(named):
                key = f"leaf_{i}"
                a = _raw(t)
                manifest["leaves"][key] = {
                    "name": name, "shape": list(a.shape),
                    "dtype": _dtype_name(t), "sum": _checksum(a)}
                with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                    _write_leaf(fid, t, a)
        _fsync(data)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        _fsync(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save(path: str, tree, step: int = 0, extra: Optional[dict] = None) -> None:
    """Atomic full-tree save (gathered to the host)."""
    _save_host(path, [(n, _host(l)) for n, l in _flatten_with_names(tree)],
               step, extra)


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor of the manifest's dtype, sharing the
    array's memory (a bf16 leaf's '<V2' records reinterpreted)."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _read(path: str, manifest: dict, device=None, check: bool = True):
    """The checkpoint's leaves in order, each member of ``data.npz`` read
    once: tensors on `device` (none kept where `device` is None), or None
    where `check` finds a leaf whose shape or checksum differs from its
    manifest entry."""
    leaves = []
    with np.load(os.path.join(path, "data.npz")) as data:
        for i in range(len(manifest["leaves"])):
            meta = manifest["leaves"][f"leaf_{i}"]
            a = data[f"leaf_{i}"]
            if check and (list(a.shape) != meta["shape"] or
                          _checksum(a) != meta["sum"]):
                return None
            if device is not None:
                leaves.append(_tensor(a, meta["dtype"]).to(device))
    return leaves


def validate(path: str) -> bool:
    try:
        return _read(path, _manifest(path)) is not None
    except Exception:
        return False


def _count(manifest: dict, like) -> None:
    n = len(manifest["leaves"])
    expected = len(_flatten_with_names(like))
    if n != expected:
        raise ValueError(f"checkpoint has {n} leaves, expected {expected}")


def _place(leaves, shardings):
    """Each leaf (on the host) as a DTensor by its `NamedSharding` in
    `shardings`, a tree of `like`'s structure."""
    return [s.place(t) for t, (_, s) in
            zip(leaves, _flatten_with_names(shardings), strict=True)]


def restore(path: str, like, device=None, shardings=None):
    """Restore into the structure of `like`: (tree, step), each leaf a
    tensor in the dtype it was saved in on `device` (CUDA unless given:
    `resolve_device`). If `shardings` (a tree of
    `distributed.sharding.NamedSharding` matching `like`) is given, each
    leaf is placed by it as a DTensor on its mesh's device instead: the
    elastic path, onto a mesh of any shape."""
    host = "cpu" if shardings is not None else resolve_device(device)
    manifest = _manifest(path)
    _count(manifest, like)
    leaves = _read(path, manifest, host, check=False)
    if shardings is not None:
        leaves = _place(leaves, shardings)
    return _unflatten(like, leaves), manifest["step"]


def restore_if_valid(path: str, like, device=None, shardings=None):
    """`validate` and `restore` in one read of the payload, each leaf
    checked as it is read: (tree, step), or None where `validate` would
    fail. Raises as `restore` does for a tree of another structure."""
    device = "cpu" if shardings is not None else resolve_device(device)
    try:
        manifest = _manifest(path)
    except Exception:
        return None
    _count(manifest, like)
    try:
        leaves = _read(path, manifest, device)
    except Exception:
        return None
    if leaves is None:
        return None
    if shardings is not None:
        leaves = _place(leaves, shardings)
    return _unflatten(like, leaves), manifest["step"]


def load_step(path: str) -> int:
    return _manifest(path)["step"]


class AsyncCheckpointer:
    """Device->host copy on the caller thread; disk write on a worker
    thread. `wait()` joins the in-flight write and raises its error, if it
    had one (call before exit and before starting a save to the same
    path). `write_seconds` is the host time the last finished write took
    on its thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.write_seconds: Optional[float] = None

    def save(self, path: str, tree, step: int = 0,
             extra: Optional[dict] = None) -> None:
        self.wait()
        named = [(n, _host(l)) for n, l in _flatten_with_names(tree)]

        def work():
            start = time.perf_counter()
            try:
                _save_host(path, named, step, extra)
                self.write_seconds = time.perf_counter() - start
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
