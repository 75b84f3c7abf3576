"""The CPU-side logic of the port's kernel build and dispatch: where the
libraries go, when they are rebuilt, and what happens where no kernel can
run. The kernels themselves build and run only on a GPU machine
(tests/test_torch_cuda.py)."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops


def test_library_names_carry_the_source_hash(tmp_path, monkeypatch):
    a = build.library_path("flash_attention")
    b = build.library_path("cka_terms")
    assert a.parent == b.parent == build.BUILD_DIR
    assert a.name.startswith("libflash_attention-") and a.suffix == ".so"
    assert a != b and a == build.library_path("flash_attention")
    # an edited source gets a new library name, so a stale build is never loaded
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one")
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two")
    assert build.library_path("k") != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["cka_terms"])


def test_build_skips_sources_already_built(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.library_path("cka_terms").write_bytes(b"")
    assert build.build(["cka_terms"]) == {}


@pytest.mark.parametrize("call", [
    lambda t: att_ops.flash_attention(t, t, t),
    lambda t: cka_ops.cka_terms(t[0, :, 0], t[0, :, 0]),
])
def test_wrappers_refuse_devices_without_a_route(call):
    t = torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="route"):
        call(t)
