"""The CPU-side logic of the port's kernel build and dispatch: where the
libraries go, when they are rebuilt, and what happens where no kernel can
run. The kernels themselves build and run only on a GPU machine
(tests/test_torch_cuda.py)."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops
from repro_torch.kernels.rwkv import ops as wkv_ops


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
    lambda t: wkv_ops.wkv(t, t, t, t, t[0, 0]),
])
def test_wrappers_refuse_devices_without_a_route(call):
    t = torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="route"):
        call(t)


def _wkv_inputs(n, T=6):
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((2, T, 3, n), generator=gen) for _ in range(3))
    logw = -torch.rand((2, T, 3, n), generator=gen)
    return r, k, v, logw, torch.randn((3, n), generator=gen)


def test_wkv_library_is_its_own_source():
    path = build.library_path("wkv6")
    assert path.name.startswith("libwkv6-") and path.parent == build.BUILD_DIR


def test_wkv_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached the kernel launch")

    monkeypatch.setattr(wkv_ops, "_launch", no_kernel)
    before = wkv_ops.wkv.launches
    inputs = _wkv_inputs(48)  # any head size: the plain version takes all
    o, s = wkv_ops.wkv(*inputs, return_state=True)
    want_o, want_s = wkv_ops.wkv_plain(*inputs)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    assert torch.equal(wkv_ops.wkv(*inputs), want_o)
    assert wkv_ops.wkv.launches == before


def test_wkv_launch_refuses_unsupported_head_sizes(monkeypatch):
    def no_build(name):
        raise AssertionError("the kernel was loaded for an unsupported n")

    monkeypatch.setattr(build, "load", no_build)
    for n in (8, 48, 128):
        with pytest.raises(ValueError, match="head sizes"):
            wkv_ops._launch(*_wkv_inputs(n), None)


@pytest.mark.parametrize("change,error", [
    (lambda a: {**a, "k": a["k"][:, :-1]}, ValueError),      # shape
    (lambda a: {**a, "u": a["u"][:2]}, ValueError),           # u [H, n]
    (lambda a: {**a, "s0": torch.zeros((2, 3, 16, 8))}, ValueError),
    (lambda a: {**a, "v": a["v"].double()}, TypeError),       # fp32 only
    (lambda a: {**a, "r": a["r"][0]}, ValueError),            # rank
])
def test_wkv_rejects_bad_inputs(change, error):
    args = dict(zip(("r", "k", "v", "logw", "u"), _wkv_inputs(16)))
    with pytest.raises(error):
        wkv_ops.wkv(**change(args))
