"""The CPU-side logic of the port's kernel build and dispatch: where the
libraries go, when they are rebuilt, and what happens where no kernel can
run. The kernels themselves build and run only on a GPU machine
(tests/test_torch_cuda.py)."""
import ctypes
import types

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


def test_library_names_carry_the_shared_headers_hash(tmp_path, monkeypatch):
    # the sources include csrc/*.cuh (tf32x3.cuh): an edited header must
    # give every library a new name, or a stale build would be loaded
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"')
    (tmp_path / "h.cuh").write_text("// one")
    first = build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// a new header")
    assert build.library_path("k") not in (first, second)
    assert build.library_path("k") == build.library_path("k")


def test_kernel_sources_share_the_tf32x3_header():
    assert (build.CSRC / "tf32x3.cuh").is_file()
    for name in ("flash_attention", "cka_terms"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "tf32x3.cuh"' in source


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


def test_entry_sets_argument_types_once(monkeypatch):
    loads = []
    lib = types.SimpleNamespace(fwd=types.SimpleNamespace())

    def load(name):
        loads.append(name)
        return lib

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_ENTRIES", {})
    fn = build.entry("k", "fwd", [ctypes.c_int])
    assert fn is lib.fwd and fn.argtypes == [ctypes.c_int]
    assert fn.restype is ctypes.c_int
    fn.argtypes = None  # set again only if the entry were looked up anew
    assert build.entry("k", "fwd", [ctypes.c_int]) is fn
    assert fn.argtypes is None and loads == ["k"]


@pytest.mark.parametrize("current,guarded", [(0, False), (1, True)])
def test_call_passes_the_raw_stream_and_guards_another_device(
        monkeypatch, current, guarded):
    entered = []

    class Guard:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            entered.append(self.idx)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 1000 + idx, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    got = build.call(lambda *args: args, torch.device("cuda", 0), 7, 8)
    assert got == (7, 8, 1000)
    assert entered == ([0] if guarded else [])


def _hd_stride_2(t):
    return torch.stack([t, torch.zeros_like(t)], dim=-1)[..., 0]


def _misaligned(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape)  # one element past an aligned allocation
    out.copy_(t)
    return out


def _padded_rows(t, pad):
    padded = torch.zeros((*t.shape[:3], t.shape[3] + pad), dtype=t.dtype)
    padded[..., :-pad] = t
    return padded[..., :-pad]


# (layout, kept in fp32, kept in bf16): cp.async copies 16-byte units, 4
# fp32 or 8 bf16 elements
@pytest.mark.parametrize("layout,kept_fp32,kept_bf16", [
    (lambda t: t, True, True),
    (lambda t: torch.stack([t, t, t], dim=2).unbind(2)[1], True,
     True),  # fused qkv
    (_hd_stride_2, False, False),
    (_misaligned, False, False),
    (lambda t: _padded_rows(t, 1), False, False),  # odd row stride
    (lambda t: _padded_rows(t, 4), True, False),   # rows of 20 elements
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_inputs_are_copied_only_where_cp_async_cannot_read(
        layout, kept_fp32, kept_bf16, dtype):
    t = layout(torch.randn((2, 5, 3, 16), generator=torch.Generator()
                           .manual_seed(0)).to(dtype))
    out = att_ops._copyable(t)
    assert (out is t) == (kept_bf16 if dtype == torch.bfloat16
                          else kept_fp32)
    assert torch.equal(out, t) and out.stride(3) == 1 and out.dtype == dtype
    assert out.data_ptr() % 16 == 0
    assert all(s * out.element_size() % 16 == 0 for s in out.stride()[:3])


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
