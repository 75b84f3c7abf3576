"""The port's CUDA kernels on the card against their plain versions.

These need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so on a
machine without a card every test here skips. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops
from repro_torch.kernels.rwkv import ops as wkv_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator().manual_seed(0)


def _randn(gen, shape):
    return torch.randn(shape, generator=gen).cuda()


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", [
    (16, 197, 3, 3, 64, False, 0, 0.0),   # DeiT-tiny main path
    (2, 100, 2, 2, 32, False, 0, 0.0),    # ragged, non-causal
    (2, 100, 2, 2, 32, True, 0, 0.0),
    (2, 256, 4, 4, 64, True, 48, 30.0),
    (2, 200, 4, 4, 32, False, 64, 0.0),
    (2, 192, 8, 2, 64, True, 0, 0.0),     # GQA
    (1, 130, 2, 2, 16, False, 0, 50.0),
    (1, 130, 2, 2, 128, True, 0, 0.0),
])
def test_flash_kernel_matches_plain(gen, B, S, Hq, Hkv, hd, causal, window,
                                    softcap):
    q, k, v = _randn(gen, (B, S, Hq, hd)), _randn(gen, (B, S, Hkv, hd)), \
        _randn(gen, (B, S, Hkv, hd))
    before = att_ops.flash_attention.launches
    got = att_ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    want = att_ops.attention_plain(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    assert att_ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_flash_kernel_reads_strided_inputs(gen):
    # q, k, v as views into one fused [B, S, 3, H, hd] projection
    qkv = _randn(gen, (2, 197, 3, 3, 64))
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(att_ops.flash_attention(q, k, v, causal=False),
                               att_ops.attention_plain(q, k, v, causal=False),
                               rtol=2e-4, atol=2e-5)


def test_flash_kernel_rejects_unsupported_head_dim(gen):
    q = _randn(gen, (1, 8, 2, 48))
    with pytest.raises(ValueError):
        att_ops.flash_attention(q, q, q)


@pytest.mark.parametrize("n,dx,dy", [(3152, 192, 192), (200, 300, 300),
                                     (520, 192, 192), (100, 1000, 1000),
                                     (300, 192, 100)])
def test_cka_kernel_matches_plain(gen, n, dx, dy):
    x, y = _randn(gen, (n, dx)), _randn(gen, (n, dy))
    y[:, :min(dx, dy)] += 0.3 * x[:, :min(dx, dy)]
    got = torch.stack(cka_ops.cka_terms(x, y))
    hsic, kk, ll = cka_ops.cka_terms_plain(cka_ops._prepare(x),
                                           cka_ops._prepare(y))
    torch.testing.assert_close(got, torch.stack([hsic, kk.sqrt(), ll.sqrt()]),
                               rtol=1e-4, atol=0.0)


def test_cka_kernel_is_deterministic_and_one_on_itself(gen):
    x, y = _randn(gen, (3152, 192)), _randn(gen, (3152, 192))
    assert torch.equal(torch.stack(cka_ops.cka_terms(x, y)),
                       torch.stack(cka_ops.cka_terms(x, y)))
    assert abs(float(cka_ops.cka(x, x)) - 1.0) < 1e-5


def _wkv_inputs(gen, B, T, H, n):
    r, k, v = (_randn(gen, (B, T, H, n)) for _ in range(3))
    logw = -(0.3 + 0.15 * torch.rand((B, T, H, n), generator=gen)).cuda()
    return r, k, v, logw, (0.3 * torch.randn((H, n), generator=gen)).cuda()


@pytest.mark.parametrize("B,T,H,n", [
    (4, 512, 40, 64),   # rwkv6-3b prefill
    (1, 50, 4, 16),     # ragged T, reduced head size
    (2, 130, 3, 32),
    (2, 1, 2, 64),
])
def test_wkv_kernel_matches_plain(gen, B, T, H, n):
    inputs = _wkv_inputs(gen, B, T, H, n)
    s0 = 0.1 * _randn(gen, (B, H, n, n))
    before = wkv_ops.wkv.launches
    o, s = wkv_ops.wkv(*inputs, s0=s0, return_state=True)
    want_o, want_s = wkv_ops.wkv_plain(*inputs, s0=s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == before + 1
    torch.testing.assert_close(o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)


def test_wkv_kernel_is_deterministic(gen):
    inputs = _wkv_inputs(gen, 4, 512, 40, 64)
    first = wkv_ops.wkv(*inputs, return_state=True)
    second = wkv_ops.wkv(*inputs, return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_wkv_kernel_rejects_unsupported_head_size(gen):
    with pytest.raises(ValueError, match="head sizes"):
        wkv_ops.wkv(*_wkv_inputs(gen, 1, 8, 2, 48))
