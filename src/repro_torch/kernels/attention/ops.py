"""Flash-attention forward: the hand-written CUDA kernel
(`csrc/flash_attention.cu`) and, beside it, its plain PyTorch version.

Port of `repro.kernels.attention` (the `ops.flash_attention` wrapper, the
Pallas kernel in `kernel.py` and the oracle in `ref.py`). The layout is the
JAX one: q [B, Sq, Hq, hd], k and v [B, Sk, Hkv, hd] with Hq % Hkv == 0;
the output is fp32 [B, Sq, Hq, hd].

`flash_attention` chooses by device: a CPU tensor goes to
`attention_plain`, a CUDA tensor launches the kernel or raises. The
kernel computes both products on the tensor cores as 3xTF32
(`csrc/tf32x3.cuh`), to fp32 accuracy. Its tiles are fixed, 64 query rows
by 32 keys, so the TPU wrapper's `bq`/`bk`/`interpret` arguments have no
counterpart. Unlike the TPU wrapper, which zero-pads Sk and masks the
padded keys only through the causal test, the kernel masks keys by the
true Sk, so non-causal ragged shapes agree with `ref.attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, forward_only

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's template instances

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p])


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Dense masked softmax over einsums, in fp32: what the kernel
    computes, written as `repro.kernels.attention.ref.attention_ref`."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if causal or window:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= (qpos - kpos) < window
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, Hq, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention forward, fp32 out. CPU tensors take `attention_plain`;
    CUDA tensors launch the kernel, which counts its launches in
    `flash_attention.launches`. Forward only: raises when grad is enabled
    and an input requires grad."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, H, hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v must be [{B}, Sk, Hkv, {hd}]; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(B, Sq, Hq, hd, k.shape[1], k.shape[2]) < 1 or Hq % k.shape[2]:
        raise ValueError(f"empty shape or Hq={Hq} not a multiple of "
                         f"Hkv={k.shape[2]}")
    if not (q.is_floating_point() and k.is_floating_point()
            and v.is_floating_point()):
        raise TypeError("q, k, v must be floating point")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention route for {q.device}")
    return _launch(q.float(), k.float(), v.float(), causal, window, softcap)


flash_attention.launches = 0


def _copyable(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when cp.async can copy its rows in 16-byte units (unit
    stride on hd, other strides multiples of 4 floats, 16-byte aligned),
    else a contiguous copy, which is."""
    sb, ss, sh, sd = t.stride()
    if sd == 1 and not (sb | ss | sh) & 3 and not t.data_ptr() & 15:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal, window, softcap):
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}; "
                         f"got {hd}")
    q, k, v = _copyable(q), _copyable(k), _copyable(v)
    fn = build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    o = torch.empty((B, Sq, Hq, hd), dtype=torch.float32, device=q.device)
    err = build.call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     int(causal), int(window), float(softcap),
                     1.0 / math.sqrt(hd))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o
