"""Flash-attention forward: two hand-written CUDA kernels and, beside
them, their plain PyTorch version.

Port of `repro.kernels.attention` (the `ops.flash_attention` wrapper, the
Pallas kernel in `kernel.py` and the oracle in `ref.py`). The layout is the
JAX one: q [B, Sq, Hq, hd], k and v [B, Sk, Hkv, hd] with Hq % Hkv == 0;
the output is [B, Sq, Hq, hd] in `out_dtype` (fp32 by default, the TPU
kernel's type).

`flash_attention` chooses by device: a CPU tensor goes to
`attention_plain`, a CUDA tensor launches a kernel or raises. On the card
it chooses by dtype. bf16 q, k and v, as every LM passes them, go to
`csrc/flash_attention_bf16.cu`, read in place: S = Q K^T as one bf16
tensor-core product with fp32 accumulation, P split into two bf16 terms
for P V; the output is written once in fp32 or bf16. Other inputs go to
`csrc/flash_attention.cu` in fp32 (copied where they are another type),
which computes both products as 3xTF32 (`csrc/tf32x3.cuh`); its fp32
output is cast to `out_dtype`. Both meet the TPU kernel's function to
fp32 accuracy. Their tiles are fixed (64 query rows by 64 or 32 keys), so the
TPU wrapper's `bq`/`bk`/`interpret` arguments have no counterpart. Unlike
the TPU wrapper, which zero-pads Sk and masks the padded keys only through
the causal test, the kernels mask keys by the true Sk, so non-causal
ragged shapes agree with `ref.attention_ref`.
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
# the kernels by route: source, entry point, argument types (the bf16
# kernel's add out_bf16 before the stream)
_KERNELS = {
    "fp32": ("flash_attention", "flash_attention_fwd", _ARGTYPES),
    "bf16": ("flash_attention_bf16", "flash_attention_bf16_fwd",
             _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]),
}


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
                    softcap: float = 0.0,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Attention forward, in `out_dtype`. CPU tensors take
    `attention_plain`; CUDA tensors launch a kernel: the bf16 one where q,
    k and v are all bf16, else the 3xTF32 one on fp32 copies. Each launch
    counts in `flash_attention.launches` and, by kernel, in
    `flash_attention.route_launches`. Forward only: raises when grad is
    enabled and an input requires grad."""
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
    if not out_dtype.is_floating_point:
        raise TypeError(f"out_dtype must be floating point; got {out_dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap).to(out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention route for {q.device}")
    if q.dtype == k.dtype == v.dtype == torch.bfloat16:
        o = _launch("bf16", q, k, v, causal, window, softcap,
                    out_bf16=out_dtype == torch.bfloat16)
    else:
        o = _launch("fp32", q.float(), k.float(), v.float(), causal, window,
                    softcap, out_bf16=False)
    return o.to(out_dtype)


flash_attention.launches = 0
# launches by kernel: "fp32" the 3xTF32 one, "bf16" the bf16 one
flash_attention.route_launches = {"fp32": 0, "bf16": 0}


def _copyable(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when cp.async can copy its rows in 16-byte units: unit
    stride on hd, the other strides multiples of 16 bytes in elements (4
    for fp32, 8 for bf16) and the data 16-byte aligned; else a contiguous
    copy, which is."""
    unit = 16 // t.element_size() - 1
    sb, ss, sh, sd = t.stride()
    if sd == 1 and not (sb | ss | sh) & unit and not t.data_ptr() & 15:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(route, q, k, v, causal, window, softcap, out_bf16):
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims {HEAD_DIMS}; "
                         f"got {hd}")
    q, k, v = _copyable(q), _copyable(k), _copyable(v)
    fn = build.entry(*_KERNELS[route])
    o = torch.empty((B, Sq, Hq, hd), device=q.device,
                    dtype=torch.bfloat16 if out_bf16 else torch.float32)
    err = build.call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     int(causal), int(window), float(softcap),
                     1.0 / math.sqrt(hd),
                     *((int(out_bf16),) if route == "bf16" else ()))
    if err:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return o
