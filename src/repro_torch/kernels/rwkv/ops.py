"""WKV6 recurrence: the hand-written CUDA kernel (`csrc/wkv6.cu`) and,
beside it, its plain PyTorch version.

Port of `repro.kernels.rwkv` (the `ops.wkv` wrapper, the Pallas kernel in
`kernel.py` and the oracle in `ref.py`). Per (batch, head), with state S
[n, n] and per-channel decay w_t = exp(logw_t):

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

The kernel runs the time loop to the true T, so nothing is padded, and it
also returns the final state, which a prefill hands to the decode cache.
One block steps a head's state through its whole sequence, its keys split
over lanes and its value columns over threads (`csrc/wkv6.cu` says how).

`wkv` chooses by device: a CPU tensor goes to `wkv_plain`, a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, forward_only

HEAD_SIZES = (16, 32, 64)  # the kernel's template instances

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def wkv_plain(r, k, v, logw, u, s0=None):
    """The exact sequential recurrence, as `repro.kernels.rwkv.ref.wkv_ref`
    computes it. r, k, v, logw: [B, T, H, n]; u: [H, n]; s0: [B, H, n, n].
    Returns (o [B, T, H, n], s_final [B, H, n, n]), fp32."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    B, T, H, n = r.shape
    S = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    u = u.float()
    outs = []
    for t in range(T):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, S)
                    + (rt * u * kt).sum(-1, keepdim=True) * vt)
        S = torch.exp(lwt)[..., None] * S + kt[..., :, None] * vt[..., None, :]
    o = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return o, S


def _check(r, k, v, logw, u, s0):
    if r.dim() != 4:
        raise ValueError(f"r must be [B, T, H, n]; got {tuple(r.shape)}")
    B, T, H, n = r.shape
    named = {"k": k, "v": v, "logw": logw, "u": u}
    if s0 is not None:
        named["s0"] = s0
    want = {"k": r.shape, "v": r.shape, "logw": r.shape, "u": (H, n),
            "s0": (B, H, n, n)}
    for name, t in named.items():
        if tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"{name} must have shape {tuple(want[name])}; "
                             f"got {tuple(t.shape)}")
    for name, t in {"r": r, **named}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")


def wkv(r, k, v, logw, u, s0=None, return_state: bool = False):
    """WKV6 over [B, T, H, n] fp32 inputs with bonus u [H, n] and an
    optional initial state s0 [B, H, n, n]. Returns o [B, T, H, n], and
    with `return_state` also the final state [B, H, n, n]. CUDA tensors
    launch the kernel (n in HEAD_SIZES), which counts its launches in
    `wkv.launches`. Forward only: raises when grad is enabled and an input
    requires grad."""
    _check(r, k, v, logw, u, s0)
    forward_only("wkv", r, k, v, logw, u, s0)
    if r.device.type == "cpu":
        o, s = wkv_plain(r, k, v, logw, u, s0)
    elif r.device.type == "cuda":
        o, s = _launch(r, k, v, logw, u, s0)
    else:
        raise ValueError(f"no WKV route for {r.device}")
    return (o, s) if return_state else o


wkv.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and 16-byte aligned, as cp.async reads it: itself
    where it is, else a copy."""
    if t.is_contiguous() and not t.data_ptr() & 15:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(r, k, v, logw, u, s0):
    """The kernel on CUDA tensors."""
    B, T, H, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"the WKV6 kernel takes head sizes {HEAD_SIZES}; "
                         f"got {n}")
    r, k, v, logw, u = (_aligned(a) for a in (r, k, v, logw, u))
    s0 = None if s0 is None else _aligned(s0)
    o = torch.empty_like(r)
    s_out = torch.empty((B, H, n, n), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return o, s_out
    w = torch.empty_like(logw)  # exp(logw), the kernel's first pass
    fn = build.entry("wkv6", "wkv6_fwd", _ARGTYPES)
    err = build.call(fn, r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                     logw.data_ptr(), u.data_ptr(),
                     None if s0 is None else s0.data_ptr(), o.data_ptr(),
                     s_out.data_ptr(), w.data_ptr(), B, T, H, n)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv.launches += 1
    return o, s_out
