"""CKA Gram terms: the hand-written CUDA kernel (`csrc/cka_terms.cu`)
and, beside it, its plain PyTorch version.

Port of `repro.kernels.cka` (the `ops.cka_terms`/`ops.cka` wrappers, the
Pallas kernel in `kernel.py` and the oracle in `ref.py`). Centering and
the cast to fp32 stay here in torch, outside the kernel, as they sit
outside the `pallas_call` in JAX. The kernel masks ragged edges itself,
so nothing is padded.

`cka_terms` chooses by device: a CPU tensor goes to `cka_terms_plain`, a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE = 64  # Gram tile side in the kernel (csrc/cka_terms.cu)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _prepare(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1, x.shape[-1]) if x.dim() != 2 else x
    x = x.float()
    return x - x.mean(dim=0, keepdim=True)


def cka_terms_plain(x: torch.Tensor, y: torch.Tensor):
    """(hsic, kk, ll) from the two example-form Grams, as
    `repro.kernels.cka.ref.cka_terms_ref` computes them."""
    x, y = x.float(), y.float()
    k = x @ x.T
    l = y @ y.T
    return (k * l).sum(), (k * k).sum(), (l * l).sum()


def cka_terms(x: torch.Tensor, y: torch.Tensor):
    """Returns (hsic, sqrt(kk), sqrt(ll)) of the column-centered x, y
    ([n, dx] and [n, dy], or [..., d] flattened to rows), as 0-d fp32
    tensors. CUDA tensors launch the kernel, which counts its launches in
    `cka_terms.launches`."""
    if not (x.is_floating_point() and y.is_floating_point()):
        raise TypeError("x and y must be floating point")
    if x.device != y.device:
        raise ValueError("x and y must be on one device")
    xc, yc = _prepare(x), _prepare(y)
    if xc.shape[0] != yc.shape[0] or xc.numel() == 0 or yc.numel() == 0:
        raise ValueError(f"x and y need the same non-zero number of rows; "
                         f"got {tuple(xc.shape)} and {tuple(yc.shape)}")
    if xc.device.type == "cpu":
        hsic, kk, ll = cka_terms_plain(xc, yc)
    elif xc.device.type == "cuda":
        hsic, kk, ll = _launch(xc.contiguous(), yc.contiguous())
    else:
        raise ValueError(f"no CKA route for {xc.device}")
    return hsic, torch.sqrt(kk), torch.sqrt(ll)


cka_terms.launches = 0


def cka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    hsic, nx, ny = cka_terms(x, y)
    return hsic / torch.clamp(nx * ny, min=1e-12)


def num_tile_pairs(n: int) -> int:
    """Blocks of one launch: the upper triangle of ceil(n/64)^2 tiles."""
    t = -(-n // TILE)
    return t * (t + 1) // 2


def _launch(x, y):
    n, dx = x.shape
    dy = y.shape[1]
    fn = build.load("cka_terms").cka_terms_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    partials = torch.empty(3 * num_tile_pairs(n), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), n, dx, dy, partials.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"cka_terms kernel launch failed: CUDA error {err}")
    cka_terms.launches += 1
    return out[0], out[1], out[2]
