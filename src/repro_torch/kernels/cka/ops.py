"""CKA Gram terms: the hand-written CUDA kernels (`csrc/cka_terms.cu`)
and, beside them, their plain PyTorch version.

Port of `repro.kernels.cka` (the `ops.cka_terms`/`ops.cka` wrappers, the
Pallas kernel in `kernel.py` and the oracle in `ref.py`). Centering and
the cast to fp32 stay here in torch, outside the kernel, as they sit
outside the `pallas_call` in JAX. The kernels mask ragged edges
themselves, so nothing is padded.

`cka_terms` chooses by device: a CPU tensor goes to `cka_terms_plain`, a
CUDA tensor launches a kernel or raises. On the card it takes the form
with less work (`feature_route`): the feature form, the upper triangle of
G = Z^T Z with Z = [X | Y] in 3xTF32 tensor-core products, when
dx + dy <= n (every ViT/BERT probe); else the example form, tiles of the
two n x n Grams in fp32 FMAs (n << d, as for flattened CNN maps).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build, forward_only

TILE = 64  # Gram tile side of both routes (csrc/cka_terms.cu)
# the feature route stages 32 rows a step, so a split is a multiple of 32
# rows; its split-K aims at about 512 blocks
SPLIT_ROWS = 32
TARGET_BLOCKS = 512
FOLD_PARTS = 8  # blocks per tile of the feature route's fold pass

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_FEATURE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p] * 4)


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


def feature_route(n: int, dx: int, dy: int) -> bool:
    """True where the feature form does no more work than the example
    form: n * D(D+1) <= n(n+1) * D with D = dx + dy, that is D <= n."""
    return dx + dy <= n


@dataclasses.dataclass(frozen=True)
class FeaturePlan:
    """The feature route's grid for X [n, dx], Y [n, dy]: `tiles` 64-wide
    column tiles of Z = [X | Y], one block per upper-triangle tile pair
    and row split, `splits` splits of `rows` rows (the last one ragged).
    It depends on the shape only, never on the card."""
    n: int
    dx: int
    dy: int
    tiles: int
    splits: int
    rows: int

    @property
    def pairs(self) -> int:
        return self.tiles * (self.tiles + 1) // 2

    def pair(self, p: int):
        """Tile pair (i, j), i <= j, of block p: row-major over the upper
        triangle, as the kernel's `tile_pair` decodes blockIdx.x."""
        i = 0
        while p >= self.tiles - i:
            p -= self.tiles - i
            i += 1
        return i, i + p

    def row_range(self, s: int):
        return s * self.rows, min(self.n, (s + 1) * self.rows)


@functools.lru_cache(maxsize=None)
def feature_plan(n: int, dx: int, dy: int) -> FeaturePlan:
    """Enough row splits that pairs x splits comes near TARGET_BLOCKS,
    each a whole number of SPLIT_ROWS-row steps. At the DeiT-tiny probe
    (3152, 192, 192): 21 pairs x 25 splits of 128 rows (80 in the last)."""
    tiles = -(-(dx + dy) // TILE)
    pairs = tiles * (tiles + 1) // 2
    want = max(1, -(-TARGET_BLOCKS // pairs))
    rows = -(-n // want)
    rows = -(-rows // SPLIT_ROWS) * SPLIT_ROWS
    return FeaturePlan(n, dx, dy, tiles, -(-n // rows), rows)


def cka_terms(x: torch.Tensor, y: torch.Tensor):
    """Returns (hsic, sqrt(kk), sqrt(ll)) of the column-centered x, y
    ([n, dx] and [n, dy], or [..., d] flattened to rows), as 0-d fp32
    tensors. CUDA tensors launch a kernel, which counts its launches in
    `cka_terms.launches` and, by route, in `cka_terms.route_launches`.
    Forward only: raises when grad is enabled and an input requires grad."""
    if not (x.is_floating_point() and y.is_floating_point()):
        raise TypeError("x and y must be floating point")
    if x.device != y.device:
        raise ValueError("x and y must be on one device")
    forward_only("cka_terms", x, y)
    xc, yc = _prepare(x), _prepare(y)
    if xc.shape[0] != yc.shape[0] or xc.numel() == 0 or yc.numel() == 0:
        raise ValueError(f"x and y need the same non-zero number of rows; "
                         f"got {tuple(xc.shape)} and {tuple(yc.shape)}")
    if xc.device.type == "cpu":
        hsic, kk, ll = cka_terms_plain(xc, yc)
    elif xc.device.type == "cuda":
        n, dx = xc.shape
        launch = _launch_feature if feature_route(n, dx, yc.shape[1]) \
            else _launch_example
        hsic, kk, ll = launch(xc.contiguous(), yc.contiguous())
    else:
        raise ValueError(f"no CKA route for {xc.device}")
    return hsic, torch.sqrt(kk), torch.sqrt(ll)


cka_terms.launches = 0
cka_terms.route_launches = {"feature": 0, "example": 0}


def cka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    hsic, nx, ny = cka_terms(x, y)
    return hsic / torch.clamp(nx * ny, min=1e-12)


def num_tile_pairs(n: int) -> int:
    """Blocks of one example-form launch: the upper triangle of
    ceil(n/64)^2 tiles."""
    t = -(-n // TILE)
    return t * (t + 1) // 2


def _counted(route: str, err: int, out: torch.Tensor):
    if err:
        raise RuntimeError(f"cka_terms {route}-form kernel launch failed: "
                           f"CUDA error {err}")
    cka_terms.launches += 1
    cka_terms.route_launches[route] += 1
    return out[0], out[1], out[2]


def _launch_example(x, y):
    """The example-form kernel on centered, contiguous fp32 x and y."""
    n, dx = x.shape
    dy = y.shape[1]
    fn = build.entry("cka_terms", "cka_terms_fwd", _ARGTYPES)
    partials = torch.empty(3 * num_tile_pairs(n), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    err = build.call(fn, x.device, x.data_ptr(), y.data_ptr(), n, dx, dy,
                     partials.data_ptr(), out.data_ptr())
    return _counted("example", err, out)


def _launch_feature(x, y):
    """The feature-form kernels on centered, contiguous fp32 x and y."""
    plan = feature_plan(x.shape[0], x.shape[1], y.shape[1])
    fn = build.entry("cka_terms", "cka_terms_feature_fwd", _FEATURE_ARGTYPES)
    gram = torch.empty(plan.splits * plan.pairs * TILE * TILE,
                       dtype=torch.float32, device=x.device)
    partials = torch.empty(3 * plan.pairs * FOLD_PARTS, dtype=torch.float32,
                           device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    err = build.call(fn, x.device, x.data_ptr(), y.data_ptr(), plan.n,
                     plan.dx, plan.dy, plan.tiles, plan.splits, plan.rows,
                     gram.data_ptr(), partials.data_ptr(), out.data_ptr())
    return _counted("feature", err, out)
