"""CKA Gram terms: the hand-written CUDA kernels (`csrc/cka_terms.cu`)
and, beside them, their plain PyTorch version.

Port of `repro.kernels.cka` (the `ops.cka_terms`/`ops.cka` wrappers, the
Pallas kernel in `kernel.py` and the oracle in `ref.py`). The cast to
fp32 stays here in torch, and so does the centering that sits outside the
`pallas_call` in JAX, except where the example form's kernel centers the
columns itself. The kernels mask ragged edges themselves, so nothing is
padded.

`cka_terms` chooses by device: a CPU tensor goes to `cka_terms_plain`, a
CUDA tensor launches a kernel or raises. On the card it takes the form
with less work (`feature_route`): the feature form, the upper triangle of
G = Z^T Z with Z = [X | Y] in 3xTF32 tensor-core products, when
dx + dy <= n (every ViT/BERT probe); else the example form (n << d, as
for flattened CNN maps). The example form replaces one block per 64 x 64
tile pair walking all of d in fp32 FMAs, which at a CNN probe (n = 16)
ran one block on the whole card. Bytes bound it there (16.8 MB of input
at n = 16, d = 131072 against 134 MFLOP), so `example_plan` splits the
features over ~2 blocks an SM, each a pair of 16-row tiles whose lanes
read 16-byte vectors straight into 3xTF32 `mma.sync` fragments; a fold
pass sums the splits' partial K and L tiles in double in a fixed order.
Where the plan has one row tile (n <= 16, every CNN probe) the kernel
takes the raw rows and centers each column before its products, so the
torch centering passes (~4x the input's bytes again) are skipped.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build, forward_only

TILE = 64  # Gram tile side of the feature route (csrc/cka_terms.cu)
# the feature route stages 32 rows a step, so a split is a multiple of 32
# rows; its split-K aims at about 512 blocks
SPLIT_ROWS = 32
TARGET_BLOCKS = 512
FOLD_PARTS = 8  # blocks per tile of the feature route's fold pass
# the example route: 16-row tiles (one m16n8k8 product's rows); a warp
# reads 32 features of its rows a step, 8 warps a block, so a split is a
# whole number of steps and at least one step a warp; the splits aim at
# 2 blocks an SM of the H100's 132; its fold pass takes 8 blocks a pair
EXAMPLE_ROWS = 16
EXAMPLE_STEP = 32
EXAMPLE_WARPS = 8
EXAMPLE_MIN_WIDTH = EXAMPLE_STEP * EXAMPLE_WARPS
EXAMPLE_TARGET_BLOCKS = 264
EXAMPLE_FOLD_PARTS = 8

_EXAMPLE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p] * 4)
_FEATURE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p] * 4)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as fp32 rows [n, d]: [..., d] flattened to rows."""
    x = x.reshape(-1, x.shape[-1]) if x.dim() != 2 else x
    return x.float()


def _prepare(x: torch.Tensor) -> torch.Tensor:
    x = _rows(x)
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


def _tile_pair(p: int, tiles: int):
    """Tile pair (i, j), i <= j, of block p: row-major over the upper
    triangle of tiles x tiles, as the kernels' `tile_pair` decodes it."""
    i = 0
    while p >= tiles - i:
        p -= tiles - i
        i += 1
    return i, i + p


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
        return _tile_pair(p, self.tiles)

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


@dataclasses.dataclass(frozen=True)
class ExamplePlan:
    """The example route's grid for X [n, dx], Y [n, dy]: `tiles` 16-row
    tiles of the examples, one block per upper-triangle tile pair and
    feature split, `splits` ranges of `width` features of X and of Y (the
    last one ragged). It depends on the shape only, never on the card."""
    n: int
    dx: int
    dy: int
    tiles: int
    splits: int
    width: int

    @property
    def pairs(self) -> int:
        return self.tiles * (self.tiles + 1) // 2

    @property
    def blocks(self) -> int:
        return self.pairs * self.splits

    @property
    def center(self) -> bool:
        """One row tile, so a block holds every row of its features: the
        kernel centers the columns itself."""
        return self.tiles == 1

    def pair(self, p: int):
        return _tile_pair(p, self.tiles)

    def feature_range(self, s: int, d: int):
        """Features [lo, hi) of split s in a matrix of d columns."""
        return min(d, s * self.width), min(d, (s + 1) * self.width)


@functools.lru_cache(maxsize=None)
def example_plan(n: int, dx: int, dy: int) -> ExamplePlan:
    """Enough feature splits that pairs x splits comes near
    EXAMPLE_TARGET_BLOCKS, each a whole number of EXAMPLE_STEP-feature
    steps and at least one step a warp. At a CNN probe (n = 16, one pair):
    256 splits of 512 features at d = 131072, 10 of 256 at d = 2560."""
    tiles = -(-n // EXAMPLE_ROWS)
    pairs = tiles * (tiles + 1) // 2
    d = max(dx, dy)
    want = -(-EXAMPLE_TARGET_BLOCKS // pairs)
    width = max(EXAMPLE_MIN_WIDTH, -(-d // want))
    width = -(-width // EXAMPLE_STEP) * EXAMPLE_STEP
    return ExamplePlan(n, dx, dy, tiles, -(-d // width), width)


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
    x, y = _rows(x), _rows(y)
    if x.shape[0] != y.shape[0] or x.numel() == 0 or y.numel() == 0:
        raise ValueError(f"x and y need the same non-zero number of rows; "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.device.type == "cpu":
        hsic, kk, ll = cka_terms_plain(_prepare(x), _prepare(y))
    elif x.device.type == "cuda":
        if feature_route(x.shape[0], x.shape[1], y.shape[1]):
            hsic, kk, ll = _launch_feature(_prepare(x), _prepare(y))
        else:  # centers where the kernel does not
            hsic, kk, ll = _launch_example(x.contiguous(), y.contiguous())
    else:
        raise ValueError(f"no CKA route for {x.device}")
    return hsic, torch.sqrt(kk), torch.sqrt(ll)


cka_terms.launches = 0
cka_terms.route_launches = {"feature": 0, "example": 0}


def cka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    hsic, nx, ny = cka_terms(x, y)
    return hsic / torch.clamp(nx * ny, min=1e-12)


def _counted(route: str, err: int, out: torch.Tensor):
    if err:
        raise RuntimeError(f"cka_terms {route}-form kernel launch failed: "
                           f"CUDA error {err}")
    cka_terms.launches += 1
    cka_terms.route_launches[route] += 1
    return out[0], out[1], out[2]


def _launch_example(x, y):
    """The example-form kernels on contiguous fp32 x [n, dx] and y [n, dy],
    raw or centered: the kernel centers the columns of a one-tile plan,
    and x and y are centered here first otherwise."""
    plan = example_plan(x.shape[0], x.shape[1], y.shape[1])
    if not plan.center:
        x, y = _prepare(x), _prepare(y)
    fn = build.entry("cka_terms", "cka_terms_example_fwd", _EXAMPLE_ARGTYPES)
    gram = torch.empty(plan.blocks * 2 * EXAMPLE_ROWS ** 2,
                       dtype=torch.float32, device=x.device)
    partials = torch.empty(3 * plan.pairs * EXAMPLE_FOLD_PARTS,
                           dtype=torch.float64, device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    err = build.call(fn, x.device, x.data_ptr(), y.data_ptr(), plan.n,
                     plan.dx, plan.dy, plan.tiles, plan.splits, plan.width,
                     int(plan.center), gram.data_ptr(), partials.data_ptr(),
                     out.data_ptr())
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
