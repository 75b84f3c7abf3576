"""Mamba-1 selective SSM block (jamba's hybrid stack), ported from
`repro.models.mamba`.

The prefill/train path evaluates the diagonal recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t ,   y_t = h_t C_t + D x_t
as the reference does: the sequence is split into `nc = S // ssm_chunk`
chunks of `Lc = S // nc` tokens, the state carried from chunk to chunk,
and inside a chunk an associative scan over the combine
``(a1, b1), (a2, b2) -> (a1 + a2, exp(a2) b1 + b2)``. The port runs that
scan as a log-depth (Hillis-Steele) scan over the chunk's tokens,
ceil(log2 Lc) steps, where JAX's `associative_scan` sums in another tree
order: the two agree to rounding, not to the bit. Like the reference, a
length that the chunks do not split raises at the reshape (S = 37 at
chunk 16: 2 chunks of 18; ROADMAP C.11), and a prefill shorter than
`mamba_conv - 1` tokens leaves a conv state that a decode cannot use
(ROADMAP C.12). Decode is the exact single-step update, its state fp32.

Cast points follow the reference: `in_proj` and `x_proj` in the params'
dtype with the projection cast to fp32; `dt_proj`, `dt_bias`, `A_log`
and `D_skip` fp32; the scan in `cfg.ssm_dtype`; `y` cast to the
activation dtype before ``* silu(z)``.

In a sharded step the spec splits the inner channels over `model`: a
rank runs the conv, the scan and `D_skip` on its di / tp channels,
`x_proj` and `out_proj` are row-parallel (their parts summed over
`model`), `dt_proj` column-parallel. `in_proj`'s columns are split over
`model` across its x and z halves, so its output is gathered and each
rank takes its channels of both.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.models import common


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba_expand * cfg.d_model


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) at every x (`F.softplus` turns
    linear above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    d, di, N, R = cfg.d_model, d_inner(cfg), cfg.mamba_state, dt_rank(cfg)
    f32, dev = torch.float32, gen.device
    # S4D-real initialization for A
    a = torch.arange(1, N + 1, dtype=f32, device=dev).expand(di, N)
    return {
        "in_proj": common.dense_init(gen, d, (d, 2 * di), dt),
        "conv_w": common.normal_init(gen, (cfg.mamba_conv, di), 0.1, dt),
        "conv_b": torch.zeros(di, dtype=dt, device=dev),
        "x_proj": common.dense_init(gen, di, (di, R + 2 * N), dt),
        "dt_proj": common.normal_init(gen, (R, di), R ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01, dtype=f32,
                                                    device=dev))),
        "A_log": torch.log(a),
        "D_skip": torch.ones(di, dtype=f32, device=dev),
        "out_proj": common.dense_init(gen, di, (di, d), dt),
    }


def _causal_conv(p: dict, x: torch.Tensor, width: int) -> torch.Tensor:
    """Depthwise causal conv over the sequence by stacked shifts, in x's
    dtype. x: [B, S, di]."""
    S = x.shape[1]
    out = torch.zeros_like(x)
    for w in range(width):
        shift = width - 1 - w
        xs = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xs * p["conv_w"][w]
    return out + p["conv_b"]


def _in_proj(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x [B, S, D] -> (x1, z), this rank's channels of each half of
    `in_proj`'s output."""
    di = d_inner(cfg)
    w = p["in_proj"]
    split_in = spmd.split(w, 1, 2 * di)
    xz = spmd.matmul(spmd.to_model(x) if split_in else x, w)
    if split_in:
        xz = spmd.gather_model(xz, -1)
    xz = shd.hint(xz, shd.BATCH_AXES, None, "model")
    x1, z = xz.chunk(2, dim=-1)
    if spmd.split(p["conv_w"], 1, di):
        x1, z = spmd.to_model(x1), spmd.to_model(z)
        lo, hi = spmd.part(di)
        x1, z = x1[..., lo:hi], z[..., lo:hi]
    return x1, z


def _out(p: dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
    return spmd.matmul(y, p["out_proj"], cfg.d_model,
                       spmd.split(p["out_proj"], 0, d_inner(cfg)))


def _ssm_inputs(p: dict, cfg: ModelConfig, xc: torch.Tensor):
    """xc: [B, S, di] (after the conv and silu). Returns the log decay
    [B, S, di, N] (<= 0), the drive [B, S, di, N] and C [B, S, N], fp32."""
    R, N = dt_rank(cfg), cfg.mamba_state
    proj = xc @ p["x_proj"]
    if spmd.split(p["x_proj"], 0, d_inner(cfg)):
        proj = spmd.to_model(spmd.from_model(proj))
    proj = proj.float()
    dt_in, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt = _softplus(dt_in @ p["dt_proj"] + p["dt_bias"])  # [B, S, di]
    A = -torch.exp(p["A_log"])                           # [di, N]
    log_decay = dt[..., None] * A
    drive = (dt * xc.float())[..., None] * Bc[:, :, None, :]
    return log_decay, drive, Cc


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the combine (a1 + a2, exp(a2) b1 +
    b2), log-depth: at step d each token takes the aggregate of the d
    tokens before it. Returns (a_cum, b_cum), new tensors; out of place,
    so autograd can differentiate it."""
    d, L = 1, a.shape[1]
    while d < L:
        b = torch.cat([b[:, :d], torch.exp(a[:, d:]) * b[:, :-d] + b[:, d:]],
                      dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] + a[:, d:]], dim=1)
        d *= 2
    return a, b


def mamba_train(p: dict, cfg: ModelConfig, x: torch.Tensor, chunk: int = 0,
                return_state: bool = False):
    """x: [B, S, D] -> ([B, S, D], state | None); the state (fp32 ``h``
    [B, di, N], ``conv`` [B, w - 1, di]) for a prefill."""
    B, S, _ = x.shape
    chunk = chunk or cfg.ssm_chunk
    N = cfg.mamba_state
    x1, z = _in_proj(p, cfg, x)
    di = x1.shape[-1]
    xc = F.silu(_causal_conv(p, x1, cfg.mamba_conv))
    log_decay, drive, Cc = _ssm_inputs(p, cfg, xc)

    sdt = common._DTYPES[cfg.ssm_dtype]
    nc = max(1, S // chunk)
    Lc = S // nc
    ld = log_decay.to(sdt).reshape(B, nc, Lc, di, N)
    dr = drive.to(sdt).reshape(B, nc, Lc, di, N)
    cc = Cc.to(sdt).reshape(B, nc, Lc, N)
    h = torch.zeros((B, di, N), dtype=sdt, device=x.device)
    ys = []
    for ci in range(nc):
        a_cum, b_cum = _scan(ld[:, ci], dr[:, ci])
        h_t = torch.exp(a_cum) * h[:, None] + b_cum      # [B, Lc, di, N]
        ys.append(torch.einsum("bldn,bln->bld", h_t, cc[:, ci]))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1).float()
    y = y + p["D_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = _out(p, cfg, y)
    state = None
    if return_state:
        w = cfg.mamba_conv
        conv_tail = x1[:, S - (w - 1):].float() if w > 1 else \
            torch.zeros((B, 0, di), dtype=torch.float32, device=x.device)
        state = {"h": h, "conv": conv_tail}
    return out, state


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    device = resolve_device(device)
    di, N = d_inner(cfg), cfg.mamba_state
    z = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, di, N), **z),
            "conv": torch.zeros((batch, cfg.mamba_conv - 1, di), **z)}


def mamba_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, D]; the exact recurrent step."""
    x1, z = (t[:, 0] for t in _in_proj(p, cfg, x))     # [B, di]
    conv_buf = torch.cat([state["conv"], x1[:, None].float()], dim=1)
    xc = torch.einsum("bwd,wd->bd", conv_buf, p["conv_w"].float())
    xc = F.silu(xc + p["conv_b"].float())
    log_decay, drive, Cc = _ssm_inputs(p, cfg, xc[:, None].to(x.dtype))
    h = torch.exp(log_decay[:, 0]) * state["h"] + drive[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])
    y = y + p["D_skip"] * xc
    y = (y.to(x.dtype) * F.silu(z))[:, None]
    return _out(p, cfg, y), {"h": h, "conv": conv_buf[:, 1:]}
