"""RWKV6 ("Finch") block: time-mix with data-dependent per-channel decay
and channel-mix FFN, ported from `repro.models.rwkv6`. [arXiv:2404.05892]

The prefill/train path evaluates the WKV recurrence
    S_t = diag(w_t) S_{t-1} + k_t v_t^T ,   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
in one of two ways. Under `cfg.use_pallas`, where no backward runs through
it (`kernels.kernel_route`: serving, probes, a train step's frozen prefix
behind a frozen embedding), it launches the hand-written WKV6 kernel
(`kernels/rwkv/ops.wkv`), the exact recurrence; this is the one
deliberate routing difference from the JAX model, which always takes the
chunked closed form. Otherwise it takes `wkv_chunked`, that closed form
ported as it is: log-decay products clamped at CUM_CLAMP inside a chunk
(wrong once a chunk is long enough for the clamp to bite, about 45 tokens
at the model's init decay) and a reshape that needs S to be a multiple of
the chunk count (ROADMAP C.4). Decode is the exact single-step recurrence.

Cast points follow JAX exactly, since in bf16 they decide the rounding:
r, k, v and logw go to fp32 before the recurrence, `o` is cast to the
activation dtype before the group norm, and the norm computes in fp32.

In a sharded step the projections are split over `model` as the spec
places them (r, k, v, g and the decay's `wB` by output channel, `wo` by
input channel; the channel mix's `wk` by its hidden dim, `wv` and `wr` by
output channel). Where the heads divide `model` (`u` split), a rank's
channels are its heads and the recurrence runs on them; where they do
not (rwkv6-3b's 40 heads over 16), r, k, v, g and the decay are gathered
and the recurrence runs whole on every rank, as the reference
replicates it. Where a step's rows are not split (a decode of one row)
the products keep their weights where FSDP left them (`spmd.matmul`):
the time mix's `wr`, `wk`, `wv`, `wg` and the decay's `wA`, and the
channel mix's `wk` and `wv`, split over the data axes by the dim they
contract, take the rank's part of their input and sum the partial
products over the data axes; the time mix's `wo`, split by its output
channels, gathers its columns over them after the sum over `model`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import spmd
from repro_torch.kernels import kernel_route
from repro_torch.kernels.rwkv import ops as wkv_ops
from repro_torch.models import common

DECAY_LORA = 32
CUM_CLAMP = 18.0  # |log-decay| clamp inside a chunk (fp32 safety)


def num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_size


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    d = cfg.d_model
    H, n = num_heads(cfg), cfg.rwkv_head_size
    lora = min(DECAY_LORA, d)
    f32, dev = torch.float32, gen.device
    return {
        # token-shift mix coefficients for r, k, v, g, w
        "mu": common.normal_init(gen, (5, d), 0.02) + 0.5,
        "wr": common.dense_init(gen, d, (d, d), dt),
        "wk": common.dense_init(gen, d, (d, d), dt),
        "wv": common.dense_init(gen, d, (d, d), dt),
        "wg": common.dense_init(gen, d, (d, d), dt),
        "wo": common.dense_init(gen, d, (d, d), dt),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((d,), -1.0, dtype=f32, device=dev),
        "wA": common.dense_init(gen, d, (d, lora)),
        "wB": common.normal_init(gen, (lora, d), 0.01),
        "u": common.normal_init(gen, (H, n), 0.3),
        # per-head group norm on the wkv output
        "ln_x_scale": torch.ones(d, dtype=f32, device=dev),
        "ln_x_bias": torch.zeros(d, dtype=f32, device=dev),
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = common.dtype_of(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu": common.normal_init(gen, (2, d), 0.02) + 0.5,
        "wk": common.dense_init(gen, d, (d, ff), dt),
        "wv": common.dense_init(gen, ff, (ff, d), dt),
        "wr": common.dense_init(gen, d, (d, d), dt),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> the previous token's features (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _lerp(x, xp, mu):
    return x + (xp - x) * mu.to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each step rounded to x's dtype, as
    `jax.nn.sigmoid` lowers (torch.sigmoid rounds once, which in bf16
    differs by an ulp in about a third of the entries)."""
    return 1 / (1 + torch.exp(-x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid(x)


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """log w (negative) per channel: [B, S, D] fp32 (this rank's channels
    where `wB` is split over `model`)."""
    t = torch.tanh(spmd.matmul(xw.float(), p["wA"]))
    if spmd.split(p["wB"], 1, xw.shape[-1]):
        lo, hi = spmd.part(xw.shape[-1])
        lw = spmd.to_model(p["w0"])[lo:hi] + spmd.to_model(t) @ p["wB"]
    else:
        lw = p["w0"] + t @ p["wB"]
    return -torch.exp(lw)


def _group_norm(x: torch.Tensor, scale, bias, H: int, eps=1e-5) -> torch.Tensor:
    """Per-head normalization of [B, S, D] with D = H*n, in fp32."""
    B, S, D = x.shape
    xh = x.reshape(B, S, H, D // H).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, unbiased=False, keepdim=True)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, D) * scale + bias).to(x.dtype)


def _rkvgw(p: dict, cfg: ModelConfig, x: torch.Tensor, xp: torch.Tensor):
    """r, k, v, logw [B, S, H, n] (fp32) and g [B, S, D]: this rank's
    heads where `u` is split over `model`, else every head."""
    n = cfg.rwkv_head_size
    B, S, D = x.shape
    split = spmd.split(p["wr"], 1, D)
    xs = [_lerp(x, xp, p["mu"][i]) for i in range(4)]
    if split:
        xs = [spmd.to_model(a) for a in xs]
    r = spmd.matmul(xs[0], p["wr"])
    k = spmd.matmul(xs[1], p["wk"])
    v = spmd.matmul(xs[2], p["wv"])
    g = _silu(spmd.matmul(xs[3], p["wg"]))
    logw = _decay(p, _lerp(x, xp, p["mu"][4]))
    if split and not spmd.split(p["u"], 0, num_heads(cfg)):
        r, k, v, g, logw = (spmd.gather_model(a, -1)
                            for a in (r, k, v, g, logw))
    shape = (B, S, -1, n)
    r, k, v = (shd.hint(a.reshape(shape).float(), shd.BATCH_AXES, None,
                        "model", None) for a in (r, k, v))
    return r, k, v, g, logw.reshape(shape)


def _time_mix_out(p: dict, cfg: ModelConfig, o: torch.Tensor,
                  g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The group norm of the recurrence's output o [B, S, H, n] (its
    heads), the gate and `wo`: row-parallel, its parts summed over
    `model`, where `wo` is split (a rank whose o is whole takes its own
    channels)."""
    B, S, H, n = o.shape
    D = x.shape[-1]
    scale, bias = p["ln_x_scale"], p["ln_x_bias"]
    if H * n != D:
        lo, hi = spmd.part(D)
        scale = spmd.to_model(scale)[lo:hi]
        bias = spmd.to_model(bias)[lo:hi]
    o = _group_norm(o.reshape(B, S, H * n).to(x.dtype), scale, bias, H)
    og = o * g
    if not spmd.split(p["wo"], 0, D):
        return spmd.matmul(og, p["wo"], D)
    if H * n == D:
        lo, hi = spmd.part(D)
        og = spmd.to_model(og)[..., lo:hi]
    return spmd.matmul(og, p["wo"], D, model_sum=True)


def wkv_chunked(r, k, v, logw, u, chunk: int = 64):
    """Chunked WKV6 closed form, as the JAX model computes it (clamp and
    reshape included). r, k, v, logw: [B, S, H, n] fp32; u: [H, n].
    Returns (o [B, S, H, n], s_final [B, H, n, n])."""
    B, S, H, n = r.shape
    nc = max(1, S // chunk)
    Lc = S // nc
    rs, ks_, vs, lws = (a.reshape(B, nc, Lc, H, n) for a in (r, k, v, logw))
    S_prev = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.float32,
                                   device=r.device), diagonal=-1)
    outs = []
    for ci in range(nc):
        rc, kc, vc, lwc = rs[:, ci], ks_[:, ci], vs[:, ci], lws[:, ci]
        cum = torch.cumsum(lwc, dim=1)                    # inclusive [B,Lc,H,n]
        cum_ex = cum - lwc                                # exclusive
        cl = torch.clamp(cum_ex, -CUM_CLAMP, 0.0)
        r_hat = rc * torch.exp(cl)                        # decayed queries
        k_hat = kc * torch.exp(torch.clamp(-cum, 0.0, CUM_CLAMP))
        scores = torch.einsum("blhn,bmhn->bhlm", r_hat, k_hat) * causal
        diag = torch.einsum("blhn,blhn->bhl", rc * u, kc)
        o = torch.einsum("bhlm,bmhn->blhn", scores, vc)
        o = o + diag[..., None].permute(0, 2, 1, 3) * vc
        # inter-chunk contribution from the carried state
        o = o + torch.einsum("blhn,bhnm->blhm", r_hat, S_prev)
        # state update to the end of the chunk
        total = cum[:, -1]                                # [B,H,n]
        k_dec = kc * torch.exp(torch.clamp(total[:, None] - cum, -CUM_CLAMP,
                                           0.0))
        S_prev = torch.exp(torch.clamp(total, -CUM_CLAMP, 0.0))[..., None] \
            * S_prev + torch.einsum("blhn,blhm->bhnm", k_dec, vc)
        outs.append(o)
    return torch.stack(outs, dim=1).reshape(B, S, H, n), S_prev


def time_mix_train(p: dict, cfg: ModelConfig, x: torch.Tensor, chunk: int = 0,
                   return_state: bool = False):
    B, S, D = x.shape
    chunk = chunk or min(cfg.ssm_chunk, max(S, 1))
    xp = _token_shift(x)
    r, k, v, g, logw = _rkvgw(p, cfg, x, xp)
    if kernel_route(cfg.use_pallas, r, k, v, logw, p["u"]):
        o, s_fin = wkv_ops.wkv(r, k, v, logw, p["u"], return_state=True)
    else:
        o, s_fin = wkv_chunked(r, k, v, logw, p["u"], chunk=chunk)
    out = _time_mix_out(p, cfg, o, g, x)
    state = None
    if return_state:
        state = {"s": s_fin, "x_tm": x[:, -1].float()}
    return out, state


def _channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 xp: torch.Tensor) -> torch.Tensor:
    """sigmoid(rx Wr) * (relu(kx Wk)^2 Wv). In a sharded step `wk` is
    split over `model` by the hidden dim and `wv`, `wr` by output
    channel (both by d_model, so together): the hidden activations are
    gathered for `wv`, and the product's channels after it."""
    kx = _lerp(x, xp, p["mu"][0])
    rx = _lerp(x, xp, p["mu"][1])
    split_k = spmd.split(p["wk"], 1, cfg.d_ff)
    split_d = spmd.split(p["wv"], 1, x.shape[-1])
    k = torch.square(F.relu(spmd.matmul(spmd.to_model(kx) if split_k
                                        else kx, p["wk"])))
    if split_k:
        k = spmd.gather_model(k, -1)
    if split_d:
        k, rx = spmd.to_model(k), spmd.to_model(rx)
    out = _sigmoid(rx @ p["wr"]) * spmd.matmul(k, p["wv"])
    return spmd.gather_model(out, -1) if split_d else out


def channel_mix_train(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: dict = None, return_state: bool = False):
    out = _channel_mix(p, cfg, x, _token_shift(x))
    new_state = None
    if return_state:
        new_state = dict(state or {})
        new_state["x_cm"] = x[:, -1].float()
    return out, new_state


# ---------------------------------------------------------------------------
# decode (exact recurrence)


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """A zero decode state, on `device` (CUDA unless given: the port's
    entry-point rule, `resolve_device`)."""
    H, n = num_heads(cfg), cfg.rwkv_head_size
    z = dict(dtype=torch.float32, device=resolve_device(device))
    return {
        "s": torch.zeros((batch, H, n, n), **z),
        "x_tm": torch.zeros((batch, cfg.d_model), **z),
        "x_cm": torch.zeros((batch, cfg.d_model), **z),
    }


def time_mix_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: dict) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, D]."""
    xp = state["x_tm"].to(x.dtype)[:, None]
    r, k, v, g, logw = _rkvgw(p, cfg, x, xp)
    r1, k1, v1, lw1 = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]   # [B,H,n]
    S_prev = state["s"]
    o = torch.einsum("bhn,bhnm->bhm", r1, S_prev) \
        + (r1 * p["u"] * k1).sum(-1, keepdim=True) * v1
    S_new = torch.exp(lw1)[..., None] * S_prev \
        + k1[..., :, None] * v1[..., None, :]
    out = _time_mix_out(p, cfg, o[:, None], g, x)
    return out, {**state, "s": S_new, "x_tm": x[:, 0].float()}


def channel_mix_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       state: dict) -> Tuple[torch.Tensor, dict]:
    xp = state["x_cm"].to(x.dtype)[:, None]
    out = _channel_mix(p, cfg, x, xp)
    return out, {**state, "x_cm": x[:, 0].float()}
