"""ResNet50 and MobileNetV2 — the paper's CV evaluation models (§V-A),
ported from `repro.models.cnn`.

Unrolled execution: every weight-bearing unit (stem / residual block /
head) is a separate params subtree and a separate freeze unit, so
SimFreeze's arbitrary per-layer freezing behaves as in the paper: a
frozen unit's params are detached (`maybe_stop`), which drops its
weight-gradient work, and a frozen prefix detaches its activations too.

Params layout (the JAX one, so the weights bridge unchanged): convolution
kernels are HWIO and the head is [in, out], used as ``x @ W + b``. The
kernels are permuted to PyTorch's OIHW at call time. Activations run as
NCHW tensors that are views of the NHWC images (channels-last memory),
and `features` returns them as NHWC again, so a flattened feature map
lists its numbers in the reference's order.

JAX's ``"SAME"`` padding is asymmetric where the total pad is odd (the
high side gets the extra row, as on a stride-2 3x3 conv of an even
size), so the convolutions and the ResNet stem's max-pool pad with
`F.pad` themselves and run unpadded. Normalization is functional on batch
statistics (mean and population variance over N, H, W; no running
stats), as in the reference.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from repro_torch import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.freeze_plan import maybe_stop
from repro_torch.models import common


def _conv_init(generator, kh, kw, cin, cout):
    return common.normal_init(generator, (kh, kw, cin, cout),
                              math.sqrt(2.0 / (kh * kw * cin)))


def _same_pad(size: int, k: int, s: int):
    """(low, high) padding of JAX's "SAME" for one spatial dim."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """x [N, C, H, W] padded as JAX's "SAME" pads a k x k window of
    stride s."""
    top, bottom = _same_pad(x.shape[2], k, s)
    left, right = _same_pad(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def conv2d(x, w, stride=1, groups=1):
    """x [N, C, H, W], w HWIO: JAX's NHWC/HWIO "SAME" convolution."""
    x = _pad_same(x, w.shape[0], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, groups=groups)


def bn(x, scale, bias, eps=1e-5):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale[:, None, None] \
        + bias[:, None, None]


def _bn_params(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


# ---------------------------------------------------------------------------
# ResNet (bottleneck)


def _resnet_spec(cfg: ModelConfig):
    if "reduced" in cfg.name:
        return [1, 1, 1, 1], 32
    return [3, 4, 6, 3], 64


def resnet_static_spec(cfg: ModelConfig):
    """Static per-unit structure (kept out of the params tree)."""
    blocks_per_stage, base = _resnet_spec(cfg)
    spec = [{"kind": "stem"}]
    cin = base
    for si, nblocks in enumerate(blocks_per_stage):
        width = base * (2 ** si)
        cout = width * 4
        for bi in range(nblocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            spec.append({"kind": "bottleneck", "stride": stride, "cin": cin,
                         "width": width, "cout": cout,
                         "proj": cin != cout or stride != 1})
            cin = cout
    spec.append({"kind": "head", "cin": cin})
    return spec


def init_resnet(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the CPU, drawn from `generator`."""
    _, base = _resnet_spec(cfg)
    spec = resnet_static_spec(cfg)
    units: List[dict] = []
    for sp in spec[:-1]:
        if sp["kind"] == "stem":
            units.append({"conv": _conv_init(generator, 7, 7, 3, base),
                          "bn": _bn_params(base)})
            continue
        cin, width, cout = sp["cin"], sp["width"], sp["cout"]
        u = {"c1": _conv_init(generator, 1, 1, cin, width),
             "b1": _bn_params(width),
             "c2": _conv_init(generator, 3, 3, width, width),
             "b2": _bn_params(width),
             "c3": _conv_init(generator, 1, 1, width, cout),
             "b3": _bn_params(cout)}
        if sp["proj"]:
            u["proj"] = _conv_init(generator, 1, 1, cin, cout)
            u["proj_bn"] = _bn_params(cout)
        units.append(u)
    cin = spec[-1]["cin"]
    head = {"w": common.dense_init(generator, cin, (cin, cfg.num_classes)),
            "b": torch.zeros(cfg.num_classes)}
    return {"units": units, "head": head}


def _apply_resnet_unit(sp: dict, u: dict, x):
    if sp["kind"] == "stem":
        x = F.relu(bn(conv2d(x, u["conv"], 2), **u["bn"]))
        # reduce_window max, 3x3 stride 2, "SAME" with -inf padding
        return F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, 2)
    h = F.relu(bn(conv2d(x, u["c1"]), **u["b1"]))
    h = F.relu(bn(conv2d(h, u["c2"], sp["stride"]), **u["b2"]))
    h = bn(conv2d(h, u["c3"]), **u["b3"])
    sc = x
    if "proj" in u:
        sc = bn(conv2d(x, u["proj"], sp["stride"]), **u["proj_bn"])
    return F.relu(h + sc)


# ---------------------------------------------------------------------------
# MobileNetV2 (inverted residuals)

_MBV2_SPEC = [  # (expansion, out_c, num_blocks, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
_MBV2_SPEC_REDUCED = [(1, 16, 1, 1), (6, 24, 1, 2), (6, 32, 1, 2), (6, 64, 1, 2)]


def mbv2_static_spec(cfg: ModelConfig):
    table = _MBV2_SPEC_REDUCED if "reduced" in cfg.name else _MBV2_SPEC
    wm = cfg.width_mult

    def c(ch):
        return max(8, int(ch * wm + 4) // 8 * 8)

    spec = [{"kind": "stem", "cout": c(32)}]
    cin = c(32)
    for t, ch, n, s in table:
        cout = c(ch)
        for bi in range(n):
            stride = s if bi == 0 else 1
            spec.append({"kind": "invres", "stride": stride, "expand": t,
                         "cin": cin, "hid": cin * t, "cout": cout})
            cin = cout
    spec.append({"kind": "last", "cin": cin, "cout": c(1280)})
    return spec


def init_mbv2(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on the CPU, drawn from `generator`."""
    spec = mbv2_static_spec(cfg)
    units: List[dict] = []
    for sp in spec:
        if sp["kind"] == "stem":
            units.append({"conv": _conv_init(generator, 3, 3, 3, sp["cout"]),
                          "bn": _bn_params(sp["cout"])})
        elif sp["kind"] == "last":
            units.append({"conv": _conv_init(generator, 1, 1, sp["cin"],
                                             sp["cout"]),
                          "bn": _bn_params(sp["cout"])})
        else:
            hid, cout, cin = sp["hid"], sp["cout"], sp["cin"]
            u = {"dw": _conv_init(generator, 3, 3, 1, hid),
                 "dw_bn": _bn_params(hid),
                 "pw": _conv_init(generator, 1, 1, hid, cout),
                 "pw_bn": _bn_params(cout)}
            if sp["expand"] != 1:
                u["exp"] = _conv_init(generator, 1, 1, cin, hid)
                u["exp_bn"] = _bn_params(hid)
            units.append(u)
    clast = spec[-1]["cout"]
    head = {"w": common.dense_init(generator, clast, (clast, cfg.num_classes)),
            "b": torch.zeros(cfg.num_classes)}
    return {"units": units, "head": head}


def _apply_mbv2_unit(sp: dict, u: dict, x):
    if sp["kind"] in ("stem", "last"):
        s = 2 if sp["kind"] == "stem" else 1
        return F.relu6(bn(conv2d(x, u["conv"], s), **u["bn"]))
    h = x
    if "exp" in u:
        h = F.relu6(bn(conv2d(h, u["exp"]), **u["exp_bn"]))
    hid = h.shape[1]
    h = F.relu6(bn(conv2d(h, u["dw"], sp["stride"], groups=hid),
                   **u["dw_bn"]))
    h = bn(conv2d(h, u["pw"]), **u["pw_bn"])
    if sp["stride"] == 1 and x.shape[1] == h.shape[1]:
        h = h + x
    return h


# ---------------------------------------------------------------------------
# shared classifier scaffolding


def _forward(params, images, plan, spec, apply_unit, collect=False):
    """NHWC images -> (logits, the NHWC activation after every unit but
    the head when `collect`)."""
    units = params["units"]
    flags = plan.layers if plan is not None else (False,) * (len(units) + 1)
    prefix_frozen = True
    feats = []
    x = images.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory
    for sp, u, frozen in zip(spec, units, flags):
        x = apply_unit(sp, maybe_stop(u, frozen), x)
        if frozen and prefix_frozen:
            x = x.detach()
        else:
            prefix_frozen = False
        if collect:
            feats.append(x.permute(0, 2, 3, 1))
    x = x.mean(dim=(2, 3))
    head = maybe_stop(params["head"], flags[-1])
    return x @ head["w"] + head["b"], feats


def build(cfg: ModelConfig, device: torch.device):
    from repro_torch.models import Model

    is_resnet = cfg.name.startswith("resnet")
    init_fn = init_resnet if is_resnet else init_mbv2
    unit_fn = _apply_resnet_unit if is_resnet else _apply_mbv2_unit
    spec = resnet_static_spec(cfg) if is_resnet else mbv2_static_spec(cfg)
    if is_resnet:
        spec = spec[:-1]  # the head is applied apart

    def loss(params, batch, plan=None):
        logits, _ = _forward(params, batch["images"], plan, spec, unit_fn)
        l = common.cross_entropy(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).float().mean()
        return l, {"loss": l, "acc": acc, "logits": logits}

    @torch.inference_mode()
    def predict(params, batch):
        return _forward(params, batch["images"], None, spec, unit_fn)[0]

    def features(params, batch):
        # differentiable, as the reference's is: SimSiam's semi step takes
        # its gradient through the last activation (runtime/executor.py).
        # The stored params never require grad, so a probe records no
        # graph
        return _forward(params, batch["images"], None, spec, unit_fn,
                        collect=True)[1]

    return Model(cfg=cfg, device=device,
                 init=lambda generator: tree_map(
                     lambda t: t.to(device), init_fn(generator, cfg)),
                 loss=loss, features=features,
                 num_freeze_units=len(spec) + 1, predict=predict)
