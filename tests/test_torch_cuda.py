"""The port's CUDA kernels on the card against their plain versions, one
train step on the card against the same step on the CPU, and the compiled
hot path's CUDA graphs against the eager calls they replay.

These need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so on a
machine without a card every test here skips. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.freeze_plan import LayerFreezePlan
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops
from repro_torch.kernels.rwkv import ops as wkv_ops
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import (TrainStepCache, as_tensor,
                                            grads_of, make_optimizer_state)

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


def _hd_stride_2(t):
    return torch.stack([t, torch.zeros_like(t)], dim=-1)[..., 0]


def _misaligned(t):
    flat = torch.empty(t.numel() + 1, device=t.device)
    out = flat[1:].view(t.shape)  # 4 bytes past a 16-byte boundary
    out.copy_(t)
    return out


def _row_stride_odd(t):
    padded = torch.zeros((*t.shape[:3], t.shape[3] + 1), device=t.device)
    padded[..., :-1] = t
    return padded[..., :-1]


@pytest.mark.parametrize("layout", [_hd_stride_2, _misaligned,
                                    _row_stride_odd])
def test_flash_kernel_copies_inputs_cp_async_cannot_read(gen, layout):
    # k and v that cp.async cannot copy in 16-byte units are copied
    # contiguous first (attention ops._copyable); q takes the same path
    q, k, v = (_randn(gen, (2, 130, 2, 32)) for _ in range(3))
    q, k, v = layout(q), layout(k), layout(v)
    assert k.stride(3) != 1 or k.data_ptr() % 16 or k.stride(2) % 4
    before = att_ops.flash_attention.launches
    got = att_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert att_ops.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got, att_ops.attention_plain(q, k, v, causal=True),
        rtol=2e-4, atol=2e-5)


def test_flash_kernel_is_deterministic(gen):
    q, k, v = (_randn(gen, (16, 197, 3, 64)) for _ in range(3))
    first = att_ops.flash_attention(q, k, v, causal=False)
    second = att_ops.flash_attention(q, k, v, causal=False)
    assert torch.equal(first, second)


def test_flash_kernel_rejects_unsupported_head_dim(gen):
    q = _randn(gen, (1, 8, 2, 48))
    with pytest.raises(ValueError):
        att_ops.flash_attention(q, q, q)


CKA_ROUTES = {"feature": cka_ops._launch_feature,
              "example": cka_ops._launch_example}


@pytest.mark.parametrize("n,dx,dy", [(3152, 192, 192), (200, 300, 300),
                                     (520, 192, 192), (100, 1000, 1000),
                                     (300, 192, 100), (192, 192, 192),
                                     (384, 192, 192), (3153, 192, 192),
                                     (300, 200, 100), (97, 30, 50)])
def test_cka_kernel_matches_plain(gen, n, dx, dy):
    x, y = _randn(gen, (n, dx)), _randn(gen, (n, dy))
    y[:, :min(dx, dy)] += 0.3 * x[:, :min(dx, dy)]
    before = dict(cka_ops.cka_terms.route_launches)
    got = torch.stack(cka_ops.cka_terms(x, y))
    route = "feature" if cka_ops.feature_route(n, dx, dy) else "example"
    assert cka_ops.cka_terms.route_launches == {
        r: c + (r == route) for r, c in before.items()}
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    hsic, kk, ll = cka_ops.cka_terms_plain(xc, yc)
    want = torch.stack([hsic, kk.sqrt(), ll.sqrt()])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    # both routes, whichever the rule picks
    for launch in CKA_ROUTES.values():
        hsic, kk, ll = launch(xc, yc)
        torch.testing.assert_close(torch.stack([hsic, kk.sqrt(), ll.sqrt()]),
                                   want, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("route", CKA_ROUTES)
def test_cka_kernel_is_deterministic_and_one_on_itself(gen, route):
    x, y = _randn(gen, (3152, 192)), _randn(gen, (3152, 192))
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    launch = CKA_ROUTES[route]
    assert torch.equal(torch.stack(launch(xc, yc)),
                       torch.stack(launch(xc, yc)))
    hsic, kk, ll = launch(xc, xc)
    assert abs(float(hsic / (kk.sqrt() * ll.sqrt())) - 1.0) < 1e-5
    # and through the public wrapper, which takes the feature route here
    assert abs(float(cka_ops.cka(x, x)) - 1.0) < 1e-5


@pytest.mark.parametrize("d", [2560, 131072, 262144])
def test_cka_example_route_at_the_cnn_probe_shapes(gen, d):
    # a CNN probe: 16 examples of a flattened feature map, d = H*W*C from
    # MobileNetV2's last block (4*4*160) through its stem (64*64*32) to
    # ResNet50's first stage (32*32*256) at 128x128; d >> n, the example
    # route
    x, y = _randn(gen, (16, d)), _randn(gen, (16, d))
    y += 0.3 * x
    before = dict(cka_ops.cka_terms.route_launches)
    got = torch.stack(cka_ops.cka_terms(x, y))
    assert cka_ops.cka_terms.route_launches == {
        r: c + (r == "example") for r, c in before.items()}
    xc, yc = cka_ops._prepare(x), cka_ops._prepare(y)
    hsic, kk, ll = cka_ops.cka_terms_plain(xc, yc)
    torch.testing.assert_close(got, torch.stack([hsic, kk.sqrt(), ll.sqrt()]),
                               rtol=1e-4, atol=0.0)
    assert torch.equal(torch.stack(cka_ops._launch_example(xc, yc)),
                       torch.stack(cka_ops._launch_example(xc, yc)))


def _example_matches_plain(x, y):
    """The wrapper, which takes the example route where its rule says so,
    and the example route called directly, on x and y as they are (raw or
    centered, any alignment), against the plain version of the centered
    inputs."""
    n, dx = x.shape
    dy = y.shape[1]
    hsic, kk, ll = cka_ops.cka_terms_plain(cka_ops._prepare(x),
                                           cka_ops._prepare(y))
    want = torch.stack([hsic, kk.sqrt(), ll.sqrt()])
    before = dict(cka_ops.cka_terms.route_launches)
    got = torch.stack(cka_ops.cka_terms(x, y))
    route = "feature" if cka_ops.feature_route(n, dx, dy) else "example"
    assert cka_ops.cka_terms.route_launches == {
        r: c + (r == route) for r, c in before.items()}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    hsic, kk, ll = cka_ops._launch_example(x, y)
    torch.testing.assert_close(torch.stack([hsic, kk.sqrt(), ll.sqrt()]),
                               want, rtol=1e-4, atol=0.0)


def _probe_dims(arch):
    """d = H*W*C of every map of a 16-image probe pass of `arch` at full
    width, from shapes on the meta device."""
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    images = torch.empty((16, cfg.image_size, cfg.image_size, 3),
                         device="meta")
    return [f[0].numel() for f in
            model.features(model.init(torch.Generator()), {"images": images})]


@pytest.mark.parametrize("arch", ["mobilenetv2", "resnet50"])
def test_cka_example_route_at_every_cnn_probe_map(gen, arch):
    dims = _probe_dims(arch)
    assert len(dims) == {"mobilenetv2": 19, "resnet50": 17}[arch]
    for d in sorted(set(dims)):
        x = _randn(gen, (16, d))
        _example_matches_plain(x, _randn(gen, (16, d)) + 0.3 * x)


@pytest.mark.parametrize("n,dx,dy", [
    (1, 300, 300), (13, 2560, 2560), (16, 2560, 2560), (17, 2560, 2560),
    (40, 2560, 2560), (64, 2560, 2560), (65, 2560, 2560),
    (3152, 192, 192),                      # the DeiT-tiny probe's examples
    (16, 4096, 2560), (40, 1000, 300),     # dx != dy
    (16, 5000, 1), (13, 1000, 1),          # dy = 1
    (3153, 192, 192), (300, 200, 100), (97, 30, 50), (1000, 64, 1),
    (65, 1, 64),                           # ragged
    (16, 131071, 131071), (16, 2562, 2561), (17, 999, 1001),  # d % 4 != 0
])
def test_cka_example_route_matches_plain(gen, n, dx, dy):
    x = _randn(gen, (n, dx))
    y = _randn(gen, (n, dy))
    y[:, :min(dx, dy)] += 0.3 * x[:, :min(dx, dy)]
    _example_matches_plain(x, y)


@pytest.mark.parametrize("n,d", [(16, 4096), (13, 131072), (40, 1000)])
def test_cka_example_route_reads_rows_that_are_not_16_byte_aligned(gen, n,
                                                                   d):
    # contiguous, but 4 bytes past a 16-byte boundary: scalar loads
    def misaligned(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    x = _randn(gen, (n, d))
    x, y = misaligned(x), misaligned(_randn(gen, (n, d)) + 0.3 * x)
    assert x.is_contiguous() and x.data_ptr() % 16
    _example_matches_plain(x, y)


@pytest.mark.parametrize("n,d", [(16, 131072), (13, 2560), (40, 2560)])
def test_cka_example_route_centers_raw_inputs(gen, n, d):
    # columns offset by 1e3 to 2e3: the kernel centers a one-tile plan's
    # columns itself (n <= 16), the wrapper centers the rest in torch
    offset = 1e3 * (1 + torch.rand(d, generator=gen)).cuda()
    x = _randn(gen, (n, d)) + offset
    _example_matches_plain(x, _randn(gen, (n, d)) + 0.3 * x)
    assert cka_ops.example_plan(n, d, d).center == (n <= 16)


def test_cka_feature_route_products_are_3xtf32(gen):
    # entries +-(1 + 2^-12), rows in +- pairs so the columns are centered:
    # TF32 rounds every entry to +-1, so one TF32 product would be off by
    # 1 - (1 + 2^-12)^-4 ~ 1e-3 in every term; 3xTF32 keeps the 2^-12
    half = torch.randn((1576, 384), generator=gen).sign()
    z = (torch.cat([half, -half]) * (1 + 2 ** -12)).cuda()
    x, y = z[:, :192].contiguous(), z[:, 192:].contiguous()
    got = torch.stack(cka_ops._launch_feature(x, y)).double()
    x, y = x.double(), y.double()
    want = torch.stack([(y.T @ x).square().sum(), (x.T @ x).square().sum(),
                        (y.T @ y).square().sum()])
    assert float(((got - want) / want).abs().max()) < 1e-5


def _wkv_inputs(gen, B, T, H, n, draw="init"):
    r, k, v = (_randn(gen, (B, T, H, n)) for _ in range(3))
    if draw == "init":  # the model's init range
        logw = -(0.3 + 0.15 * torch.rand((B, T, H, n), generator=gen))
    else:  # -exp(U(-8, 2)): a trained model's range
        logw = -torch.exp(-8 + 10 * torch.rand((B, T, H, n), generator=gen))
    return r, k, v, logw.cuda(), \
        (0.3 * torch.randn((H, n), generator=gen)).cuda()


@pytest.mark.parametrize("draw", ["init", "wide"])
@pytest.mark.parametrize("B,T,H,n", [
    (4, 512, 40, 64),   # rwkv6-3b prefill
    (1, 50, 4, 16),     # ragged T, reduced head size
    (2, 130, 3, 32),
    (2, 1, 2, 64),
    (1, 256, 4, 64),    # T at a boundary of the 8-token tiles
    (1, 257, 4, 64),    # and one past it
])
def test_wkv_kernel_matches_plain(gen, B, T, H, n, draw):
    inputs = _wkv_inputs(gen, B, T, H, n, draw)
    s0 = 0.1 * _randn(gen, (B, H, n, n))
    before = wkv_ops.wkv.launches
    o, s = wkv_ops.wkv(*inputs, s0=s0, return_state=True)
    want_o, want_s = wkv_ops.wkv_plain(*inputs, s0=s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == before + 1
    torch.testing.assert_close(o, want_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(4, 512, 40, 64), (1, 512, 40, 64)])
def test_wkv_kernel_is_deterministic(gen, shape):
    inputs = _wkv_inputs(gen, *shape, "wide")
    first = wkv_ops.wkv(*inputs, return_state=True)
    second = wkv_ops.wkv(*inputs, return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_wkv_kernel_rejects_unsupported_head_size(gen):
    with pytest.raises(ValueError, match="head sizes"):
        wkv_ops.wkv(*_wkv_inputs(gen, 1, 8, 2, 48))


@pytest.mark.parametrize("flags", [(False,) * 6,
                                   (True, True, False, False, False, False)])
def test_train_step_on_the_card_matches_the_cpu(gen, flags):
    # the step launches no kernel (its attention is the plain version), so
    # the card and the CPU differ by their summation orders only. The key
    # bias's gradient is zero in exact arithmetic (softmax removes a
    # per-query constant) and rounding noise on both devices, which AdamW
    # scales up to lr: the updated params are held by what they compute.
    cfg = get_reduced("deit-tiny").replace(use_pallas=True)
    batch_gen = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn((8, 32, 32, 3), generator=batch_gen),
             "labels": torch.randint(0, 10, (8,), generator=batch_gen,
                                     dtype=torch.int32)}
    plan = LayerFreezePlan(flags)
    cpu_model = build_model(cfg, device="cpu")
    out = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        opt_cfg = AdamWConfig(lr=1e-3)
        state = make_optimizer_state(model, opt_cfg, params)
        before = att_ops.flash_attention.launches
        loss, _, grads = grads_of(model.loss, params,
                                  as_tensor(batch, device), plan)
        new, _, _ = TrainStepCache(model, opt_cfg).get(plan)(
            params, state, as_tensor(batch, device))
        assert att_ops.flash_attention.launches == before
        assert all(t.device.type == device and not t.requires_grad
                   for t in tree_leaves(new))
        noise = [blk["attn"].pop("bk").abs().max() / blk["attn"]["bq"]
                 .abs().max() for blk in grads["blocks"]
                 if blk["attn"]["bq"].any()]
        assert all(r <= 1e-4 for r in noise)
        logits = cpu_model.predict(tree_map(lambda t: t.cpu(), new), batch)
        out[device] = (loss.cpu(), [t.cpu() for t in tree_leaves(grads)],
                       logits)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    for g, w in zip(out["cuda"][1], out["cpu"][1], strict=True):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the compiled hot path's CUDA graphs


def _loop_batches(cfg, n, seed=2, size=8):
    rng = np.random.default_rng(seed)
    return [{"images": rng.random((size, cfg.image_size, cfg.image_size, 3),
                                  dtype=np.float32),
             "labels": rng.integers(0, cfg.num_classes, size)
             .astype(np.int32)} for _ in range(n)]


def _cuda_model(arch):
    cfg = get_reduced(arch)
    if arch == "deit-tiny":
        cfg = cfg.replace(use_pallas=True)
    model = build_model(cfg, device="cuda")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["deit-tiny", "mobilenetv2"])
@pytest.mark.parametrize("bucket,length", [(1, 1), (2, 2), (8, 5)])
def test_graphed_fused_call_is_the_plain_masked_loop(gen, arch, bucket,
                                                     length):
    # the graph replays the kernels the eager loop launches, so the
    # params, Adam's step and both moments agree to the bit, and so do
    # `length` single eager steps; the caller's tensors stay unwritten
    model, params = _cuda_model(arch)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = make_optimizer_state(model, opt_cfg, params)
    plan = LayerFreezePlan((False,) * model.num_freeze_units)
    cache = TrainStepCache(model, opt_cfg)
    batches = _loop_batches(model.cfg, length)
    kept = [t.clone() for t in tree_leaves((params, state))]
    fn, got_bucket = cache.multi_step(plan, batches[0], length)
    assert got_bucket == bucket and fn.graph is not None
    fused = cache.fused_call(plan, params, state, batches)
    fused = cache.fused_call(plan, params, state, batches)  # a replay
    assert fn.graph.replays == 2
    padded = batches + [batches[0]] * (bucket - length)
    plain = fn._loop((params, state, [as_tensor(b, "cuda") for b in padded],
                      torch.arange(bucket, device="cuda") < length))
    p, s = params, state
    step = cache.get(plan)
    for b in batches:
        p, s, _ = step(p, s, as_tensor(b, "cuda"))
    torch.cuda.synchronize()
    for a, b, c in zip(tree_leaves(fused[:2]), tree_leaves(plain[:2]),
                       tree_leaves((p, s)), strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(fused[1].step) == length
    for a, b in zip(kept, tree_leaves((params, state)), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deit-tiny", "mobilenetv2"])
def test_forward_stack_graph_is_per_group_eager_predict(gen, arch):
    # each group keeps its own predict call (MobileNetV2 normalizes on the
    # group's batch statistics; DeiT-tiny runs flash attention inside the
    # graph), three groups padded to a bucket of four
    from repro_torch.runtime.inference import InferenceServer

    model, params = _cuda_model(arch)
    concats = _loop_batches(model.cfg, 3, seed=3, size=16)
    sig = tuple(sorted((k, v.shape, str(v.dtype))
                       for k, v in concats[0].items()))
    server = InferenceServer(model, fused=True)
    before = att_ops.flash_attention.launches
    got = server._forward_stack(model, params, "default", sig, concats)
    got = server._forward_stack(model, params, "default", sig, concats)
    counted = att_ops.flash_attention.launches - before
    want = [model.predict(params, as_tensor(c, "cuda")).cpu().numpy()
            for c in concats]
    assert len(got) == 3
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    if arch == "deit-tiny":
        # the wrapper counts the warm-up and the capture (4 groups of 2
        # layers each), not the replays, which launch on the card alone
        assert counted == 2 * 4 * model.cfg.num_layers


def test_graphed_forward_is_the_eager_forward(gen):
    from repro_torch.runtime.train_loop import compiled_model

    model, params = _cuda_model("deit-tiny")
    wrapped = compiled_model(model)
    batch = as_tensor(_loop_batches(model.cfg, 1, size=16)[0], "cuda")
    for _ in range(2):
        got = wrapped.predict(params, batch), wrapped.features(params, batch)
    want = model.predict(params, batch), model.features(params, batch)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1], strict=True):
        assert torch.equal(a, b)
    graph = wrapped.predict.graphs[next(iter(wrapped.predict.graphs))]
    assert graph.replays == 2


def test_compiled_session_on_the_card_is_the_eager_session(gen):
    # `tests/test_torch_compiled.py`'s equalities on the card: a compiled
    # preemptible qos session (train-step graphs, stacked serving graphs,
    # graphed probes) against per-event and eager runs of the same session
    from repro_torch.runtime import RuntimeConfig, SlotConfig, edgeol_session

    def run(compiled, segment=True):
        cfg = RuntimeConfig(
            slots={"cv": SlotConfig()}, workload="qos",
            workload_scale=dict(batches_per_scenario=4, inferences=10,
                                num_scenarios=2),
            seed=0, pretrain_epochs=1, preemptible=True, compiled=compiled)
        rt = edgeol_session(cfg, device="cuda")
        rt.segment = segment
        res = rt.run()
        return res, tree_leaves(rt.fleet.devices[0].primary.executor.params)

    base, base_params = run(True)
    assert base.preemptions > 0
    for other, params in (run(True, segment=False), run(False)):
        assert (other.rounds, other.recompiles, other.preemptions) == \
            (base.rounds, base.recompiles, base.preemptions)
        assert other.inference_accs == base.inference_accs
        assert other.val_curve == base.val_curve
        assert other.total_time_s == base.total_time_s
        assert other.per_stream == base.per_stream
        assert all(torch.equal(a, b)
                   for a, b in zip(params, base_params, strict=True))
