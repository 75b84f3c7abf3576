"""The port's kernel modules on the CPU against the JAX package: the plain
versions that `flash_attention` and `cka_terms` take for CPU tensors, held
against the Pallas kernels (interpret mode) and their `ref.py` oracles on
the same numpy inputs, plus the wrappers' input checks; and the arithmetic
of the kernels that only the card runs (3xTF32 products, the bf16 flash
kernel's P in two bf16 terms, the CKA feature route's plan, the CKA
example route's plan, summation order and fused centering), emulated in
plain torch; and the wrappers' refusal to run where autograd would need
the backward the kernels do not have."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cka import cka as jax_cka
from repro.kernels.attention import ops as jax_att_ops
from repro.kernels.attention import ref as jax_att_ref
from repro.kernels.cka import ops as jax_cka_ops
from repro.kernels.cka import ref as jax_cka_ref
from repro_torch.core.cka import cka
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops
from repro_torch.kernels.rwkv import ops as wkv_ops

RNG = np.random.default_rng(7)


def _randn(shape):
    return RNG.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash attention


@pytest.mark.parametrize("S,Hq,Hkv,hd", [(128, 4, 4, 32), (256, 4, 2, 64),
                                         (192, 8, 1, 64)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 50.0),
                                            (48, 30.0)])
def test_flash_attention_matches_pallas(S, Hq, Hkv, hd, window, softcap):
    B = 2
    q, k, v = _randn((B, S, Hq, hd)), _randn((B, S, Hkv, hd)), \
        _randn((B, S, Hkv, hd))
    want = jax_att_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window,
                                       softcap=softcap, bq=64, bk=64)
    got = att_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ragged_matches_ref(causal):
    # S=100 is not a multiple of the 64-row tile: the Pallas wrapper's
    # zero-padded keys are masked only by the causal test, so the ragged
    # non-causal case is held against the dense oracle
    B, S, H, hd = 1, 100, 2, 32
    q, k, v = _randn((B, S, H, hd)), _randn((B, S, H, hd)), \
        _randn((B, S, H, hd))
    want = jax_att_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal)
    got = att_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shapes,error", [
    (((2, 8, 4, 16), (2, 8, 3, 16), (2, 8, 3, 16)), ValueError),  # Hq % Hkv
    (((2, 8, 4, 16), (2, 8, 4, 32), (2, 8, 4, 32)), ValueError),  # hd
    (((2, 8, 64), (2, 8, 64), (2, 8, 64)), ValueError),           # rank
])
def test_flash_attention_rejects_bad_shapes(shapes, error):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(error):
        att_ops.flash_attention(q, k, v)


def test_flash_attention_rejects_integer_inputs():
    q = torch.zeros((1, 4, 1, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        att_ops.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_out_dtype_is_the_plain_result_cast(dtype,
                                                             out_dtype):
    # the CPU route returns attention_plain's fp32 result in out_dtype, as
    # the bf16 kernel writes its fp32 result rounded once
    q, k, v = (torch.from_numpy(_randn((2, 70, 4, 32))).to(dtype)
               for _ in range(3))
    kw = dict(causal=True, window=24, softcap=50.0)
    got = att_ops.flash_attention(q, k, v, **kw, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, att_ops.attention_plain(q, k, v, **kw)
                       .to(out_dtype))


# ---------------------------------------------------------------------------
# CKA Gram terms


@pytest.mark.parametrize("n,d", [(64, 128), (200, 300), (520, 192)])
def test_cka_terms_match_pallas(n, d):
    x = _randn((n, d))
    y = (0.3 * x + RNG.normal(size=(n, d))).astype(np.float32)
    want = jax_cka_ops.cka_terms(jnp.asarray(x), jnp.asarray(y))
    got = cka_ops.cka_terms(torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    np.testing.assert_allclose(float(cka_ops.cka(torch.from_numpy(x),
                                                 torch.from_numpy(y))),
                               float(jax_cka_ops.cka(jnp.asarray(x),
                                                     jnp.asarray(y))),
                               rtol=1e-4)


def test_cka_identical_inputs_is_one():
    x = torch.from_numpy(_randn((128, 256)))
    assert abs(float(cka_ops.cka(x, x)) - 1.0) < 1e-5


def test_cka_terms_reject_row_mismatch():
    with pytest.raises(ValueError):
        cka_ops.cka_terms(torch.zeros((8, 4)), torch.zeros((9, 4)))


# n < d takes the example form, n >= d the feature form; use_kernel always
# takes the CKA kernel's route
@pytest.mark.parametrize("shape", [(40, 100), (130, 64), (4, 9, 16)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_core_cka_matches_jax(shape, use_kernel):
    x = _randn(shape)
    y = (0.5 * x + RNG.normal(size=shape)).astype(np.float32)
    want = float(jax_cka(jnp.asarray(x), jnp.asarray(y),
                         use_kernel=use_kernel))
    got = float(cka(torch.from_numpy(x), torch.from_numpy(y),
                    use_kernel=use_kernel))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, which the card alone runs: 3xTF32 products
# (csrc/tf32x3.cuh) and the CKA routes' plans (kernels/cka/ops.py)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as `cvt.rna.tf32.f32` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b from TF32 operands: the 3xTF32 step (small products first,
    then big x big, each product of two TF32 values exact in fp32), or a
    single TF32 product."""
    a_big, b_big = _tf32(a), _tf32(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _attention_tf32(q, k, v, causal, products):
    """`attention_plain` with both products taken as `_mm`."""
    B, Sq, H, hd = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = _mm(qh, kh.transpose(-1, -2), products) / math.sqrt(hd)
    if causal:
        mask = torch.ones((Sq, Sq), dtype=torch.bool).tril()
        s = s.masked_fill(~mask, att_ops.NEG_INF)
    return _mm(torch.softmax(s, dim=-1), vh, products).permute(0, 2, 1, 3)


def _cka_terms_tf32(x, y, products):
    """(hsic, kk, ll) from G = Z^T Z, Z = [X | Y], G in `_mm`."""
    dx = x.shape[1]
    z = torch.cat([x, y], dim=1)
    g = _mm(z.T.contiguous(), z, products).double()
    return ((g[:dx, dx:] ** 2).sum(), (g[:dx, :dx] ** 2).sum(),
            (g[dx:, dx:] ** 2).sum())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -10, 3.0e-3])
    got = _tf32(x)
    # ties go away from zero; 2^-10 is kept; the low 13 bits are zero
    assert got[:5].tolist() == [1.0, 1 + 2 ** -10, 1 + 2 * 2 ** -10,
                                -(1 + 2 ** -10), 1 + 2 ** -10]
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_attention_meets_the_kernel_tolerance(causal):
    q, k, v = (_randn((2, 197, 3, 64)) for _ in range(3))
    want = np.asarray(jax_att_ref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = _attention_tf32(tq, tk, tv, causal, products=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    # one TF32 product keeps ~3 decimal digits: it misses the tolerance,
    # which is why the kernel takes three
    single = _attention_tf32(tq, tk, tv, causal, products=1)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(single.numpy(), want, rtol=2e-4,
                                   atol=2e-5)


def _attention_bf16_split(q, k, v, causal, window, softcap, terms):
    """The bf16 kernel's arithmetic in plain torch: S = Q K^T from the bf16
    inputs in fp32 (each product exact), the softmax's exponentials in
    fp32, P split into `terms` bf16 terms (hi = rn(P), lo = rn(P - hi)),
    each term's product with the exact bf16 V in fp32, and the sum divided
    by the fp32 row sum once."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * (
        1.0 / math.sqrt(hd))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, att_ops.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    parts = [hi] if terms == 1 else [(p - hi).bfloat16().float(), hi]
    out = sum(torch.einsum("bkgqs,bskh->bqkgh", part, v.float())
              for part in parts)
    out = out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, hd)


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("causal,window,softcap,Hkv", [
    (False, 0, 0.0, 4),
    (True, 0, 0.0, 2),     # GQA
    (True, 0, 50.0, 2),    # gemma2's softcap
    (True, 48, 50.0, 1),   # and its window, MQA
])
def test_bf16_split_attention_meets_the_kernel_tolerance(hd, causal, window,
                                                         softcap, Hkv):
    # bf16 inputs (fp32 arrays of bf16 values) through the Pallas kernel in
    # interpret mode, which upcasts them and keeps P in fp32, and through
    # the bf16 kernel's arithmetic: P in two bf16 terms meets the kernel
    # tolerance, one term misses it
    B, S, Hq = 2, 128, 4
    q, k, v = (torch.from_numpy(_randn((B, S, H, hd))).bfloat16()
               for H in (Hq, Hkv, Hkv))
    want = np.asarray(jax_att_ops.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal,
        window=window, softcap=softcap, bq=64, bk=64))
    two = _attention_bf16_split(q, k, v, causal, window, softcap, terms=2)
    np.testing.assert_allclose(two.numpy(), want, rtol=2e-4, atol=2e-5)
    one = _attention_bf16_split(q, k, v, causal, window, softcap, terms=1)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one.numpy(), want, rtol=2e-4, atol=2e-5)


def _cka_inputs(n, dx, dy):
    x = _randn((n, dx))
    y = _randn((n, dy))
    m = min(dx, dy)
    y[:, :m] += 0.3 * x[:, :m]
    return x - x.mean(0), y - y.mean(0)


def _max_rel_err(got, want):
    return max(abs(float(g) - float(w)) / abs(float(w))
               for g, w in zip(got, want))


@pytest.mark.parametrize("n,dx,dy", [(3152, 192, 192), (520, 192, 192),
                                     (300, 200, 100)])
def test_3xtf32_cka_terms_meet_the_kernel_tolerance(n, dx, dy):
    x, y = _cka_inputs(n, dx, dy)
    want = jax_cka_ref.cka_terms_ref(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    three = _max_rel_err(_cka_terms_tf32(tx, ty, products=3), want)
    single = _max_rel_err(_cka_terms_tf32(tx, ty, products=1), want)
    assert three < 1e-4
    # unlike attention, one TF32 product would pass here too: its rounding
    # errors average out over the squared Gram entries. The three products
    # buy margin, not the pass
    assert three < single < 1e-4


def _beyond_tf32(n, dx, dy):
    """X, Y of entries +-(1 + 2^-12), rows in +- pairs so the columns are
    centered: TF32 rounds every entry to +-1."""
    half = np.sign(_randn((n // 2, dx + dy)))
    z = (np.concatenate([half, -half]) * (1 + 2 ** -12)).astype(np.float32)
    return np.ascontiguousarray(z[:, :dx]), np.ascontiguousarray(z[:, dx:])


def test_one_tf32_product_misses_what_tf32_cannot_hold():
    # chip_smoke.py holds the CKA feature route to 1e-5 of float64 on
    # these inputs, to tell 3xTF32 from one TF32 product: 3xTF32 meets
    # that, one product misses even rtol 1e-4 (it is off by
    # 1 - (1 + 2^-12)^-4 ~ 1e-3 in every term)
    x, y = _beyond_tf32(3152, 192, 192)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    want = [np.sum((y64.T @ x64) ** 2), np.sum((x64.T @ x64) ** 2),
            np.sum((y64.T @ y64) ** 2)]
    np.testing.assert_allclose(
        np.asarray(jax_cka_ref.cka_terms_ref(jnp.asarray(x), jnp.asarray(y)),
                   np.float64), want, rtol=1e-5)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    three = _max_rel_err(_cka_terms_tf32(tx, ty, products=3), want)
    single = _max_rel_err(_cka_terms_tf32(tx, ty, products=1), want)
    assert three < 1e-5 < 1e-4 < single


def _plan_terms(x, y, plan):
    """The feature route's arithmetic in plain torch, block by block as
    the kernels walk `plan`: each split's partial tile, the splits summed
    in order, squared, sorted into XX, YY and mixed by column, weighted 2
    off the diagonal, the mixed sum halved."""
    T = cka_ops.TILE
    z = torch.zeros((plan.n, plan.tiles * T))
    z[:, :plan.dx], z[:, plan.dx:plan.dx + plan.dy] = x, y
    col = torch.arange(plan.tiles * T)
    terms = torch.zeros(3, dtype=torch.float64)
    for p in range(plan.pairs):
        i, j = plan.pair(p)
        g = torch.zeros((T, T))
        for s in range(plan.splits):
            r0, r1 = plan.row_range(s)
            g += z[r0:r1, i * T:(i + 1) * T].T @ z[r0:r1, j * T:(j + 1) * T]
        a = col[i * T:(i + 1) * T, None]
        b = col[None, j * T:(j + 1) * T]
        xx = (a < plan.dx) & (b < plan.dx)
        yy = (a >= plan.dx) & (b >= plan.dx)
        weight = 1.0 if i == j else 2.0
        sq = (g * g).double()
        terms += weight * torch.stack([0.5 * sq[~xx & ~yy].sum(),
                                       sq[xx].sum(), sq[yy].sum()])
    return terms


RAGGED = [(3152, 192, 192), (3153, 192, 192), (300, 200, 100),
          (97, 30, 50), (1000, 64, 1), (65, 1, 64)]


def _example_route_gram(x: torch.Tensor, plan) -> torch.Tensor:
    """X X^T as the example route sums it for a one-tile plan (n <= 16):
    each block's features in 32-feature steps, step k to warp k % 8;
    within a step the c-th 3xTF32 m16n8k8 product takes features
    16h + 4t + c (h, t < 2, 4), its three TF32 products (small x big,
    big x small, big x big: exact 8-term sums) summed from zero in fp32
    and added to the warp's fp32 partial; a block adds its warps' partials
    in warp order in fp32; the fold sums the blocks (splits) in double,
    warp w of the fold taking splits w, w + 8, ..., then the 8 sums in
    order. The tensor cores truncate where this rounds to nearest; the
    fresh sum of each product keeps that to one product's 8 features."""
    n, d = x.shape
    R, W = cka_ops.EXAMPLE_ROWS, cka_ops.EXAMPLE_WARPS
    steps = plan.width // cka_ops.EXAMPLE_STEP
    rounds = -(-steps // W)
    rows = torch.zeros((R, plan.splits * plan.width))
    rows[:n, :d] = x
    z = torch.zeros((R, plan.splits, rounds * W * cka_ops.EXAMPLE_STEP))
    z[:, :, :plan.width] = rows.view(R, plan.splits, plan.width)
    # [row, split, round, warp, h, t, c]: step k = round * 8 + warp
    z = z.view(R, plan.splits, rounds, W, 2, 4, 4)
    acc = torch.zeros((plan.splits, W, R, R))
    for r in range(rounds):
        for c in range(4):
            a = z[:, :, r, :, :, :, c].reshape(R, plan.splits, W, 8)
            big = _tf32(a)
            small = _tf32(a - big)
            part = torch.zeros_like(acc)
            for u, v in ((small, big), (big, small), (big, big)):
                prod = torch.einsum("ispk,jspk->spij", u.double(), v.double())
                part = (part.double() + prod).float()
            acc = acc + part
    blocks = acc[:, 0]
    for w in range(1, W):
        blocks = blocks + acc[:, w]
    parts = [blocks[w::8].double().sum(0) if w < plan.splits
             else torch.zeros((R, R), dtype=torch.float64) for w in range(8)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total[:n, :n]


def _terms64(k, l):
    return torch.stack([(k * l).sum(), (k * k).sum(), (l * l).sum()])


def test_example_route_sums_stay_accurate_at_cnn_widths():
    """The example route at ResNet50's widest probe map (n = 16,
    d = 262144): one fp32 chain over d was 1.15e-4 off the plain version
    on the card, past the kernel tolerance. The route's order, each
    3xTF32 product added to a short per-warp fp32 partial and the splits
    folded in double, keeps the terms within 1e-6 of float64."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((16, 262144), generator=gen)
    y = torch.randn((16, 262144), generator=gen) + 0.3 * x
    x, y = x - x.mean(0), y - y.mean(0)
    plan = cka_ops.example_plan(16, 262144, 262144)
    want = _terms64(x.double() @ x.double().T, y.double() @ y.double().T)
    got = _terms64(_example_route_gram(x, plan), _example_route_gram(y, plan))
    assert float(((got - want) / want).abs().max()) < 1e-6


def _center_as_the_kernel(x: torch.Tensor) -> torch.Tensor:
    """The example route's fused centering of n <= 16 rows: a lane g holds
    rows g and g + 8 (zero past n) and adds them, the lanes then add the
    sums of lanes g ^ 4, g ^ 2 and g ^ 1 in turn (shuffles), all in fp32;
    the mean is that sum divided by n, subtracted from the n rows."""
    n, d = x.shape
    rows = torch.zeros((16, d))
    rows[:n] = x
    s = rows[:8] + rows[8:]
    for off in (4, 2, 1):
        s = s + s[torch.arange(8) ^ off]
    assert bool((s == s[0]).all())  # every lane holds the same sum
    return x - s[0] / n


@pytest.mark.parametrize("n", [13, 16])
def test_fused_centering_matches_prepare(n):
    """Raw rows whose columns carry offsets of 1e3 to 2e3: the kernel's
    centering then the plain terms agree with `_prepare` then
    `cka_terms_plain` within the kernel tolerance, and both with float64."""
    gen = torch.Generator().manual_seed(n)
    d = 4096
    offset = 1e3 * (1 + torch.rand(d, generator=gen))
    x = torch.randn((n, d), generator=gen) + offset
    y = torch.randn((n, d), generator=gen) + 0.3 * x
    got = torch.stack(cka_ops.cka_terms_plain(_center_as_the_kernel(x),
                                              _center_as_the_kernel(y)))
    want = torch.stack(cka_ops.cka_terms_plain(cka_ops._prepare(x),
                                               cka_ops._prepare(y)))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    x64, y64 = x.double() - x.double().mean(0), y.double() - y.double().mean(0)
    exact = _terms64(x64 @ x64.T, y64 @ y64.T)
    assert float(((got.double() - exact) / exact).abs().max()) < 1e-4


# every CNN probe map of MobileNetV2 and ResNet50 at 128x128 (d = H*W*C),
# the examples of the DeiT-tiny shape, and ragged and one-sided shapes
EXAMPLE_SHAPES = [(16, d, d) for d in (2560, 4096, 5120, 6144, 8192, 16384,
                                       24576, 32768, 65536, 131072,
                                       262144)] + [
    (1, 300, 300), (13, 1000, 1), (17, 999, 1001), (40, 1000, 300),
    (65, 1, 64), (100, 1000, 1000), (3152, 192, 192)]


@pytest.mark.parametrize("n,dx,dy", EXAMPLE_SHAPES + RAGGED)
def test_example_plan_covers_every_feature_once(n, dx, dy):
    plan = cka_ops.example_plan(n, dx, dy)
    assert (plan.tiles - 1) * cka_ops.EXAMPLE_ROWS < n \
        <= plan.tiles * cka_ops.EXAMPLE_ROWS
    # a split is whole 32-feature steps, so whole 16-byte vectors, and at
    # least one step a warp
    assert plan.width % cka_ops.EXAMPLE_STEP == 0 and plan.width % 4 == 0
    assert plan.width >= cka_ops.EXAMPLE_STEP * cka_ops.EXAMPLE_WARPS
    for d in (dx, dy):
        seen = torch.zeros(d, dtype=torch.int64)
        for s in range(plan.splits):
            lo, hi = plan.feature_range(s, d)
            seen[lo:hi] += 1
        assert bool((seen == 1).all())
    # no split is empty in both X and Y
    assert plan.feature_range(plan.splits - 1, max(dx, dy))[0] < max(dx, dy)
    assert plan.center == (n <= cka_ops.EXAMPLE_ROWS)
    pairs = {plan.pair(p) for p in range(plan.pairs)}
    assert pairs == {(i, j) for i in range(plan.tiles)
                     for j in range(i, plan.tiles)}


def test_example_plan_depends_on_the_shape_only():
    shape = (16, 131072, 131072)
    cached = cka_ops.example_plan(*shape)
    assert cka_ops.example_plan.__wrapped__(*shape) == cached
    assert cka_ops.example_plan.__wrapped__(*shape) is not cached


def test_example_plan_at_the_cnn_probes():
    # MobileNetV2's stem map: ~2 blocks an SM of the H100's 132, within
    # the 2-4 a design around 132 SMs aims at
    stem = cka_ops.example_plan(16, 131072, 131072)
    assert (stem.splits, stem.width, stem.blocks) == (256, 512, 256)
    assert 2 * 132 * 0.9 <= stem.blocks <= 4 * 132
    # fewer splits where the map is small: one step a warp
    small = cka_ops.example_plan(16, 2560, 2560)
    assert (small.splits, small.width) == (10, 256)
    # ResNet50's first stage: twice the features, as many blocks
    assert cka_ops.example_plan(16, 262144, 262144).blocks == stem.blocks


@pytest.mark.parametrize("n,dx,dy", RAGGED)
def test_feature_plan_covers_the_gram_once(n, dx, dy):
    plan = cka_ops.feature_plan(n, dx, dy)
    T, D = cka_ops.TILE, dx + dy
    assert (plan.tiles - 1) * T < D <= plan.tiles * T
    assert plan.rows % cka_ops.SPLIT_ROWS == 0
    # every row in exactly one split, the last split non-empty
    rows = torch.zeros(n, dtype=torch.int64)
    for s in range(plan.splits):
        r0, r1 = plan.row_range(s)
        assert r0 < r1
        rows[r0:r1] += 1
    assert bool((rows == 1).all())
    # every entry of G once: a block's tile directly, an off-diagonal
    # tile's mirror through its weight of 2
    seen = torch.zeros((plan.tiles * T,) * 2, dtype=torch.int64)
    pairs = [plan.pair(p) for p in range(plan.pairs)]
    assert len(set(pairs)) == plan.pairs and all(i <= j for i, j in pairs)
    for i, j in pairs:
        seen[i * T:(i + 1) * T, j * T:(j + 1) * T] += 1
        if i != j:
            seen[j * T:(j + 1) * T, i * T:(i + 1) * T] += 1
    assert bool((seen == 1).all())


def test_feature_plan_at_the_main_probe():
    plan = cka_ops.feature_plan(3152, 192, 192)
    assert (plan.tiles, plan.pairs, plan.splits, plan.rows) == (6, 21, 25, 128)
    assert plan.row_range(plan.splits - 1) == (3072, 3152)


@pytest.mark.parametrize("n,dx,dy", RAGGED[1:4])
def test_plan_evaluation_matches_jax_cka_terms(n, dx, dy):
    x, y = _cka_inputs(n, dx, dy)
    want = jax_cka_ref.cka_terms_ref(jnp.asarray(x), jnp.asarray(y))
    got = _plan_terms(torch.from_numpy(x), torch.from_numpy(y),
                      cka_ops.feature_plan(n, dx, dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=1e-4)


@pytest.mark.parametrize("shape,feature", [((3152, 192, 192), True),
                                           ((100, 1000, 1000), False),
                                           ((384, 192, 192), True),
                                           ((383, 192, 192), False),
                                           ((192, 192, 192), False)])
def test_cka_route_rule(shape, feature):
    n, dx, dy = shape
    assert cka_ops.feature_route(n, dx, dy) is feature
    # the rule is the one that does less work
    assert feature == (n * (dx + dy) * (dx + dy + 1)
                       <= n * (n + 1) * (dx + dy))


def test_accumulator_reused_as_a_operand_with_permuted_keys():
    """flash_attention.cu takes P for O += P V straight from the S
    accumulator registers (a = c0, c2, c1, c3) and reads V's rows in the
    order tf32x3::acc_key gives. One warp's m16n8k8 simulated from the
    PTX fragment tables (the comments in tf32x3.cuh) must give P V."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    a_at = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
    b_at = [(t, g), (t + 4, g)]
    c_at = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]

    def acc_key(k):
        return np.where(k < 4, 2 * k, 2 * (k - 4) + 1)

    P, V = _randn((16, 8)), _randn((8, 8))
    c = [P[r, col] for r, col in c_at]       # P as an accumulator tile
    a = [c[0], c[2], c[1], c[3]]              # reused as A, no shuffle
    b = [V[acc_key(k), col] for k, col in b_at]
    A, B = np.zeros((16, 8), np.float32), np.zeros((8, 8), np.float32)
    for reg, (r, col) in zip(a, a_at):
        A[r, col] = reg
    for reg, (k, col) in zip(b, b_at):
        B[k, col] = reg
    np.testing.assert_allclose(A @ B, P @ V, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the wrappers are forward-only


def _wrapper_calls(requires_grad):
    t = lambda *shape: torch.randn(*shape, requires_grad=requires_grad)
    q = t(2, 9, 2, 16)
    x, y = t(12, 5), t(12, 3)
    r, k, v = t(1, 6, 2, 16), t(1, 6, 2, 16), t(1, 6, 2, 16)
    logw = -torch.rand(1, 6, 2, 16, requires_grad=requires_grad)
    return {"flash_attention": lambda: att_ops.flash_attention(q, q, q),
            "cka_terms": lambda: cka_ops.cka_terms(x, y),
            "wkv": lambda: wkv_ops.wkv(r, k, v, logw, t(2, 16))}


@pytest.mark.parametrize("name", ["flash_attention", "cka_terms", "wkv"])
def test_wrappers_refuse_inputs_that_require_grad(name):
    # on the card the kernel's output would carry no grad_fn and the
    # gradient would be dropped; the CPU route refuses the same call
    with pytest.raises(RuntimeError, match="forward-only"):
        _wrapper_calls(True)[name]()
    with torch.no_grad():
        _wrapper_calls(True)[name]()
    with torch.inference_mode():
        _wrapper_calls(True)[name]()
    out = _wrapper_calls(False)[name]()
    assert not any(o.requires_grad for o in
                   (out if isinstance(out, tuple) else (out,)))
