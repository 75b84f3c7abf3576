"""The port's kernel modules on the CPU against the JAX package: the plain
versions that `flash_attention` and `cka_terms` take for CPU tensors, held
against the Pallas kernels (interpret mode) and their `ref.py` oracles on
the same numpy inputs, plus the wrappers' input checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cka import cka as jax_cka
from repro.kernels.attention import ops as jax_att_ops
from repro.kernels.attention import ref as jax_att_ref
from repro.kernels.cka import ops as jax_cka_ops
from repro_torch.core.cka import cka
from repro_torch.kernels.attention import ops as att_ops
from repro_torch.kernels.cka import ops as cka_ops

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
