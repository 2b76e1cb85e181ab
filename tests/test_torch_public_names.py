"""Names of ``hyres_tpu`` that the port carries for its library users,
each against JAX's on seeded numpy inputs (CPU):

- ``coding.RansEncoder`` bytes identical to JAX's, decoded through both
  packages' ``RansDecoder.decode_with_indexes``;
- ``entropy.quantize_ste``, ``quantize_symbols`` and ``dequantize`` exact;
  ``quantize_noise`` within [-0.5, 0.5) of x (its draws come from a
  ``torch.Generator``, JAX's from ``jax.random``: other noise for a seed);
- ``nn.quantize`` in its three modes;
- ``train.quantile_mask`` equal to JAX's mask leaf for leaf through
  ``utils/convert.py to_flax`` names;
- ``jpeg.core.dct_matrix`` within 1e-7, and the factor of ``KRON``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyres_tpu.coding as jcoding
import hyres_tpu.entropy as jentropy
import hyres_tpu.nn as jnn
from hyres_tpu.jpeg import core as jcore
from hyres_tpu.train import quantile_mask as jax_quantile_mask
from hyres_tpu_torch import coding, entropy
from hyres_tpu_torch import nn as tnn
from hyres_tpu_torch.jpeg import core
from hyres_tpu_torch.kernels import dct
from hyres_tpu_torch.models.checkerboard import LightWeightCheckerboard
from hyres_tpu_torch.models.elic import LightWeightELIC
from hyres_tpu_torch.train import quantile_mask
from hyres_tpu_torch.utils.convert import to_flax


@pytest.fixture(scope="module")
def gauss_tables():
    return entropy.build_gaussian_tables(entropy.get_scale_table())


@pytest.mark.parametrize("n", [1, 1000, 50000])
def test_rans_encoder_bytes_and_cross_decode(gauss_tables, n):
    t = gauss_tables
    rng = np.random.default_rng(n)
    idx = rng.integers(0, 64, n).astype(np.int32)
    sym = np.round(rng.normal(0, entropy.get_scale_table()[idx])).astype(np.int32)
    sym[: min(n, 2)] = 9000  # out of support: the bypass escape
    args = (idx, t.quantized_cdf, t.cdf_length, t.offset)
    ours = coding.RansEncoder().encode_with_indexes(sym, *args)
    theirs = jcoding.RansEncoder().encode_with_indexes(sym, *args)
    assert ours == theirs
    np.testing.assert_array_equal(coding.RansDecoder().decode_with_indexes(theirs, *args), sym)
    np.testing.assert_array_equal(jcoding.RansDecoder().decode_with_indexes(ours, *args), sym)


def test_quantize_helpers_equal_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 4, (2, 5, 6, 3)) + 0.5 * rng.integers(0, 2, (2, 5, 6, 3))).astype(
        np.float32)  # many exact .5 ties
    means = rng.normal(0, 1, x.shape).astype(np.float32)
    tx, tm = torch.from_numpy(x), torch.from_numpy(means)
    for got, want in (
            (entropy.quantize_ste(tx), jentropy.quantize_ste(x)),
            (entropy.quantize_symbols(tx), jentropy.quantize_symbols(x)),
            (entropy.quantize_symbols(tx, tm), jentropy.quantize_symbols(x, means)),
            (entropy.dequantize(entropy.quantize_symbols(tx)),
             jentropy.dequantize(jentropy.quantize_symbols(x))),
            (entropy.dequantize(entropy.quantize_symbols(tx, tm), tm),
             jentropy.dequantize(jentropy.quantize_symbols(x, means), means)),
            (entropy.dequantize(entropy.quantize_symbols(tx), dtype=torch.bfloat16).float(),
             jentropy.dequantize(jentropy.quantize_symbols(x), dtype=jnp.bfloat16)
             .astype(jnp.float32))):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_ste_gradient_is_identity():
    x = torch.linspace(-3, 3, 13, requires_grad=True)
    entropy.quantize_ste(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(13, np.float32))
    g = jax.grad(lambda v: jentropy.quantize_ste(v).sum())(jnp.linspace(-3, 3, 13))
    np.testing.assert_array_equal(np.asarray(g), x.grad.numpy())


def test_quantize_noise_draws_from_the_generator():
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 3, (4, 8, 8)).astype(np.float32))
    a = entropy.quantize_noise(x, torch.Generator().manual_seed(7))
    b = entropy.quantize_noise(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.dtype == x.dtype
    d = (a - x).numpy()
    assert d.min() >= -0.5 and d.max() < 0.5 and d.std() > 0.2
    j = np.asarray(jentropy.quantize_noise(jnp.asarray(x.numpy()), jax.random.key(7)))
    dj = j - x.numpy()
    assert dj.min() >= -0.5 and dj.max() < 0.5


def test_nn_quantize_modes_equal_jax():
    x = np.random.default_rng(5).normal(0, 2, (3, 7)).astype(np.float32)
    noise = np.random.default_rng(6).uniform(-0.5, 0.5, x.shape).astype(np.float32)
    tx = torch.from_numpy(x)
    assert torch.equal(tnn.quantize(tx, "noise", torch.from_numpy(noise)),
                       torch.from_numpy(x + noise))
    for mode in ("ste", "round"):
        np.testing.assert_array_equal(tnn.quantize(tx, mode).numpy(),
                                      np.asarray(jnn.quantize(jnp.asarray(x), mode)))


@pytest.mark.parametrize("family", ["checkerboard", "elic"])
def test_quantile_mask_equals_jax_leaf_for_leaf(family):
    torch.manual_seed(0)
    model = (LightWeightCheckerboard(8, 12) if family == "checkerboard"
             else LightWeightELIC(N=16, M=24, groups=(4, 4, 8, 8)))
    mask = quantile_mask(model)
    assert mask.keys() == dict(model.named_parameters()).keys() and any(mask.values())
    # each parameter as a constant tensor of its mask bit, in flax's layout
    tree = to_flax({k: torch.full_like(p, float(mask[k])) for k, p in model.named_parameters()})
    got = jax.tree.map(lambda a: bool(np.all(a == 1.0)), tree)
    assert jax_quantile_mask(tree) == got


def test_dct_matrix_equals_jax_and_factors_kron():
    d = core.dct_matrix()
    assert d.dtype == torch.float32 and d.shape == (8, 8)
    np.testing.assert_allclose(d.numpy(), np.asarray(jcore.dct_matrix()), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(np.kron(dct.dct8(), dct.dct8()).astype(np.float32), dct.KRON)
    np.testing.assert_array_equal(core.dct_matrix(torch.float64).numpy(), dct.dct8())
