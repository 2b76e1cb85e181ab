"""Port's DCT kernels K1/K2 (hyres_tpu_torch.kernels.dct) vs the JAX reference.

On the CPU the wrappers take their plain PyTorch versions; those are held
against the Pallas kernels (interpret mode) and the XLA path of
hyres_tpu.jpeg.core. Bars, as tests/test_kernels.py:27-31,43: K1 at most
0.1% of coefficients off by one and none by more (the quantizer's .5 ties
move with summation order); K2 atol 1e-2 on the [0, 255] scale. The
kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.jpeg import core as jcore
from hyres_tpu.jpeg import tables as jtables
from hyres_tpu.kernels import dct as jdct
from hyres_tpu_torch.kernels import dct

N_BLOCKS = [1, 513, 700]  # ragged: no multiple of any tile


def _assert_k1_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    mismatch = int(np.sum(got != want))
    assert mismatch <= 0.001 * got.size, f"{mismatch} coefficients differ"
    assert np.max(np.abs(got.astype(np.int64) - want)) <= 1


def _blocks(rng, n):
    return (rng.random((n, 64)) * 255).astype(np.float32)


@pytest.mark.parametrize("quality", [1, 50])
@pytest.mark.parametrize("n", N_BLOCKS)
def test_fdct_ref_matches_pallas_and_xla(rng_np, n, quality):
    qy, _ = jtables.quality_to_qtables(quality)
    blocks = _blocks(rng_np, n)
    got = dct.fdct_quant_blocks_ref(torch.from_numpy(blocks), torch.from_numpy(qy))
    pallas = jdct.fdct_quant_blocks(jnp.asarray(blocks), jnp.asarray(qy),
                                    interpret=True)
    _assert_k1_close(got.numpy(), pallas)
    # XLA path on a (1, 8, 8n) plane of the same blocks
    plane = blocks.reshape(1, n, 8, 8).transpose(0, 2, 1, 3).reshape(1, 8, 8 * n)
    xla = np.asarray(jcore.fdct_quant(jnp.asarray(plane), jnp.asarray(qy)))
    _assert_k1_close(got.numpy(), xla.reshape(n, 64))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n", N_BLOCKS)
def test_idct_ref_matches_pallas_and_xla(rng_np, n):
    qy, _ = jtables.quality_to_qtables(50)
    coef = rng_np.integers(-40, 40, (n, 64)).astype(np.int32)
    got = dct.dequant_idct_blocks_ref(torch.from_numpy(coef),
                                      torch.from_numpy(qy)).numpy()
    pallas = np.asarray(jdct.dequant_idct_blocks(jnp.asarray(coef), jnp.asarray(qy),
                                                 interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-2)
    xla = np.asarray(jcore.dequant_idct(jnp.asarray(coef.reshape(1, 1, n, 8, 8)),
                                        jnp.asarray(qy)))
    want = xla.reshape(8, n, 8).transpose(1, 0, 2).reshape(n, 64)
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_cpu_wrappers_take_the_plain_version(rng_np):
    qy, _ = jtables.quality_to_qtables(50)
    blocks = torch.from_numpy(_blocks(rng_np, 64))
    q = torch.from_numpy(qy)
    before = dict(dct.LAUNCHES)
    coef = dct.fdct_quant_blocks(blocks, q)
    assert torch.equal(coef, dct.fdct_quant_blocks_ref(blocks, q))
    pix = dct.dequant_idct_blocks(coef, q)
    assert torch.equal(pix, dct.dequant_idct_blocks_ref(coef, q))
    assert dct.LAUNCHES == before  # plain versions never count as launches


def test_non_cpu_tensor_never_falls_back(rng_np):
    """A tensor that is not on the CPU reaches the kernel path, which
    rejects what it cannot launch on; there is no silent plain fallback."""
    blocks = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dct.fdct_quant_blocks(blocks, torch.ones(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        dct.dequant_idct_blocks(torch.empty((8, 64), dtype=torch.int32,
                                            device="meta"),
                                torch.ones(64, device="meta"))


def test_roundtrip_near_lossless(rng_np):
    q = torch.ones(64, dtype=torch.int32)
    blocks = torch.from_numpy(_blocks(rng_np, 260))
    rec = dct.dequant_idct_blocks(dct.fdct_quant_blocks(blocks, q), q)
    assert float((rec - blocks).abs().max()) < 2.0


# -- plane calls: every plane of a request in one call ----------------------

PLANE_SETS = [[(1, 8, 8)], [(2, 40, 56), (2, 24, 16), (1, 8, 72)],
              [(2, 40, 56), (0, 16, 16), (1, 8, 8)]]


@pytest.mark.parametrize("shapes", PLANE_SETS)
def test_plane_wrappers_equal_block_wrappers(rng_np, shapes):
    """The plane calls give what the (N, 64) calls give on the same
    blocks, K2 from int8, int16 and int32, each plane with its own table
    (host numpy, CPU tensor or sequence)."""
    qy, qc = jtables.quality_to_qtables(50)
    qts = [qy, torch.from_numpy(qc), list(qc)][:len(shapes)]
    planes = [torch.from_numpy(np.round(rng_np.random(s) * 255).astype(np.float32))
              for s in shapes]
    before = dict(dct.LAUNCHES)
    got = dct.fdct_quant_planes(planes, qts)
    for p, q, g in zip(planes, qts, got):
        B, H, W = p.shape
        assert g.dtype == torch.int32 and g.shape == (B, H // 8, W // 8, 8, 8)
        want = dct.fdct_quant_blocks(dct.blockify(p).reshape(-1, 64), torch.as_tensor(q))
        assert torch.equal(g.reshape(-1, 64), want)
    for dt in (torch.int8, torch.int16, torch.int32):
        coefs = [g.to(dt) for g in got]
        for c, q, x in zip(coefs, qts, dct.dequant_idct_planes(coefs, qts)):
            assert x.dtype == torch.float32 and x.shape == (c.shape[0], 8 * c.shape[1],
                                                            8 * c.shape[2])
            want = dct.dequant_idct_blocks(c.reshape(-1, 64), torch.as_tensor(q))
            assert torch.equal(dct.blockify(x).reshape(-1, 64), want)
    assert dct.LAUNCHES == before


def test_meta_plane_and_meta_table_raise():
    """A plane that is neither on the CPU nor on a card, and a quant table
    that is not a host value, raise ValueError: no plain fallback for the
    one, no upload for the other."""
    q = jtables.quality_to_qtables(50)[0]
    with pytest.raises(ValueError, match="CUDA"):
        dct.fdct_quant_planes([torch.empty((1, 8, 8), device="meta")], [q])
    with pytest.raises(ValueError, match="CUDA"):
        dct.dequant_idct_planes([torch.empty((1, 1, 1, 8, 8), dtype=torch.int8,
                                             device="meta")], [q])
    meta_q = torch.ones(64, device="meta")
    plane = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="host"):
        dct.fdct_quant_planes([plane], [meta_q])
    with pytest.raises(ValueError, match="host"):
        dct.dequant_idct_planes([torch.zeros((1, 1, 1, 8, 8), dtype=torch.int8)], [meta_q])
    with pytest.raises(ValueError, match="host"):
        dct.fdct_quant_blocks(plane.reshape(1, 64), meta_q)
    with pytest.raises(ValueError, match="quant tables"):
        dct.fdct_quant_planes([plane, plane], [q])
