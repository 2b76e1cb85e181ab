"""The port's training path (hyres_tpu_torch) against hyres_tpu on the CPU.

Small size: N=8, M=12, 64x64 crops, batch 2. Parameters are the port's
own initialisation, jittered, carried to JAX with ``to_flax``; every
noise draw is JAX's, fed to the port through its one noise function
``nn/quantizer.py uniform_noise``.

Bars: ``lower_bound`` exact; ``gaussian_likelihood`` and its gradients
within 1e-6 of each tensor's max magnitude; the bottleneck rel 1e-5; the exact JPEG scan bits and bpp
equal, the JPEG decode within 1e-2/255 (summation order of the IDCT, as
tests/test_torch_jpeg.py); model losses rel 1e-5 (checkerboard) and
1e-4 (HyRES, whose residual carries the JPEG decode's 1e-2/255); every
gradient leaf, in noise and STE mode, within 1e-3 of the leaf's max |g|; one full train step's
updates within 1% of the learning rate where JAX's clipped gradient is
at least 1e-6, or 1e-3 of the leaf's largest where that is less (Adam's
first step divides it by |g| + eps; each leaf keeps its largest
elements, and the excluded count of each leaf is printed). Port-only properties
(accumulation, remat, optimizer partition) hold to 1e-5 or exactly. The
optimizer tail on flat buffers equals a per-leaf copy of it bit for bit
without the clip, and with it (whose norm sums in another order) within
the bars above: 1% of the learning rate, 1e-3 of a leaf's largest moment.
"""

import contextlib
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu import entropy as jent
from hyres_tpu import jpeg as jjpeg
from hyres_tpu.entropy.bound import lower_bound as jlower_bound
from hyres_tpu.losses import rate_distortion_loss as jrd_loss
from hyres_tpu.models.checkerboard import LightWeightCheckerboard as JCheckerboard
from hyres_tpu.models.hyres import ResidualJPEGCompression as JHyres
from hyres_tpu.nn import layers as jl
from hyres_tpu.train import configure_optimizers as jconfigure
from hyres_tpu.train import create_train_state as jcreate
from hyres_tpu.train import make_train_step as jmake_train_step
from hyres_tpu_torch import entropy as tent
from hyres_tpu_torch import jpeg as tjpeg
from hyres_tpu_torch.entropy.bound import lower_bound
from hyres_tpu_torch.losses import rate_distortion_loss
from hyres_tpu_torch.models.checkerboard import LightWeightCheckerboard
from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
from hyres_tpu_torch.nn import init_parameters, quantizer
from hyres_tpu_torch.train import (configure_optimizers, create_train_state, get_main_lr,
                                   load_checkpoint, make_train_step, restore_train_state,
                                   save_checkpoint, set_main_lr, train_checkpoint)
from hyres_tpu_torch.train import engine as tengine
from hyres_tpu_torch.train.optimizers import OPTIM_STATS
from hyres_tpu_torch.utils.convert import from_flax, to_flax
from hyres_tpu_torch.utils.png import load_image

N, M, B, S = 8, 12, 2, 64
LMBDA = 0.015
IMAGE = (Path(__file__).resolve().parent.parent / "matched_r5" / "hyres_found"
         / "best_images" / "0_original.png")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's small models, so that it
    does not crowd the other test workers' cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- helpers -----------------------------------------------------------------


def _port_params(seed: int = 0) -> dict:
    """The port's own initialisation of the HyRES model, jittered so that
    biases, GDN and PReLU leave their symmetric initial values, as a flax
    params tree."""
    model = ResidualJPEGCompression(N, M, 1)
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: p + rng.normal(0, 0.02, p.shape).astype(np.float32),
                        to_flax(model))


def _hyres(params) -> ResidualJPEGCompression:
    m = ResidualJPEGCompression(N, M, 1)
    m.load_state_dict(from_flax(params))
    return m


def _checkerboard(params) -> LightWeightCheckerboard:
    m = LightWeightCheckerboard(N, M)
    m.load_state_dict(from_flax(params))
    return m


def _jax_draws(rng, z_shape, y_shape, noisequant: bool) -> list:
    """The draws of the reference's forward for one key, in the port's
    draw order: z's (C, 1, B*H*W) noise, then y's anchor and non-anchor."""
    rz, ra, rn = jax.random.split(rng, 3)
    B_, h, w, C = z_shape
    draws = [jax.random.uniform(rz, (C, 1, B_ * h * w), jnp.float32, -0.5, 0.5)]
    if noisequant:
        draws += [jax.random.uniform(r, y_shape, jnp.float32, -0.5, 0.5) for r in (ra, rn)]
    return [np.asarray(d) for d in draws]


@pytest.fixture
def feed_noise(monkeypatch):
    """Replace the port's noise function with a queue of given draws."""
    def feed(draws):
        queue = list(draws)

        def uniform_noise(shape, generator, device):
            d = queue.pop(0)
            assert tuple(d.shape) == tuple(shape)
            return torch.from_numpy(np.array(d)).to(device)

        monkeypatch.setattr(quantizer, "uniform_noise", uniform_noise)
        return queue
    return feed


def _grads(model) -> dict:
    return to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                    for k, p in model.named_parameters()})


def _assert_grads_close(got: dict, want, bar: float = 1e-3) -> None:
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(leaves) == len(jax.tree.leaves(got))
    for path, w in leaves:
        node = got
        for k in path:
            node = node[k.key]
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(node - w).max())
        name = "/".join(k.key for k in path)
        assert err <= bar * scale, f"{name}: max err {err} against max |g| {scale}"


@pytest.fixture(scope="module")
def params():
    return _port_params()


@pytest.fixture(scope="module")
def batch():
    crop = load_image(IMAGE)[:, 200:200 + S, 300:300 + S]
    rng = np.random.default_rng(3)
    noisy = np.clip(crop + 0.1 * rng.standard_normal(crop.shape), 0, 1)
    return np.concatenate([crop, noisy]).astype(np.float32)


# -- entropy pieces -----------------------------------------------------------


def test_lower_bound_forward_and_gradient_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 1000).astype(np.float32)
    g = rng.normal(0, 1, 1000).astype(np.float32)
    x[:10] = 0.25  # at the bound: passes
    for bound in (0.25, np.float32(-0.1)):
        jy, vjp = jax.vjp(lambda a: jlower_bound(a, bound), jnp.asarray(x))
        (jg,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        y = lower_bound(xt, bound if isinstance(bound, float) else torch.tensor(bound))
        y.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
        blocked = (x < float(bound)) & (g > 0)
        assert blocked.any() and (~blocked & (x < float(bound))).any()
    with torch.no_grad():  # serving: no graph
        assert lower_bound(torch.from_numpy(x), 0.25).grad_fn is None


def test_gaussian_likelihood_and_gradients_equal_jax():
    rng = np.random.default_rng(1)
    shape = (2, 6, 6, 12)
    x = rng.normal(0, 3, shape).astype(np.float32)
    scales = np.abs(rng.normal(0, 2, shape)).astype(np.float32)
    scales[0, 0] = 0.05  # under the scale bound
    means = rng.normal(0, 1, shape).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    jy, vjp = jax.vjp(jent.gaussian_likelihood, *(jnp.asarray(a) for a in (x, scales, means)))
    jgrads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scales, means)]
    y = tent.gaussian_likelihood(*ts)
    y.backward(torch.from_numpy(g))
    # rel 1e-6 of each tensor's largest magnitude (erfc is a polynomial
    # of another order in each framework)
    for got, want in [(y.detach(), jy)] + [(t.grad, jgr) for t, jgr in zip(ts, jgrads)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_array_equal(y.detach().numpy() == 1e-9 * np.float32(1),
                                  np.asarray(jy) == np.float32(1e-9))


@pytest.mark.parametrize("noise", [True, False])
def test_entropy_bottleneck_forward_equals_jax(params, feed_noise, noise):
    eb_p = params["residual_model"]["entropy_bottleneck"]
    z = np.random.default_rng(2).normal(0, 4, (B, 2, 2, N)).astype(np.float32)
    key = jax.random.key(9)
    jeb = jent.EntropyBottleneck(N)
    jz, jlik = jeb.apply({"params": eb_p}, jnp.asarray(z), noise=noise, rng=key)
    eb = tent.EntropyBottleneck(N)
    eb.load_state_dict(from_flax(eb_p))
    feed_noise([np.asarray(jax.random.uniform(key, (N, 1, B * 4), jnp.float32, -0.5, 0.5))])
    tz, tlik = eb(torch.from_numpy(z), noise=noise, generator=torch.Generator())
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlik.detach().numpy(), np.asarray(jlik), rtol=1e-5, atol=1e-9)


def test_entropy_bottleneck_aux_loss_reaches_quantiles_only(params):
    eb_p = params["residual_model"]["entropy_bottleneck"]
    jeb = jent.EntropyBottleneck(N)
    jval, jg = jax.value_and_grad(
        lambda p: jeb.apply({"params": p}, method=jeb.aux_loss))(eb_p)
    eb = tent.EntropyBottleneck(N)
    eb.load_state_dict(from_flax(eb_p))
    val = eb.aux_loss()
    val.backward()
    assert float(val) == pytest.approx(float(jval), rel=1e-5)
    for name, p in eb.named_parameters():
        if name == "quantiles":
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg["quantiles"]),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert p.grad is None, name


# -- exact JPEG rate ------------------------------------------------------------


def _rate_images():
    rng = np.random.default_rng(4)
    img = load_image(IMAGE)
    return {"noise": rng.random((2, 48, 40, 3)).astype(np.float32),
            "crops": np.concatenate([img[:, 100:228, 50:178], img[:, 300:428, 300:428]])}


@pytest.fixture
def jax_tpu_jpeg(monkeypatch):
    """The reference's JPEG path as it runs on the TPU: its Pallas K1/K2
    (``hyres_tpu/kernels/dct.py``), here in interpret mode, as
    tests/test_kernels.py runs them. (Its CPU path divides by q where the
    kernel multiplies by 1/q, so the two can round a .5 tie apart.)"""
    import functools

    from hyres_tpu.kernels import dct as jdct

    monkeypatch.setenv("HYRES_DCT_KERNEL", "pallas")
    for name in ("fdct_quant_blocks", "dequant_idct_blocks"):
        monkeypatch.setattr(jdct, name, functools.partial(getattr(jdct, name), interpret=True))

    def run(fn, *args):
        with jax.disable_jit():  # no trace of the CPU path is reused
            return fn(*args)
    return run


@pytest.mark.parametrize("quality", [1, 50, 90])
@pytest.mark.parametrize("which", ["noise", "crops"])
def test_scan_bits_equal_jax(jax_tpu_jpeg, which, quality):
    x = _rate_images()[which]
    want = jax_tpu_jpeg(jjpeg.encode_to_coefficients, jnp.asarray(x), quality)
    got = tjpeg.encode_to_coefficients(torch.from_numpy(x), quality)
    for g, w in zip((got.y, got.cb, got.cr), (want.y, want.cb, want.cr)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tjpeg.scan_bits(got).numpy(), np.asarray(want.scan_bits))


@pytest.mark.parametrize("quality", [1, 50, 90])
def test_scan_bits_of_jax_cpu_coefficients_equal_jax(quality):
    """The rate alone, on the coefficients of the reference's CPU path."""
    x = _rate_images()["crops"]
    want = jjpeg.encode_to_coefficients(jnp.asarray(x), quality)
    same = tjpeg.JpegCoefficients(*(torch.from_numpy(np.asarray(p))
                                    for p in (want.y, want.cb, want.cr)), x.shape[1], x.shape[2])
    np.testing.assert_array_equal(tjpeg.scan_bits(same).numpy(), np.asarray(want.scan_bits))


@pytest.mark.parametrize("quality", [1, 50])
def test_jpeg_roundtrip_equals_jax(jax_tpu_jpeg, quality):
    x = _rate_images()["crops"]
    jdec, jbpp = jax_tpu_jpeg(jjpeg.jpeg_roundtrip, jnp.asarray(x), quality)
    xt = torch.from_numpy(x).requires_grad_()
    dec, bpp = tjpeg.jpeg_roundtrip(xt, quality)
    assert not dec.requires_grad
    np.testing.assert_array_equal(bpp.numpy(), np.asarray(jbpp))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-2 / 255)


# -- model forwards and gradients ----------------------------------------------


def _jax_checkerboard_grad(params, residual, noisequant, key):
    jm = JCheckerboard(N, M)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(residual), noisequant=noisequant, rng=key)
        return jrd_loss(out, jnp.asarray(residual), LMBDA, 0.0)["loss"]

    return jax.jit(jax.value_and_grad(loss))(params)


@pytest.mark.parametrize("noisequant", [True, False])
def test_checkerboard_loss_and_gradients_equal_jax(params, batch, feed_noise, noisequant):
    """On a shared residual (the JAX JPEG decode of the batch)."""
    jdec, _ = jjpeg.jpeg_roundtrip(jnp.asarray(batch), 1)
    residual = batch - np.asarray(jdec)
    cb_p = params["residual_model"]
    key = jax.random.key(11)
    jval, jg = _jax_checkerboard_grad(cb_p, residual, noisequant, key)
    model = _checkerboard(cb_p)
    y_shape, z_shape = model.latent_shapes(residual.shape)
    feed_noise(_jax_draws(key, z_shape, y_shape, noisequant))
    r = torch.from_numpy(residual)
    out = model(r, noisequant=noisequant, generator=torch.Generator())
    loss = rate_distortion_loss(out, r, LMBDA, 0.0)["loss"]
    loss.backward()
    assert float(loss) == pytest.approx(float(jval), rel=1e-5)
    _assert_grads_close(_grads(model), jg)


def _hyres_loss_and_gradients(params, batch, feed_noise, noisequant, key):
    """The port's and the reference's HyRES loss and gradients, on the same
    parameters, batch and draws."""
    jm = JHyres(N, M, 1)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(batch), noisequant=noisequant, rng=key)
        return jrd_loss(out, jnp.asarray(batch), LMBDA, 0.0)["loss"]

    jval, jg = jax.jit(jax.value_and_grad(loss))(params)
    model = _hyres(params)
    y_shape, z_shape = model.residual_model.latent_shapes(batch.shape)
    feed_noise(_jax_draws(key, z_shape, y_shape, noisequant))
    x = torch.from_numpy(batch)
    out = model(x, noisequant=noisequant, generator=torch.Generator())
    d = rate_distortion_loss(out, x, LMBDA, 0.0)
    d["loss"].backward()
    assert set(out) == {"x_hat", "likelihoods", "jpeg_bpp_loss", "jpeg_decoded",
                        "residual", "residual_hat"}
    assert float(d["loss"]) == pytest.approx(float(jval), rel=1e-4)
    _assert_grads_close(_grads(model), jg)


def test_hyres_loss_and_gradients_equal_jax(params, batch, feed_noise):
    """Noise mode, the recipe's first phase."""
    _hyres_loss_and_gradients(params, batch, feed_noise, True, jax.random.key(12))


def test_hyres_ste_loss_and_gradients_equal_jax(params, batch, feed_noise):
    """STE mode: every ``--pretrained`` run, and the recipe after
    ``--noise-epochs``. z's noise is still drawn (and discarded)."""
    _hyres_loss_and_gradients(params, batch, feed_noise, False, jax.random.key(13))


def test_hyres_ste_forward_equals_jax(params, batch, feed_noise):
    jm = JHyres(N, M, 1)
    key = jax.random.key(13)
    jout = jax.jit(lambda p, x: jm.apply({"params": p}, x, noisequant=False, rng=key))(
        params, jnp.asarray(batch))
    jd = jrd_loss(jout, jnp.asarray(batch), LMBDA, 0.0)
    model = _hyres(params)
    y_shape, z_shape = model.residual_model.latent_shapes(batch.shape)
    feed_noise(_jax_draws(key, z_shape, y_shape, False))
    with torch.no_grad():
        out = model(torch.from_numpy(batch), noisequant=False, generator=torch.Generator())
        d = rate_distortion_loss(out, torch.from_numpy(batch), LMBDA, 0.0)
    for k in jd:
        assert float(d[k]) == pytest.approx(float(jd[k]), rel=1e-4, abs=1e-6), k
    assert float(d["jpeg_bpp_loss"]) == float(jd["jpeg_bpp_loss"])
    for k in ("x_hat", "residual_hat"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-4)


# -- the train step --------------------------------------------------------------


def _state(params, lr=1e-4, aux_lr=1e-3, clip=1.0):
    model = _hyres(params)
    main, aux = configure_optimizers(model, lr, aux_lr, clip)
    return create_train_state(model, main, aux)


def test_train_step_equals_jax(params, batch, feed_noise):
    jm = JHyres(N, M, 1)
    jparams = {"params": params}
    main_tx, aux_tx = jconfigure(jparams, 1e-4, 1e-3, 1.0)
    key = jax.random.key(14)
    jstate, jmet = jmake_train_step(jm, main_tx, aux_tx, lmbda=LMBDA)(
        jcreate(jparams, main_tx, aux_tx), jnp.asarray(batch), key, True)

    def loss(p):
        out = jm.apply(p, jnp.asarray(batch), noisequant=True, rng=key)
        return jrd_loss(out, jnp.asarray(batch), LMBDA, 0.0)["loss"]

    jg = jax.jit(jax.grad(loss))(jparams)["params"]
    # Adam divides the clipped gradient by its magnitude + eps
    main = [g for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]
            if path[-1].key != "quantiles"]
    clip = min(1.0, 1.0 / float(np.sqrt(sum(np.sum(np.square(g)) for g in main))))
    state = _state(params)
    y_shape, z_shape = state.model.residual_model.latent_shapes(batch.shape)
    feed_noise(_jax_draws(key, z_shape, y_shape, True))
    met = make_train_step(state, LMBDA)(torch.from_numpy(batch), torch.Generator(), True)
    for k in ("loss", "bpp_loss", "aux_loss", "skipped_nonfinite"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-4, abs=1e-7), k
    got = to_flax(state.model)
    excluded = {}
    for (path, p0), (_, p1), (_, g) in zip(
            *(jax.tree_util.tree_flatten_with_path(t)[0]
              for t in (params, jstate.params["params"], jg))):
        node = got
        for k in path:
            node = node[k.key]
        quantiles = path[-1].key == "quantiles"
        lr = 1e-3 if quantiles else 1e-4
        cg = clip * np.abs(np.asarray(g))
        keep = (np.ones(np.shape(p0), bool) if quantiles
                else cg >= min(1e-6, 1e-3 * float(cg.max())))
        name = "/".join(k.key for k in path)
        excluded[name] = (int(keep.size - keep.sum()), int(keep.size))
        assert keep.any(), f"{name}: every element's gradient is zero"  # never unchecked
        err = np.abs((node - p0) - (np.asarray(p1) - p0))[keep]
        assert err.max() <= 0.01 * lr, f"{name}: {err.max() / lr} of lr"
    print("elements excluded / size:", {k: v for k, v in excluded.items() if v[0]})
    assert state.step == 1


def test_accumulation_and_remat_equal_the_plain_step(params, batch, feed_noise):
    """Noise mode. Two micro-batches of 1 against one batch of 2, each
    micro-batch drawing its own share of the same noise; and a
    rematerialised step against a plain one with the same draws: equal
    losses and (unclipped) main gradients, to 1e-5."""
    x = torch.from_numpy(batch)
    y_shape, z_shape = _hyres(params).residual_model.latent_shapes(batch.shape)
    rng = np.random.default_rng(5)
    C, n = z_shape[3], int(np.prod(z_shape[1:3]))
    full = [rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for s in ((C, 1, B * n), y_shape, y_shape)]
    # micro-batch i's share: its columns of z's (C, 1, B*h*w), its y rows
    micro = [d for i in range(B) for d in (full[0][:, :, i * n:(i + 1) * n],
                                           full[1][i:i + 1], full[2][i:i + 1])]
    runs = {}
    for label, draws, kw in (("accum 1", full, {}), ("accum 2", micro, {"accum_steps": 2}),
                             ("remat", full, {"remat": True})):
        feed_noise(draws)
        state = _state(params, clip=0.0)
        met = make_train_step(state, LMBDA, **kw)(x, torch.Generator(), True)
        runs[label] = (met, state)
    for a, b in (("accum 1", "accum 2"), ("accum 1", "remat")):
        (ma, sa), (mb, sb) = runs[a], runs[b]
        for k in ("loss", "bpp_loss", "mse_loss"):
            assert float(ma[k]) == pytest.approx(float(mb[k]), rel=1e-5), (a, b, k)
        for (n_, pa), pb in zip(sa.model.named_parameters(), sb.model.parameters()):
            if n_.endswith("quantiles"):
                continue
            scale = float(pa.grad.abs().max())
            err = float((pa.grad - pb.grad).abs().max())
            assert err <= 1e-5 * scale, f"{b} {n_}: {err} against {scale}"


def test_nan_guard_skips_both_steps(params, batch):
    state = _state(params)
    step = make_train_step(state, LMBDA)
    step(torch.from_numpy(batch), None, False)  # gives both optimizers state
    before = [p.detach().clone() for p in state.model.parameters()]
    opt_before = [{k: v.clone() for k, v in s.items()} for opt in (state.main, state.aux)
                  for s in opt.state.values()]
    bad = np.full_like(batch, np.nan)
    met = step(torch.from_numpy(bad), None, False)
    assert float(met["skipped_nonfinite"]) == 1.0
    for a, b in zip(before, state.model.parameters()):
        assert torch.equal(a, b.detach())
    opt_after = [s for opt in (state.main, state.aux) for s in opt.state.values()]
    for a, b in zip(opt_before, opt_after):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)



def _seeded_moments(model, seed: int = 7) -> dict:
    """Adam moments for every parameter name: mu ~ N(0, 1e-2), nu = mu^2
    plus a positive spread."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, p in model.named_parameters():
        mu = rng.normal(0, 1e-2, tuple(p.shape)).astype(np.float32)
        out[n] = (mu, np.asarray(mu ** 2 + np.abs(rng.normal(0, 1e-4, mu.shape)), np.float32))
    return out


def _optax_with(state, moments: dict, count: int):
    """An optax state tree with every Adam's ``mu``/``nu`` leaves taken from
    ``moments`` ({"mu"|"nu": flax params tree}) and every count set."""
    def sub(path, leaf):
        names = [getattr(k, "name", None) for k in path]
        for which in ("mu", "nu"):
            if which in names:
                node = moments[which]
                for k in path[names.index(which) + 1:]:
                    node = node[k.key]
                return jnp.asarray(node)
        return jnp.full_like(leaf, count) if names[-1] == "count" else leaf
    return jax.tree_util.tree_map_with_path(sub, state)


def test_skipped_step_aux_loss_equals_jax(params, batch):
    """A non-finite step after a real one (Adam at step 1 with seeded
    moments on both sides): JAX runs both Adams on zeroed gradients, takes
    ``aux_loss`` at those parameters and selects the old state; the port's
    ``aux_loss`` equals JAX's (rel 1e-5), its parameters and both
    optimizers' states stay bit for bit, and the value is not the
    ``aux_loss`` of the unchanged parameters (a main rate of 0.1 moves
    them far enough to tell)."""
    from hyres_tpu_torch.train.optimizers import init_adam_state_

    state = _state(params, lr=0.1)
    moments = _seeded_moments(state.model)
    for opt in (state.main, state.aux):
        init_adam_state_(opt)
    names = {id(p): n for n, p in state.model.named_parameters()}
    for opt in (state.main, state.aux):
        for p, st in opt.state.items():
            mu, nu = moments[names[id(p)]]
            st["step"].fill_(1.0)
            st["exp_avg"].copy_(torch.from_numpy(mu))
            st["exp_avg_sq"].copy_(torch.from_numpy(nu))
    with torch.no_grad():
        unchanged = float(state.model.aux_loss())
    before = [p.detach().clone() for p in state.model.parameters()]
    opt_before = [{k: v.clone() for k, v in s.items()} for opt in (state.main, state.aux)
                  for s in opt.state.values()]
    bad = np.full_like(batch, np.nan)
    met = make_train_step(state, LMBDA)(torch.from_numpy(bad), None, False)

    jm = JHyres(N, M, 1)
    jparams = {"params": params}
    main_tx, aux_tx = jconfigure(jparams, 0.1, 1e-3, 1.0)
    trees = {w: {"params": to_flax({n: torch.from_numpy(m[i]) for n, m in moments.items()})}
             for i, w in enumerate(("mu", "nu"))}
    jstate = jcreate(jparams, main_tx, aux_tx)
    jstate = jstate.replace(main_state=_optax_with(jstate.main_state, trees, 1),
                            aux_state=_optax_with(jstate.aux_state, trees, 1))
    jnew, jmet = jmake_train_step(jm, main_tx, aux_tx, lmbda=LMBDA)(
        jstate, jnp.asarray(bad), jax.random.key(0), False)

    assert float(met["skipped_nonfinite"]) == float(jmet["skipped_nonfinite"]) == 1.0
    got, want = float(met["aux_loss"]), float(jmet["aux_loss"])
    assert got == pytest.approx(want, rel=1e-5)
    assert abs(unchanged - want) > 1e-4 * abs(want)  # ten times the bar
    for a, b in zip(before, state.model.parameters()):
        assert torch.equal(a, b.detach())
    opt_after = [s for opt in (state.main, state.aux) for s in opt.state.values()]
    for a, b in zip(opt_before, opt_after):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert jax.tree.all(jax.tree.map(lambda a, b: bool(jnp.array_equal(a, b)),
                                     jnew.params, jstate.params))


def test_skipped_first_step_leaves_adam_fresh(params, batch):
    """A non-finite FIRST step: Adam's state is created (step 0, zero
    moments) and left there, so the next real step equals a fresh
    state's first step."""
    x = torch.from_numpy(batch)
    fresh = _state(params)
    make_train_step(fresh, LMBDA)(x, None, False)
    state = _state(params)
    step = make_train_step(state, LMBDA)
    step(torch.from_numpy(np.full_like(batch, np.nan)), None, False)
    for opt in (state.main, state.aux):
        for st in opt.state.values():
            assert float(st["step"]) == 0.0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    step(x, None, False)
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)

def test_optimizer_partition_is_hard(params, batch):
    """The main optimizer never moves a quantile and the aux optimizer moves
    nothing else (the reference's tests/test_train.py:95, 166)."""
    state = _state(params)
    q = state.model.residual_model.entropy_bottleneck.quantiles
    main_ids = {id(p) for g in state.main.param_groups for p in g["params"]}
    aux_ids = {id(p) for g in state.aux.param_groups for p in g["params"]}
    assert aux_ids == {id(q)} and not main_ids & aux_ids
    assert len(main_ids | aux_ids) == len(list(state.model.parameters()))
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state.main.step()
    for n, p in state.model.named_parameters():
        moved = not torch.equal(before[n], p.detach())
        assert moved == (not n.endswith("quantiles")), n
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state.aux.step()
    for n, p in state.model.named_parameters():
        assert (not torch.equal(before[n], p.detach())) == n.endswith("quantiles"), n


def test_main_lr_get_set(params):
    state = _state(params, lr=1e-3)
    assert get_main_lr(state.main) == pytest.approx(1e-3)
    set_main_lr(state.main, 1e-4)
    assert get_main_lr(state.main) == pytest.approx(1e-4)
    assert state.aux.param_groups[0]["lr"] == pytest.approx(1e-3)


# -- the optimizer tail on flat buffers ------------------------------------------


def _per_leaf_step(state, lmbda):
    """The training step with the optimizer tail leaf by leaf, as it was
    before the flat buffers: the same finiteness check, masked fill, clip
    and Adams (the NaN guard's snapshot and select are left out: a finite
    step selects its own values)."""
    model, main, aux = state.model, state.main, state.aux
    params = [p for g in main.param_groups + aux.param_groups for p in g["params"]]

    def step(x, generator, noisequant):
        model.train()
        main.zero_grad(set_to_none=True)
        aux.zero_grad(set_to_none=True)
        noise = model.draw_noise(x.shape, generator, noisequant, x.device)
        d = rate_distortion_loss(model(x, noisequant=noisequant, noise=noise), x, lmbda=lmbda)
        d["loss"].backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        finite = tengine._all_finite([p.grad for p in params])
        with torch.no_grad():
            for p in params:
                p.grad.masked_fill_(~finite, 0.0)
            max_norm = main.param_groups[0]["clip_max_norm"]
            grads = [p.grad for p in main.param_groups[0]["params"]]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            for g in grads if max_norm else ():
                g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
        main.step()
        aux.zero_grad(set_to_none=True)
        model.aux_loss().backward()
        aux.step()

    return step


def _train_values(state) -> dict:
    """Every parameter and both Adams' state, cloned, by parameter name."""
    out = {}
    for n, p in state.model.named_parameters():
        out[n] = p.detach().clone()
        for opt in (state.main, state.aux):
            for k, v in opt.state.get(p, {}).items():
                out[f"{n}/{k}"] = v.detach().clone()
    return out


@pytest.mark.parametrize("noisequant", [True, False], ids=["noise", "ste"])
def test_flat_tail_equals_the_per_leaf_tail(params, batch, noisequant):
    """Three steps from one state and generator seeds on the flat tail and
    on the per-leaf one: parameters and both Adams' moments and counts
    equal after each step, bit for bit without the clip; with the
    recipe's clip of 1 the norm is reduced in another order, and each
    parameter's change stays within 1% of the learning rate and each
    moment (the second's square root) within 1e-3 of its leaf's largest."""
    x = torch.from_numpy(batch)
    for clip in (0.0, 1.0):
        flat, leaf = _state(params, clip=clip), _state(params, clip=clip)
        before = _train_values(flat)
        steps = make_train_step(flat, LMBDA), _per_leaf_step(leaf, LMBDA)
        for i in range(3):
            for s in steps:
                s(x, torch.Generator().manual_seed(i), noisequant)
            got, want = _train_values(flat), _train_values(leaf)
            assert got.keys() == want.keys() and len(got) > len(before)
            for k, w in want.items():
                if not clip:
                    assert torch.equal(got[k], w), (i, k)
                elif k.endswith("exp_avg") or k.endswith("exp_avg_sq"):
                    a, b = ((got[k], w) if k.endswith("exp_avg")
                            else (got[k].sqrt(), w.sqrt()))
                    assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), (i, k)
                elif k.endswith("step"):
                    assert torch.equal(got[k], w), (i, k)
                else:
                    lr = 1e-3 if k.endswith("quantiles") else 1e-4
                    err = ((got[k] - before[k]) - (w - before[k])).abs().max()
                    assert float(err) <= 0.01 * lr, (i, k)


class _DoubledLeaves(ResidualJPEGCompression):
    """The small model with as many leaves again, unused by the forward
    (their gradients are zero)."""

    def __init__(self, params):
        super().__init__(N, M, 1)
        self.load_state_dict(from_flax(params))
        self.extra = torch.nn.ParameterList(
            torch.nn.Parameter(torch.zeros_like(p)) for p in list(self.parameters()))


def _tail_ops(model, x, monkeypatch) -> Counter:
    """The aten operations a steady step runs in its ``optim.*`` spans,
    leaving out the aux loss's own forward and backward (the model's
    work, as much whatever the number of leaves)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    main, aux = configure_optimizers(model, 1e-4, 1e-3, 1.0)
    step = make_train_step(create_train_state(model, main, aux), LMBDA)
    step(x, torch.Generator().manual_seed(0), True)  # binds
    names, ops = [], Counter()

    @contextlib.contextmanager
    def span(name):
        names.append(name)
        try:
            yield
        finally:
            names.pop()

    aux_loss = model.aux_loss

    def untallied_aux_loss():
        with span("aux_loss"):
            return aux_loss()

    class Tally(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if (names and names[-1].startswith("optim.")
                    and torch._C._current_graph_task_id() == -1):  # not in a backward
                ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(tengine, "span", span)
    monkeypatch.setattr(model, "aux_loss", untallied_aux_loss)
    with Tally():
        step(x, torch.Generator().manual_seed(1), True)
    return ops


def test_flat_tail_op_count_does_not_grow_with_leaves(params, batch, monkeypatch):
    """The optimizer tail, from ``optim.guard`` to ``optim.select``, runs
    as many operations with twice the leaves, and at most 64."""
    x = torch.from_numpy(batch)
    small, doubled = _hyres(params), _DoubledLeaves(params)
    n = len(list(small.parameters()))
    assert len(list(doubled.parameters())) == 2 * n
    got = [_tail_ops(m, x, monkeypatch) for m in (small, doubled)]
    assert OPTIM_STATS["leaves"]["main"] == 2 * n - 1
    assert got[0] == got[1]
    assert 0 < sum(got[0].values()) <= 64, got[0]


def test_flat_binding_holds_over_steps_and_rebinds_after_restore(params, batch, tmp_path):
    """One binding serves three steps; restoring a checkpoint (new state
    tensors) binds anew at the next step, which then equals the
    uninterrupted run's step bit for bit. A per-leaf ``step()`` on the
    bound Adam counts each leaf's step once."""
    x = torch.from_numpy(batch)
    state = _state(params)
    step = make_train_step(state, LMBDA)
    binds, flat_steps = OPTIM_STATS["binds"], OPTIM_STATS["flat_steps"]
    for i in range(2):
        step(x, torch.Generator().manual_seed(i), True)
    save_checkpoint(train_checkpoint(state, 0, 0.0, 0.0), tmp_path / "c.msgpack")
    step(x, torch.Generator().manual_seed(2), True)
    assert OPTIM_STATS["binds"] == binds + 1
    want = _train_values(state)
    restore_train_state(state, load_checkpoint(tmp_path / "c.msgpack"))
    assert state.step == 2
    step(x, torch.Generator().manual_seed(2), True)
    assert OPTIM_STATS["binds"] == binds + 2
    assert OPTIM_STATS["flat_steps"] == flat_steps + 4
    got = _train_values(state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    state.main.step()
    assert {float(st["step"]) for st in state.main.state.values()} == {4.0}
    step(x, torch.Generator().manual_seed(3), True)
    assert OPTIM_STATS["binds"] == binds + 3


# -- initialisation ----------------------------------------------------------------


def test_fresh_initialisation_matches_flax():
    """Leaf names and shapes equal ``model.init``'s; the constant
    initialisers equal; the lecun-normal leaves' std within 10% of flax's."""
    x = jnp.zeros((1, S, S, 3))
    shapes = jax.eval_shape(lambda: JHyres(N, M, 1).init(
        jax.random.key(0), x, noisequant=True, rng=jax.random.key(1)))["params"]
    model = init_parameters(ResidualJPEGCompression(N, M, 1), torch.Generator().manual_seed(3))
    got = to_flax(model)
    assert jax.tree.structure(got) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(shapes)):
        assert a.shape == b.shape
    # constant initialisers, against the reference's own modules
    gdn = jl.GDN().init(jax.random.key(0), jnp.zeros((1, 2, 2, N)))["params"]
    for name in ("beta", "gamma"):
        np.testing.assert_array_equal(got["residual_model"]["g_a"]["GDN_0"][name],
                                      np.asarray(gdn[name]))
    eb = jent.EntropyBottleneck(N).init(jax.random.key(0), jnp.zeros((1, 2, 2, N)),
                                        noise=False)["params"]
    for name, v in eb.items():
        if not name.startswith("bias_"):
            np.testing.assert_array_equal(
                got["residual_model"]["entropy_bottleneck"][name], np.asarray(v), err_msg=name)
    bias = got["residual_model"]["entropy_bottleneck"]["bias_0"]
    assert bias.min() >= -0.5 and bias.max() < 0.5 and bias.std() > 0.2
    assert float(got["refine"]["PReLU_0"]["alpha"]) == 0.25
    # lecun-normal kernels: the std of flax's own draw, at the same shape
    for path in (("residual_model", "g_a", "Conv_0", "Conv_0"), ("residual_model", "g_s", "Deconv_0"),
                 ("residual_model", "context_prediction"), ("refine", "SEBlock_0", "Dense_0"),
                 ("residual_model", "param_aggregation", "Conv_0", "Conv_0")):
        mine = got
        for k in path:
            mine = mine[k]
        kernel = mine["kernel"]
        ref = jax.nn.initializers.lecun_normal()(jax.random.key(1), kernel.shape)
        assert float(kernel.std()) == pytest.approx(float(np.std(ref)), rel=0.1), path
        assert np.all(mine["bias"] == 0) if "bias" in mine else True
