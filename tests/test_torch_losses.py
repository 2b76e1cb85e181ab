"""The port's perceptual losses and metrics against hyres_tpu on the CPU.

VGG16 and LPIPS weights are written from a seed to scratch ``.npz`` files
in the torch layout (``HYRES_VGG16_WEIGHTS``, ``HYRES_LPIPS_WEIGHTS``)
and loaded by both packages.

Bars: VGG16 slice activations, ``VGGLoss`` and ``LPIPS`` rel 1e-4 (float32
convolutions summed in another order), ``VGGLoss``'s gradient into its
first input within 1e-3 of its max |g|; ``CompressionMetrics`` at 192x192
rel 1e-5. One ``make_train_step`` with the VGG term (alpha 0.01) on the
tiny HyRES model (N=8, M=12, JPEG quality 10, 64x64, batch 2) against
the reference's, with the reference's noise draws: the bars of
tests/test_torch_train.py -- metrics rel 1e-4, every update within 1%
of the learning rate where the reference's clipped gradient is at least
1e-6 or 1e-3 of the leaf's largest where that is less.
"""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.losses import CompressionMetrics as JMetrics
from hyres_tpu.losses import VGGLoss as JVGGLoss
from hyres_tpu.losses.lpips import LPIPS as JLPIPS
from hyres_tpu.models.hyres import ResidualJPEGCompression as JHyres
from hyres_tpu.train import configure_optimizers as jconfigure
from hyres_tpu.train import create_train_state as jcreate
from hyres_tpu.train import make_train_step as jmake_train_step
from hyres_tpu_torch.cli import training as cli
from hyres_tpu_torch.losses import (LPIPS, CompressionMetrics, VGG16Features, VGGLoss,
                                    load_lpips)
from hyres_tpu_torch.losses.lpips import AlexFeatures
from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
from hyres_tpu_torch.nn import quantizer
from hyres_tpu_torch.train import configure_optimizers, create_train_state, make_train_step
from hyres_tpu_torch.utils.convert import from_flax, to_flax
from hyres_tpu_torch.utils.png import read_png, write_png

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
N, M, Q, S, B = 8, 12, 10, 64, 2
LMBDA, ALPHA = 0.015, 0.01


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's small models, so that it
    does not crowd the other test workers' cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _npz(path: Path, shapes: dict, seed: int, nonneg=()) -> Path:
    """Seeded torch-layout weights: He-scaled kernels, small biases."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, shp in shapes.items():
        fan_in = int(np.prod(shp[1:])) if len(shp) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if len(shp) > 1 else 0.01
        a = rng.normal(0, scale, shp).astype(np.float32)
        arrays[k] = np.abs(a) if k in nonneg else a
    np.savez(path, **arrays)
    return path


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    shapes = {k: tuple(v.shape) for k, v in VGG16Features().state_dict().items()}
    return _npz(tmp_path_factory.mktemp("vgg") / "vgg16.npz", shapes, 7)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    shapes = {f"net.{k}": tuple(v.shape) for k, v in AlexFeatures().state_dict().items()}
    shapes.update({f"lin{i}.weight": (1, c, 1, 1) for i, c in enumerate((64, 192, 384, 256, 256))})
    return _npz(tmp_path_factory.mktemp("lpips") / "lpips.npz", shapes, 8,
                nonneg={f"lin{i}.weight" for i in range(5)})


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    img = read_png(IMAGE).astype(np.float32) / 255.0
    n, h, w = shape
    x = np.stack([img[37 * i: 37 * i + h, 53 * i: 53 * i + w] for i in range(n)])
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    return x.astype(np.float32), y


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-30))


def test_vgg_features_loss_and_gradient_equal_jax(vgg_npz, monkeypatch):
    monkeypatch.setenv("HYRES_VGG16_WEIGHTS", str(vgg_npz))
    x, y = _pair((2, 48, 40), 0)
    jv = JVGGLoss()
    tv = VGGLoss()
    assert jv.pretrained and tv.pretrained
    jf = jv.module.apply(jv.params, jnp.asarray(x))
    tf = tv.module(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(a.shape) for a in jf] == [tuple(a.permute(0, 2, 3, 1).shape) for a in tf]
    for a, b in zip(tf, jf):
        assert _rel(a.permute(0, 2, 3, 1).detach().numpy(), b) <= 1e-4
    jval, jg = jax.value_and_grad(lambda a: jv(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    val = tv(xt, torch.from_numpy(y))
    val.backward()
    assert float(val.detach()) == pytest.approx(float(jval), rel=1e-4)
    assert _rel(xt.grad.numpy(), jg) <= 1e-3
    assert all(not p.requires_grad for p in tv.parameters())


def test_vgg_without_weights_is_random_and_seeded(monkeypatch):
    monkeypatch.delenv("HYRES_VGG16_WEIGHTS", raising=False)
    a, b = VGGLoss(), VGGLoss(torch.Generator().manual_seed(0))
    assert not a.pretrained
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    x, y = _pair((1, 32, 32), 1)
    assert float(a(torch.from_numpy(x), torch.from_numpy(y))) > 0


def test_lpips_equals_jax(lpips_npz, monkeypatch):
    x, y = _pair((2, S, S), 2)
    want = JLPIPS(str(lpips_npz))(jnp.asarray(x), jnp.asarray(y))
    got = LPIPS(str(lpips_npz))(torch.from_numpy(x), torch.from_numpy(y))
    assert float(got) == pytest.approx(float(want), rel=1e-4)
    assert float(got) > 0
    monkeypatch.delenv("HYRES_LPIPS_WEIGHTS", raising=False)
    assert load_lpips() is None
    with pytest.raises(FileNotFoundError):
        LPIPS("")
    monkeypatch.setenv("HYRES_LPIPS_WEIGHTS", str(lpips_npz))
    assert float(load_lpips()(torch.from_numpy(x), torch.from_numpy(y))) == float(got)


@pytest.mark.parametrize("with_lpips", [False, True])
def test_compression_metrics_equal_jax(lpips_npz, monkeypatch, with_lpips):
    if with_lpips:
        monkeypatch.setenv("HYRES_LPIPS_WEIGHTS", str(lpips_npz))
    else:
        monkeypatch.delenv("HYRES_LPIPS_WEIGHTS", raising=False)
    x, y = _pair((2, 192, 192), 3)
    want = JMetrics().compute_all(jnp.asarray(x), jnp.asarray(y))
    got = CompressionMetrics(device="cpu").compute_all(torch.from_numpy(x),
                                                       torch.from_numpy(y))
    assert set(got) == set(want) == {"psnr", "ms-ssim", "lpips"}
    for k in ("psnr", "ms-ssim"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    if with_lpips:
        assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-5)
    else:
        assert got["lpips"] is None and want["lpips"] is None


# -- the RD train step with the VGG term -----------------------------------------------


def _jax_draws(rng, z_shape, y_shape, noisequant: bool) -> list:
    """The reference forward's draws for one key, in the port's order."""
    rz, ra, rn = jax.random.split(rng, 3)
    B_, h, w, C = z_shape
    draws = [jax.random.uniform(rz, (C, 1, B_ * h * w), jnp.float32, -0.5, 0.5)]
    if noisequant:
        draws += [jax.random.uniform(r, y_shape, jnp.float32, -0.5, 0.5) for r in (ra, rn)]
    return [np.asarray(d) for d in draws]


def test_train_step_with_vgg_equals_jax(vgg_npz, monkeypatch):
    monkeypatch.setenv("HYRES_VGG16_WEIGHTS", str(vgg_npz))
    batch, _ = _pair((B, S, S), 4)
    jm = JHyres(N, M, Q)
    jparams = jm.init(jax.random.key(0), jnp.zeros((1, S, S, 3)), noisequant=False)
    jparams = jax.tree.map(np.asarray, jparams)
    params = jparams["params"]
    jvgg = JVGGLoss()
    main_tx, aux_tx = jconfigure(jparams, 1e-4, 1e-3, 1.0)
    key = jax.random.key(21)
    jstate, jmet = jmake_train_step(jm, main_tx, aux_tx, lmbda=LMBDA, alpha=ALPHA,
                                    vgg_fn=jvgg)(jcreate(jparams, main_tx, aux_tx),
                                                 jnp.asarray(batch), key, True)
    from hyres_tpu.losses import rate_distortion_loss as jrd_loss

    def loss(p):
        out = jm.apply(p, jnp.asarray(batch), noisequant=True, rng=key)
        return jrd_loss(out, jnp.asarray(batch), LMBDA, ALPHA, jvgg)["loss"]

    jg = jax.jit(jax.grad(loss))(jparams)["params"]
    main = [g for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]
            if path[-1].key != "quantiles"]
    clip = min(1.0, 1.0 / float(np.sqrt(sum(np.sum(np.square(g)) for g in main))))

    model = ResidualJPEGCompression(N, M, Q)
    model.load_state_dict(from_flax(params))
    main_opt, aux_opt = configure_optimizers(model, 1e-4, 1e-3, 1.0)
    state = create_train_state(model, main_opt, aux_opt)
    y_shape, z_shape = model.residual_model.latent_shapes(batch.shape)
    queue = _jax_draws(key, z_shape, y_shape, True)
    monkeypatch.setattr(quantizer, "uniform_noise",
                        lambda shape, generator, device: torch.from_numpy(np.array(queue.pop(0))))
    vgg = VGGLoss()
    met = make_train_step(state, LMBDA, alpha=ALPHA, vgg_fn=vgg)(
        torch.from_numpy(batch), torch.Generator(), True)
    assert not queue
    assert float(met["vgg_loss"]) > 0
    for k in ("loss", "vgg_loss", "mse_loss", "bpp_loss", "aux_loss", "skipped_nonfinite"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-4, abs=1e-7), k
    got = to_flax(state.model)
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
        assert keep.any(), f"{name}: every element's gradient is zero"
        err = np.abs((node - p0) - (np.asarray(p1) - p0))[keep]
        assert err.max() <= 0.01 * lr, f"{name}: {err.max() / lr} of lr"
    assert all(not p.requires_grad for p in vgg.parameters())
    assert not any(id(p) in {id(q) for g in main_opt.param_groups for q in g["params"]}
                   for p in vgg.parameters())


def test_training_cli_trains_with_random_vgg(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("HYRES_VGG16_WEIGHTS", raising=False)
    img = read_png(IMAGE)
    for split, n in (("train", 2), ("test", 1)):
        (tmp_path / "ds" / split).mkdir(parents=True)
        for i in range(n):
            write_png(tmp_path / "ds" / split / f"{i}.png",
                      np.ascontiguousarray(img[50 * i: 50 * i + S, 70 * i: 70 * i + S]))
    cli.main(["-d", str(tmp_path / "ds"), "--N", str(N), "--M", str(M), "--jpeg-quality",
              str(Q), "--patch-size", str(S), str(S), "--batch-size", "2",
              "--test-batch-size", "1", "--num-workers", "1", "--device", "cpu", "-e", "1",
              "--alpha", str(ALPHA), "--allow-random-vgg", "--savepath", str(tmp_path / "o")])
    out = capsys.readouterr().out
    assert "perceptual term uses random features (--allow-random-vgg)" in out
    with open(tmp_path / "o" / "best_metrics.csv") as f:
        row = next(csv.DictReader(f))
    assert float(row["vgg_loss"]) > 0 and np.isfinite(float(row["loss"]))
