"""The port's training data, checkpoints and CLI against hyres_tpu (CPU).

Bars: loader batches equal to the reference's for the same seed where no
resize is needed, within 2/255 where one is (``F.interpolate`` with
antialiasing against PIL's BILINEAR); ``to_flax(from_flax(p))`` exact;
a port checkpoint evaluated by the reference within 1e-4 of the port's
eval forward (the JPEG decode's 1e-2/255 in the residual). The CLI runs in
process with ``--device cpu`` at N=8, M=12 on 64x64 crops.
"""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu.models.hyres import ResidualJPEGCompression as JHyres
from hyres_tpu.train import checkpoint as jckpt
from hyres_tpu.train import configure_optimizers as jconfigure
from hyres_tpu.train import create_train_state as jcreate
from hyres_tpu.train import data as jdata
from hyres_tpu_torch.cli import training as cli
from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
from hyres_tpu_torch.nn import init_parameters
from hyres_tpu_torch.train import data as tdata
from hyres_tpu_torch.train import load_checkpoint, make_eval_step, restore_into
from hyres_tpu_torch.utils.convert import from_flax, to_flax
from hyres_tpu_torch.utils.flax_msgpack import load_artifact
from hyres_tpu_torch.utils.png import read_png, write_png

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
ARTIFACT = ROOT / "artifacts" / "hyres_n128_q1_l0032.msgpack"
N, M = 8, 12
SMALL = ["--N", str(N), "--M", str(M), "--patch-size", "64", "64", "--batch-size", "2",
         "--test-batch-size", "2", "--num-workers", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's small models, so that it
    does not crowd the other test workers' cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dataset(root: Path, sizes) -> Path:
    """PNG crops, flips and rotations of the in-repo image under train/ and
    test/."""
    img = read_png(IMAGE)
    for split, shapes in sizes.items():
        (root / split).mkdir(parents=True)
        for i, (h, w) in enumerate(shapes):
            a = img[37 * i: 37 * i + h, 53 * i: 53 * i + w]
            a = [a, a[:, ::-1], a[::-1], np.rot90(a)][i % 4]
            write_png(root / split / f"{i:02d}.png", np.ascontiguousarray(a))
    return root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("ds"),
                    {"train": [(96, 112)] * 4 + [(112, 96)] * 2, "test": [(64, 128)] * 2})


@pytest.mark.parametrize("augment", [False, True])
def test_loader_batches_equal_jax(dataset, augment):
    kw = dict(patch_size=(64, 64), train=True, augment=augment)
    jl = jdata.DataLoader(jdata.ImageFolder(str(dataset), "train", **kw), 2, seed=7,
                          num_workers=2)
    tl = tdata.DataLoader(tdata.ImageFolder(str(dataset), "train", **kw), 2, seed=7,
                          num_workers=2)
    for _ in range(2):  # two epochs: the shuffles and the per-image draws
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    tl.close()
    test_t = tdata.ImageFolder(str(dataset), "test", None, train=False)
    test_j = jdata.ImageFolder(str(dataset), "test", None, train=False)
    np.testing.assert_array_equal(test_t.load(0, np.random.default_rng(0)),
                                  test_j.load(0, np.random.default_rng(0)))


@pytest.mark.parametrize("scale", [None, (0.6, 1.0)])
def test_loader_resizes_within_2_of_255(tmp_path, scale):
    root = _dataset(tmp_path, {"train": [(40, 56), (48, 48), (50, 44), (96, 96)]})
    kw = dict(patch_size=(64, 64), train=True, scale_range=scale)
    jl = jdata.DataLoader(jdata.ImageFolder(str(root), "train", **kw), 2, seed=3,
                          num_workers=1)
    tl = tdata.DataLoader(tdata.ImageFolder(str(root), "train", **kw), 2, seed=3,
                          num_workers=1)
    for g, w in zip(list(tl), list(jl)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2 / 255 + 1e-6)
    tl.close()


def test_non_png_dataset_names_the_file(tmp_path):
    (tmp_path / "train").mkdir()
    (tmp_path / "train" / "a.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="a.jpg"):
        tdata.ImageFolder(str(tmp_path), "train")


def test_to_flax_inverts_from_flax():
    _, params, _ = load_artifact(ARTIFACT)
    back = to_flax(from_flax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and a.shape == np.shape(b)
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """Two epochs from a fresh start, then one resumed epoch."""
    save = tmp_path_factory.mktemp("ckpt")
    cli.main(["-d", str(dataset), "-e", "2", "--noise-epochs", "1",
              "--savepath", str(save)] + SMALL)
    first = sorted(p.name for p in save.iterdir())
    cli.main(["-d", str(dataset), "-e", "3", "--noise-epochs", "1", "--savepath", str(save),
              "--checkpoint", str(save / "checkpoint_last_1.msgpack")] + SMALL)
    return save, first


def test_training_cli_writes_rolling_checkpoints_and_resumes(trained):
    save, first = trained
    assert "checkpoint_last_1.msgpack" in first and "best_metrics.csv" in first
    assert sum(n.startswith("checkpoint_last_") for n in first) == 1
    assert sum(n.startswith("checkpoint_best_") for n in first) == 1
    names = sorted(p.name for p in save.iterdir())
    assert "checkpoint_last_2.msgpack" in names and "checkpoint_last_1.msgpack" not in names
    with open(save / "best_metrics.csv") as f:
        rows = list(csv.reader(f))
    assert "psnr" in rows[0] and np.isfinite([float(v) for v in rows[1]]).all()
    assert (save / "best_images" / "0_recon.png").exists()
    raw = load_checkpoint(save / "checkpoint_last_2.msgpack")
    assert int(raw["epoch"]) == 2 and int(raw["step"]) == 9  # 3 steps an epoch
    # the resumed run restored both optimizers: the STE-phase lr and the moments
    assert float(raw["main_state"]["lr"]) == pytest.approx(1e-5)
    assert set(raw["aux_state"]["state"]) == {"residual_model.entropy_bottleneck.quantiles"}


def test_reference_reads_a_port_checkpoint(trained, dataset):
    """JAX ``restore_into`` + ``apply`` on the port's checkpoint: the eval
    forward equals the port's to 1e-4."""
    save, _ = trained
    path = save / "checkpoint_last_2.msgpack"
    jm = JHyres(N, M, 1)
    x = np.stack([read_png(p).astype(np.float32) / 255.0
                  for p in sorted((dataset / "test").iterdir())])
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    jparams = jckpt.restore_into(template, jckpt.load_checkpoint(str(path))["params"])
    jout = jax.jit(lambda p, x: jm.apply(p, x, noisequant=False))(jparams, jnp.asarray(x))
    model = restore_into(ResidualJPEGCompression(N, M, 1), load_checkpoint(path))
    _, out = make_eval_step(model, 0.015)(torch.from_numpy(x))
    for k in ("x_hat", "residual_hat"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(out["likelihoods"][k].numpy(),
                                   np.asarray(jout["likelihoods"][k]), rtol=1e-3, atol=1e-4)


def test_pretrained_from_a_jax_checkpoint(dataset, tmp_path, capsys):
    model = init_parameters(ResidualJPEGCompression(N, M, 1), torch.Generator().manual_seed(5))
    jparams = {"params": to_flax(model)}
    main_tx, aux_tx = jconfigure(jparams, 1e-4, 1e-3, 1.0)
    st = jcreate(jparams, main_tx, aux_tx)
    path = tmp_path / "jax.msgpack"
    jckpt.save_checkpoint({"epoch": 7, "params": st.params, "main_state": st.main_state,
                           "aux_state": st.aux_state, "step": st.step, "loss": 1.0,
                           "best_loss": 1.0}, str(path))
    loaded = restore_into(ResidualJPEGCompression(N, M, 1), load_checkpoint(path))
    for a, b in zip(loaded.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    cli.main(["-d", str(dataset), "-e", "1", "--pretrained", "--checkpoint", str(path),
              "--savepath", str(tmp_path / "out"), "--gradient-accumulation-steps", "2",
              "--steps-per-epoch", "1"] + SMALL)
    text = capsys.readouterr().out
    assert "loaded pretrained weights" in text and "epoch 0 [0/" in text
    raw = load_checkpoint(tmp_path / "out" / "checkpoint_last_0.msgpack")
    assert int(raw["step"]) == 1 and int(raw["epoch"]) == 0


def test_checkerboard_family_trains(dataset, tmp_path):
    cli.main(["-d", str(dataset), "-e", "1", "--model", "checkerboard",
              "--savepath", str(tmp_path)] + SMALL)
    raw = load_checkpoint(tmp_path / "checkpoint_last_0.msgpack")
    assert "entropy_bottleneck" in raw["params"]["params"]


@pytest.mark.parametrize("argv,item", [
    # the reference's refusal of random VGG features (hyres_tpu/cli/training.py:180-190)
    (["--alpha", "0.01"], "alpha>0 but no pretrained VGG16 weights are available")])
def test_unported_options_exit_naming_the_roadmap(dataset, tmp_path, monkeypatch, argv, item):
    monkeypatch.delenv("HYRES_VGG16_WEIGHTS", raising=False)
    with pytest.raises(SystemExit, match=item):
        cli.main(["-d", str(dataset), "--savepath", str(tmp_path)] + SMALL + argv)


def test_training_cli_runs_on_the_card_by_default(dataset, tmp_path):
    """Without ``--device`` the CLI takes the card, and raises where there
    is none (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would train on it")
    argv = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-d", str(dataset), "-e", "1", "--savepath", str(tmp_path)] + argv)
