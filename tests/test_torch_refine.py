"""The port's refinement phase, phase runner and data flattener against
hyres_tpu on the CPU.

Tiny model of tests/test_refine_cli.py (N=8, M=12, JPEG quality 10,
64x64 crops, batch 2), with the reference's own initialisation saved by
the reference and read by the port (``utils/convert.py from_flax``).

Bars: one refinement step's loss rel 1e-4 (the residual carries the JPEG
decode's 1e-2/255, tests/test_torch_train.py); each refine gradient leaf
after the clip within 1e-3 of the leaf's max |g|; the Adam update within
1% of the learning rate where the clipped |g| is at least 1e-6 (Adam's
first step divides it by |g| + eps); every frozen leaf unchanged bit for
bit and without a gradient. A poisoned batch is skipped by both CLIs and
by the port's step, which leaves the refine parameters and the Adam
state bit for bit as they were. Checkpoint trees: equal names and
shapes. ``refine_inference`` PNGs of either package within 1/255 of the
other's, from either package's refine checkpoint. The plateau rule,
phase-runner argv lists and prepare_data names: equal.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyres_tpu.train as jtrain
import hyres_tpu_torch.train as ttrain
from hyres_tpu.cli import phase_runner as jphase
from hyres_tpu.cli import prepare_data as jprep
from hyres_tpu.cli import refine_inference as jrinf
from hyres_tpu.cli import refine_training as jrtrain
from hyres_tpu.cli import training as jtraining
from hyres_tpu.models.hyres import ResidualJPEGCompression as JHyres
from hyres_tpu_torch.cli import phase_runner as tphase
from hyres_tpu_torch.cli import prepare_data as tprep
from hyres_tpu_torch.cli import refine_inference as trinf
from hyres_tpu_torch.cli import refine_training as trtrain
from hyres_tpu_torch.cli import training as ttraining
from hyres_tpu_torch.models.hyres import ResidualJPEGCompression
from hyres_tpu_torch.train import load_checkpoint, restore_into
from hyres_tpu_torch.utils.convert import to_flax
from hyres_tpu_torch.utils.png import read_png, write_png

ROOT = Path(__file__).resolve().parent.parent
IMAGE = ROOT / "matched_r5" / "hyres_found" / "best_images" / "0_original.png"
N, M, Q, S, B = 8, 12, 10, 64, 2
LR = 1e-4
TINY = ["--N", str(N), "--M", str(M), "--jpeg-quality", str(Q)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's small models, so that it
    does not crowd the other test workers' cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A PNG dataset of crops of the in-repo image and their flips, and a
    codec checkpoint of the reference's initialisation, saved by the
    reference."""
    root = tmp_path_factory.mktemp("refine")
    img = read_png(IMAGE)
    for split, n in (("train", 4), ("test", 1)):
        (root / "ds" / split).mkdir(parents=True)
        for i in range(n):
            a = img[40 * i + 150: 40 * i + 150 + 96, 60 * i + 200: 60 * i + 200 + 96]
            a = [a, a[:, ::-1], a[::-1], a[::-1, ::-1]][i % 4]
            if split == "test":
                a = a[:S, :S]
            write_png(root / "ds" / split / f"im{i}.png", np.ascontiguousarray(a))
    params = JHyres(N=N, M=M, jpeg_quality=Q).init(
        jax.random.key(0), jnp.zeros((1, S, S, 3)), noisequant=False)
    ckpt = root / "codec.msgpack"
    jtrain.save_checkpoint({"params": params}, ckpt)
    return root, ckpt


@pytest.fixture(scope="module")
def batch():
    img = read_png(IMAGE).astype(np.float32)[None] / 255.0
    crop = img[:, 200:200 + S, 300:300 + S]
    return np.concatenate([crop, crop[:, ::-1]]).astype(np.float32)


def _port_model(ckpt) -> ResidualJPEGCompression:
    model = ResidualJPEGCompression(N, M, Q)
    restore_into(model, load_checkpoint(ckpt))
    return model


def _refine_step(model):
    params = trtrain.freeze_codec(model)
    opt = torch.optim.Adam(params, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    opt.param_groups[0]["clip_max_norm"] = 1.0
    return trtrain.make_refine_step(model, opt), opt


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


# -- one step ---------------------------------------------------------------------


def test_refine_mask_marks_the_refine_subtree_only(env):
    _, ckpt = env
    model = _port_model(ckpt)
    mask = trtrain.refine_mask(model)
    jmask = jrtrain.refine_mask(jtrain.checkpoint.extract_variables(
        jtrain.load_checkpoint(ckpt)))
    want = {".".join(p[1:]): bool(v) for p, v in _tree_paths(jmask)}
    marks = {n: torch.full_like(p, float(mask[n])) for n, p in model.named_parameters()}
    got = {".".join(p): v for p, v in _tree_paths(to_flax(marks))}
    assert all(np.all(v == v.flat[0]) for v in got.values())
    assert {k: bool(v.flat[0]) for k, v in got.items()} == want
    assert any(want.values()) and not all(want.values())


def test_refine_step_equals_jax(env, batch):
    _, ckpt = env
    jm = JHyres(N=N, M=M, jpeg_quality=Q)
    jparams = jtrain.checkpoint.extract_variables(jtrain.load_checkpoint(ckpt))

    def loss_fn(p, x):  # the reference CLI's loss (refine_training.py:100-102)
        out = jm.apply(p, x, noisequant=False)
        return jnp.mean((out["x_hat"] - x) ** 2) * 255.0 ** 2

    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(jparams, jnp.asarray(batch))
    jg = jg["params"]["refine"]
    norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g))) for g in jax.tree.leaves(jg))))
    clip = min(1.0, 1.0 / norm)

    model = _port_model(ckpt)
    step, _ = _refine_step(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    met = step(torch.from_numpy(batch))
    assert float(met["skipped_nonfinite"]) == 0.0
    assert float(met["loss"]) == pytest.approx(float(jloss), rel=1e-4)
    grads = to_flax({n[len("refine."):]: p.grad for n, p in model.named_parameters()
                     if n.startswith("refine.")})
    after = to_flax({n[len("refine."):]: p for n, p in model.named_parameters()
                     if n.startswith("refine.")})
    start = to_flax({n[len("refine."):]: v for n, v in before.items()
                     if n.startswith("refine.")})
    got = dict(_tree_paths(grads))
    p1, p0 = dict(_tree_paths(after)), dict(_tree_paths(start))
    paths = list(_tree_paths(jg))
    assert {p for p, _ in paths} == set(got)
    for path, g in paths:
        cg = clip * g
        scale = max(float(np.abs(cg).max()), 1e-30)
        err = float(np.abs(got[path] - cg).max())
        assert err <= 1e-3 * scale, f"{'/'.join(path)}: {err} against max |g| {scale}"
        keep = np.abs(cg) >= 1e-6
        want = -LR * cg / (np.abs(cg) + 1e-8)
        upd = (p1[path] - p0[path])[keep]
        assert np.abs(upd - want[keep]).max(initial=0) <= 0.01 * LR, "/".join(path)
    moved = [n for n, p in model.named_parameters() if not torch.equal(before[n], p.detach())]
    assert moved and all(n.startswith("refine.") for n in moved)
    for n, p in model.named_parameters():
        if not n.startswith("refine."):
            assert p.grad is None and not p.requires_grad, n


def test_refine_step_skips_a_poisoned_batch(env, batch):
    _, ckpt = env
    model = _port_model(ckpt)
    step, opt = _refine_step(model)
    step(torch.from_numpy(batch))  # gives Adam its state
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
    met = step(torch.from_numpy(np.full_like(batch, np.nan)))
    assert float(met["skipped_nonfinite"]) == 1.0
    for n, p in model.named_parameters():
        assert torch.equal(before[n], p.detach()), n
    for a, b in zip(state, opt.state.values()):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)



def test_refine_skip_on_a_first_step_leaves_adam_fresh(env, batch):
    """The skip selects on the device (JAX's ``refine_training.py:109-118``)
    against a snapshot that exists before Adam's first step: a poisoned
    first step leaves every parameter and Adam at its initial state (step
    0, zero moments), so the next real step equals a fresh optimizer's
    first, bit for bit; the poisoned step after it moves nothing either."""
    _, ckpt = env
    fresh = _port_model(ckpt)
    _refine_step(fresh)[0](torch.from_numpy(batch))
    model = _port_model(ckpt)
    step, opt = _refine_step(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    met = step(torch.from_numpy(np.full_like(batch, np.nan)))
    assert float(met["skipped_nonfinite"]) == 1.0
    for n, p in model.named_parameters():
        assert torch.equal(before[n], p.detach()), n
    assert opt.state and all(float(s["step"]) == 0.0 and not s["exp_avg"].any()
                             and not s["exp_avg_sq"].any() for s in opt.state.values())
    step(torch.from_numpy(batch))
    for (n, a), b in zip(fresh.named_parameters(), model.parameters()):
        assert torch.equal(a, b), n
    state = [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
    step(torch.from_numpy(np.full_like(batch, np.inf)))
    for a, b in zip(state, opt.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)

class _Batches:
    """A stand-in for both packages' DataLoader that yields fixed batches
    an epoch."""

    def __init__(self, batches):
        self.batches = batches

    def __call__(self, dataset, batch_size, **kw):
        return self

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def close(self):
        pass


def test_both_clis_skip_a_poisoned_batch(env, batch, tmp_path, monkeypatch):
    root, ckpt = env
    poison = _Batches([np.full_like(batch, np.nan)])
    monkeypatch.setattr(jtrain, "DataLoader", poison)
    monkeypatch.setattr(ttrain, "DataLoader", poison)
    argv = ["-d", str(root / "ds"), "--checkpoint", str(ckpt), "-e", "1", "--batch-size",
            str(B), "--patch-size", str(S), str(S), "--steps-per-epoch", "1"] + TINY
    jrtrain.main(argv + ["--savepath", str(tmp_path / "j")])
    trtrain.main(argv + ["--savepath", str(tmp_path / "t"), "--device", "cpu"])
    start = dict(_tree_paths(jtrain.load_checkpoint(ckpt)["params"]["params"]["refine"]))
    for side in ("j", "t"):
        raw = load_checkpoint(tmp_path / side / "refine_last_0.msgpack")
        got = dict(_tree_paths(raw["params"]["refine"]))
        assert got.keys() == start.keys()
        for k in start:
            np.testing.assert_array_equal(got[k], start[k], err_msg=f"{side}: {k}")


# -- the CLIs end to end --------------------------------------------------------------


def _png(path) -> np.ndarray:
    return read_png(path).astype(np.int32)


def test_refine_clis_end_to_end_against_jax(env, tmp_path, capsys):
    """Both packages' refine_training on the same data and seed; the
    refine-only checkpoints have one tree, each package's refine_inference
    reads the other's, and the PNGs agree within 1/255."""
    root, ckpt = env
    argv = ["-d", str(root / "ds"), "--checkpoint", str(ckpt), "-e", "2", "--batch-size",
            str(B), "--patch-size", str(S), str(S), "--steps-per-epoch", "2"] + TINY
    jrtrain.main(argv + ["--savepath", str(tmp_path / "j")])
    trtrain.main(argv + ["--savepath", str(tmp_path / "t"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "codec frozen" in out and "refine training done" in out
    ck = {}
    for side in ("j", "t"):
        names = sorted(p.name for p in (tmp_path / side).iterdir())
        assert len(names) == 2 and names[1] == "refine_last_1.msgpack", names
        ck[side] = tmp_path / side / names[0]
        assert names[0].startswith("refine_best_")
    raw_j, raw_t = (jtrain.load_checkpoint(ck[s]) for s in ("j", "t"))
    assert set(raw_t) == set(raw_j) == {"epoch", "params", "loss"}
    assert set(raw_t["params"]) == {"refine"}
    tj = {p: a.shape for p, a in _tree_paths(raw_j["params"])}
    tt = {p: a.shape for p, a in _tree_paths(raw_t["params"])}
    assert tt == tj
    img = str(root / "ds" / "test" / "im0.png")
    for side in ("j", "t"):
        for skip in ([], ["--skip-postprocessing"]):
            paths = {}
            for pkg, main, extra in (("j", jrinf.main, []), ("t", trinf.main, ["--device", "cpu"])):
                paths[pkg] = tmp_path / f"{side}{pkg}{len(skip)}.png"
                main(["--checkpoint", str(ckpt), "--post-checkpoint", str(ck[side]),
                      "--input", img, "--output", str(paths[pkg])] + TINY + skip + extra)
            lines = capsys.readouterr().out.strip().splitlines()
            assert all(re.search(r"psnr=[\d.]+ jpeg_bpp=[\d.]+$", ln) for ln in lines)
            diff = np.abs(_png(paths["t"]) - _png(paths["j"])).max()
            assert diff <= 1, f"checkpoint {side}, skip {bool(skip)}: {diff}/255"
    # the overlay changed the output: the refinement was trained
    assert not np.array_equal(_png(tmp_path / "tt0.png"), _png(tmp_path / "tt1.png"))


def test_resume_overlays_a_refine_checkpoint(env, batch, tmp_path):
    """``--resume`` starts from the refine-only checkpoint's leaves."""
    root, ckpt = env
    model = _port_model(ckpt)
    step, _ = _refine_step(model)
    step(torch.from_numpy(batch))
    ttrain.save_checkpoint(trtrain.refine_checkpoint(model, 0, 1.0), tmp_path / "r.msgpack")
    fresh = _port_model(ckpt)
    trtrain.load_refine(fresh, load_checkpoint(tmp_path / "r.msgpack"))
    for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    trtrain.main(["-d", str(root / "ds"), "--checkpoint", str(ckpt), "--resume",
                  str(tmp_path / "r.msgpack"), "-e", "1", "--batch-size", str(B),
                  "--patch-size", str(S), str(S), "--steps-per-epoch", "1", "-lr", "0",
                  "--savepath", str(tmp_path / "out"), "--device", "cpu"] + TINY)
    got = dict(_tree_paths(
        load_checkpoint(tmp_path / "out" / "refine_last_0.msgpack")["params"]["refine"]))
    want = dict(_tree_paths(to_flax(model.refine)))
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg="/".join(p))


class _ScriptedMean:
    """numpy with ``mean`` replaced by a script of values (the eval's
    val_mse, then val_psnr, each epoch)."""

    def __init__(self, values):
        self.values = list(values)

    def mean(self, _):
        return self.values.pop(0)

    def __getattr__(self, name):
        return getattr(np, name)


def test_plateau_rule_equals_jax(env, tmp_path, monkeypatch, capsys):
    """Both CLIs on one scripted val_mse sequence (no training step): the
    learning rates they print each epoch agree, through two plateaus and
    the 1e-6 floor."""
    root, ckpt = env
    vals = [10.0, 9.0] + [9.0] * 6 + [8.0] + [8.5] * 6 + [9.0]
    script = [v for val in vals for v in (val, 20.0)]
    monkeypatch.setattr(jtrain, "DataLoader", _Batches([]))
    monkeypatch.setattr(ttrain, "DataLoader", _Batches([]))
    lrs = {}
    for side, mod, extra in (("j", jrtrain, []), ("t", trtrain, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "np", _ScriptedMean(script))
        mod.main(["-d", str(root / "ds"), "--checkpoint", str(ckpt), "-e", str(len(vals)),
                  "-lr", "4e-6", "--batch-size", str(B), "--patch-size", str(S), str(S),
                  "--savepath", str(tmp_path / side)] + TINY + extra)
        lrs[side] = re.findall(r"lr=(\S+)", capsys.readouterr().out)
    assert len(lrs["t"]) == len(vals) and lrs["t"] == lrs["j"]
    assert lrs["t"][0] == "4.00e-06" and lrs["t"][-1] == "1.00e-06"
    assert len(set(lrs["t"])) == 3  # two decays, the second floored


# -- phase runner and prepare_data --------------------------------------------------------


def _recorder(calls, write="checkpoint_best_3.msgpack"):
    def train_main(argv):
        calls.append(list(argv))
        out = Path(argv[argv.index("--savepath") + 1])
        if write:
            (out / write).write_bytes(b"")
    return train_main


@pytest.mark.parametrize("extra,write", [
    ([], "checkpoint_best_3.msgpack"),
    (["--first-phase-epochs", "7"], "checkpoint_best_3.msgpack"),
    (["--init-checkpoint", "start.msgpack"], "checkpoint_best_3.msgpack"),
    (["--passthrough", "--device", "cpu", "--batch-size", "2"], "checkpoint_last_3.msgpack"),
])
def test_phase_runner_argv_equals_jax(tmp_path, monkeypatch, extra, write):
    calls = {"j": [], "t": []}
    monkeypatch.setattr(jtraining, "main", _recorder(calls["j"], write))
    monkeypatch.setattr(ttraining, "main", _recorder(calls["t"], write))
    argv = ["-d", "DS", "--lambdas", "0.045", "0.032", "0.016", "--epochs-per-phase", "5",
            "--savepath", str(tmp_path)] + extra
    jphase.main(argv)
    tphase.main(argv)
    assert calls["t"] == calls["j"] and len(calls["t"]) == 3
    assert calls["t"][1][-3:] == ["--pretrained", "--checkpoint",
                                  str(tmp_path / "phase0_0.045" / write)]


def test_phase_runner_raises_without_a_checkpoint(tmp_path, monkeypatch):
    for mod, pkg in ((jtraining, jphase), (ttraining, tphase)):
        monkeypatch.setattr(mod, "main", _recorder([], write=None))
        with pytest.raises(RuntimeError, match="phase produced no checkpoint"):
            pkg.main(["-d", "DS", "--lambdas", "0.01", "--savepath", str(tmp_path)])


def test_phase_runner_chains_two_real_phases(env, tmp_path, capsys):
    root, _ = env
    tphase.main(["-d", str(root / "ds"), "--lambdas", "0.045", "0.032",
                 "--epochs-per-phase", "1", "--first-phase-epochs", "1",
                 "--savepath", str(tmp_path), "--passthrough", "--N", str(N), "--M", str(M),
                 "--jpeg-quality", str(Q), "--patch-size", str(S), str(S), "--batch-size",
                 str(B), "--test-batch-size", "1", "--steps-per-epoch", "1",
                 "--num-workers", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    first = tmp_path / "phase0_0.045" / "checkpoint_best_0.msgpack"
    assert f"chained from {first}" in out and "loaded pretrained weights" in out
    final = tmp_path / "phase1_0.032" / "checkpoint_best_0.msgpack"
    assert out.strip().endswith(f"final best: {final}")
    assert int(load_checkpoint(final)["step"]) == 1


def _tree(root: Path) -> None:
    files = ["a/x.png", "b/x.png", "b/y.JPG", "c/x.png", "c/b_x.png", "b_x.png",
             "a/notes.txt", "d/e/x.png", "d/e/y.jpg", "f/e/x.png"]
    for i, f in enumerate(files):
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        (root / f).write_bytes(bytes([i]) * (i + 1))


@pytest.mark.parametrize("move", [False, True])
def test_prepare_data_names_equal_jax(tmp_path, move, capsys):
    out = {}
    for side, mod in (("j", jprep), ("t", tprep)):
        src = tmp_path / side / "src"  # one name: a root file's prefix is its parent's
        _tree(src)
        dst = tmp_path / side / "dst"
        mod.main(["--source", str(src), "--dest", str(dst)] + (["--move"] if move else []))
        out[side] = {p.name: p.read_bytes() for p in dst.iterdir()}
        assert (src / "a" / "notes.txt").exists()
        assert (src / "a" / "x.png").exists() != move
    assert out["t"] == out["j"]
    assert {"x.png", "b_x.png", "c_x.png", "c_b_x.png", "src_b_x.png", "e_x.png",
            "e_1_x.png"} <= set(out["t"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split(" images")[0] == lines[1].split(" images")[0]


def test_refine_clis_run_on_the_card_by_default(env, tmp_path):
    """Without ``--device`` both CLIs take the card, and raise where there
    is none (they never fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    root, ckpt = env
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trtrain.main(["-d", str(root / "ds"), "--checkpoint", str(ckpt),
                      "--savepath", str(tmp_path)] + TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trinf.main(["--checkpoint", str(ckpt), "--input", str(IMAGE),
                    "--output", str(tmp_path / "o.png")] + TINY)
    assert "jax" not in sys.modules["hyres_tpu_torch.cli.refine_training"].__dict__
