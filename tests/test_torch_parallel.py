"""Data parallelism and sharded evaluation of the port (``parallel/``).

Two gloo ranks on the CPU (``tests/torch_parallel_workers.py``, spawned
with a file rendezvous and a wall clock) against the single process:
the DP HyRES train step at an even and an uneven batch, and with a
non-finite gradient on one rank; the DP refinement step; the sharded
eval against JAX's ``make_sharded_eval`` on the conftest's virtual
devices; the spatial eval against the in-process strips. In process:
``strip_forward`` under JAX's spatial contract, torchrun's environment,
and both training CLIs under ``torch.distributed.run`` with 2 ranks.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyres_tpu_torch import parallel
from hyres_tpu_torch.utils.convert import to_flax
from hyres_tpu_torch.utils.png import write_png
from tests import torch_parallel_workers as W

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5  # DP against the single process (gloo sums in another order)
GRAD_BAR = 1e-4   # each leaf, as a share of its largest |g|
EVAL_RTOL = 1e-4
LR = 1e-4         # both CLIs' default main learning rate


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads (each spawned rank takes the same), so that
    the module does not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close_to_single(got: dict, want: dict) -> None:
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= LOSS_RTOL * max(abs(v), 1e-30), (k, got, want)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for n, g in want["grads"].items():
        err = float((got["grads"][n] - g).abs().max())
        assert err <= GRAD_BAR * max(float(g.abs().max()), 1e-30), (n, err)


def _adam_close(got: dict, want: dict) -> None:
    """Parameters after one Adam step. Its first update is lr * g / (|g| +
    eps), about lr * sign(g): an element whose gradient sums to float noise
    can step either way and land 2 lr apart; the rest agree within 1e-5."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        d = np.abs(np.asarray(got[k]) - np.asarray(v))
        assert d.max() <= 2 * LR + 1e-5 and np.mean(d > 1e-5) <= 1e-3, (k, d.max())


def _same_on_every_rank(ranks: list) -> None:
    for r in ranks[1:]:
        np.testing.assert_equal(r["metrics"], ranks[0]["metrics"])  # NaN == NaN
        for n, p in ranks[0]["params"].items():
            assert torch.equal(r["params"][n], p), n


@pytest.mark.parametrize("B", [2, 3])
def test_dp_train_step_equals_single_process(tmp_path, B):
    """B=3 over two ranks is uneven (2 + 1 rows)."""
    ranks = W.run_ranks(W.train_rank, 2, tmp_path, B)
    single = W.train_once(None, B)
    _same_on_every_rank(ranks)
    _close_to_single(ranks[0], single)
    _adam_close(ranks[0]["params"], single["params"])


def test_dp_train_step_with_accumulation_equals_single_process(tmp_path):
    ranks = W.run_ranks(W.train_rank, 2, tmp_path, 4, 2)
    _same_on_every_rank(ranks)
    _close_to_single(ranks[0], W.train_once(None, 4, accum=2))


def test_dp_nonfinite_gradient_skips_on_every_rank(tmp_path):
    """A NaN image among rank 1's rows: both ranks skip the step."""
    ranks = W.run_ranks(W.train_rank, 2, tmp_path, 2, 1, 1)
    start = {n: p.detach() for n, p in W.hyres_model().named_parameters()}
    _same_on_every_rank(ranks)
    for r in ranks:
        assert r["metrics"]["skipped_nonfinite"] == 1.0
        assert all(torch.equal(r["params"][n], p) for n, p in start.items())


def test_dp_refine_step_equals_single_process(tmp_path):
    ranks = W.run_ranks(W.refine_rank, 2, tmp_path, 3)
    single = W.refine_once(None, 3)
    _same_on_every_rank(ranks)
    _close_to_single(ranks[0], single)
    assert all(n.startswith("refine.") for n in single["grads"])


def _jax_sharded_eval(model, B: int):
    from hyres_tpu.models.checkerboard import LightWeightCheckerboard as JCheckerboard
    from hyres_tpu.models.hyres import ResidualJPEGCompression as JHyres
    from hyres_tpu.parallel import data_parallel_mesh, make_sharded_eval

    jmodel = (JHyres(W.N, W.M, W.Q) if hasattr(model, "refine")
              else JCheckerboard(W.N, W.M))
    mesh = data_parallel_mesh(jax.devices()[:4], batch_size=B)
    out = make_sharded_eval(jmodel, mesh)({"params": to_flax(model)},
                                          jnp.asarray(W.images(B, 2).numpy()))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("family", ["checkerboard", "hyres"])
def test_sharded_eval_matches_jax(tmp_path, monkeypatch, family):
    """HyRES's JPEG layer runs JAX's Pallas K1/K2 in interpret mode, the
    TPU path that the port's kernels equal (JAX's CPU path divides by q
    where the kernel multiplies by 1/q, so a .5 tie can round apart)."""
    import functools

    from hyres_tpu.kernels import dct as jdct

    monkeypatch.setenv("HYRES_DCT_KERNEL", "pallas")
    for name in ("fdct_quant_blocks", "dequant_idct_blocks"):
        monkeypatch.setattr(jdct, name, functools.partial(getattr(jdct, name), interpret=True))
    B = 3
    ranks = W.run_ranks(W.sharded_eval_rank, 2, tmp_path, family, B)
    want = _jax_sharded_eval(W.hyres_model(2) if family == "hyres"
                             else W.checkerboard_model(2), B)
    for r in ranks:
        assert r["x_hat"].shape == (B, W.S, W.S, 3)
        for k in ("psnr", "bpp_est"):
            np.testing.assert_allclose(r[k].numpy(), want[k], rtol=EVAL_RTOL)
    assert all(torch.equal(ranks[1][k], ranks[0][k]) for k in ranks[0])


def test_spatial_eval_equals_the_strips_in_process(tmp_path):
    H, halo = 256, 64
    ranks = W.run_ranks(W.spatial_eval_rank, 2, tmp_path, H, halo)
    model, x = W.checkerboard_model(4), W.images(1, 4, H)
    strips = [parallel.strip_forward(model, x, i, 2, halo) for i in range(2)]
    for r in ranks:
        assert torch.equal(r["x_hat"], torch.cat([s[0] for s in strips], dim=1))
        assert torch.equal(r["bits"], strips[0][1] + strips[1][1])


def test_strip_forward_keeps_jax_spatial_contract():
    """JAX's ``test_spatial_sharded_single_image_eval`` bars: 8 strips of
    128 rows, halo 128, against the unsharded forward."""
    model = W.checkerboard_model(5, 16, 24)
    strip, n = 128, 8
    H = strip * n
    x = W.images(1, 5, H)
    got = [parallel.strip_forward(model, x, i, n, halo=128) for i in range(n)]
    x_hat = torch.cat([g[0] for g in got], dim=1)
    with torch.no_grad():
        want = model(x, noisequant=False)["x_hat"]
    assert x_hat.shape == x.shape
    err = (x_hat - want).abs()[0].numpy()
    row = np.arange(H)
    dist = np.min(np.abs(row[:, None] - np.arange(strip, H, strip)[None, :]), axis=1)
    interior = dist > 48
    assert interior.sum() > H // 4
    assert err[interior].max() < 1e-4, err[interior].max()
    assert np.mean(err > 1e-2) < 0.02, np.mean(err > 1e-2)
    assert np.mean(err) < 1e-3, np.mean(err)
    bits = float(sum(g[1] for g in got))
    assert np.isfinite(bits) and bits > 0


def test_strip_forward_refuses_too_few_rows():
    model, x = W.checkerboard_model(), W.images(1, 0, 256)
    with pytest.raises(ValueError, match="needs 384 rows"):
        parallel.strip_forward(model, x, 0, 2, halo=128)
    with pytest.raises(ValueError, match="multiples of 64"):
        parallel.strip_forward(model, x, 0, 3, halo=64)


def test_torchrun_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "HYRES_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert not parallel.maybe_initialize_distributed("cpu")
    dp = parallel.data_parallel_mesh("cpu")
    assert (dp.group, dp.rank, dp.world) == (None, 0, 1)
    assert parallel.local_device("cuda") == torch.device("cuda")
    assert parallel.local_batch_slice(5) == 5

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert parallel.local_device("cuda") == torch.device("cuda", 1)
    assert parallel.local_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        parallel.maybe_initialize_distributed("cpu")

    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("HYRES_MULTIHOST", "1")
    assert parallel.maybe_initialize_distributed("cpu", timeout=30)
    try:
        assert not parallel.maybe_initialize_distributed("cpu")  # already joined
        dp = parallel.data_parallel_mesh("cpu")
        assert (dp.rank, dp.world) == (0, 1) and dp.group is not None
        t = torch.arange(3.0)
        assert torch.equal(dp.all_reduce_(t.clone()), t)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n,world", [(5, 2), (3, 2), (1, 2), (7, 3)])
def test_rows_cover_the_batch_in_order(n, world):
    dp = parallel.DataParallel(None, 0, world, torch.device("cpu"))
    spans = [dp.rows(n, r) for r in range(world)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert max(b - a for a, b in spans) - min(b - a for a, b in spans) <= 1
    batch = torch.arange(n)
    shards = [parallel.shard_batch(parallel.DataParallel(None, r, world, dp.device), batch)
              for r in range(world)]
    assert torch.equal(torch.cat(shards), batch)


# -- the CLIs under torch.distributed.run ----------------------------------------

TRAIN_ARGV = ["-e", "1", "--steps-per-epoch", "1", "--N", str(W.N), "--M", str(W.M),
              "--jpeg-quality", str(W.Q), "--patch-size", "64", "64", "--batch-size", "2",
              "--test-batch-size", "1", "--num-workers", "1", "--device", "cpu"]
REFINE_ARGV = ["-e", "1", "--steps-per-epoch", "1", "--N", str(W.N), "--M", str(W.M),
               "--jpeg-quality", str(W.Q), "--patch-size", "64", "64", "--batch-size", "2",
               "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A PNG dataset (4 train, 1 test images) and a seeded codec checkpoint."""
    from hyres_tpu_torch.train import save_checkpoint

    root = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.default_rng(9)
    for split, n, shape in (("train", 4, (80, 96, 3)), ("test", 1, (64, 128, 3))):
        (root / "ds" / split).mkdir(parents=True)
        for i in range(n):
            write_png(root / "ds" / split / f"{i}.png",
                      rng.integers(0, 256, shape, dtype=np.uint8))
    ckpt = root / "codec.msgpack"
    save_checkpoint({"params": to_flax(W.hyres_model(6))}, ckpt)
    return root, ckpt


def _torchrun(module: str, argv, cwd: Path) -> str:
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": str(ROOT)}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", module] + argv, cwd=cwd, env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _params(path: Path) -> dict:
    from hyres_tpu_torch.train import load_checkpoint

    return dict(_leaves(load_checkpoint(path)["params"]))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("cli", ["training", "refine_training"])
def test_cli_under_torchrun_writes_the_single_process_checkpoint(cli_env, tmp_path, cli):
    from hyres_tpu_torch.cli import refine_training, training

    root, ckpt = cli_env
    ds = str(root / "ds")
    if cli == "training":
        argv, name, main = (["-d", ds] + TRAIN_ARGV, "checkpoint_last_0.msgpack",
                            training.main)
        done = "training done"
    else:
        argv, name, main = (["-d", ds, "--checkpoint", str(ckpt)] + REFINE_ARGV,
                            "refine_last_0.msgpack", refine_training.main)
        done = "refine training done"
    out = _torchrun(f"hyres_tpu_torch.cli.{cli}", argv + ["--savepath", str(tmp_path / "dp")],
                    ROOT)
    assert out.count(done) == 1 and "ranks=2" in out  # rank 0 alone prints
    main(argv + ["--savepath", str(tmp_path / "one")])
    _adam_close(_params(tmp_path / "dp" / name), _params(tmp_path / "one" / name))


def test_only_rank_zero_writes(cli_env, tmp_path):
    root, ckpt = cli_env
    ranks = W.run_ranks(W.clis_rank, 2, tmp_path, str(root / "ds"), str(ckpt),
                        str(tmp_path / "out"), TRAIN_ARGV, REFINE_ARGV, wall=150.0)
    assert "checkpoint_last_0.msgpack" in ranks[0]["train"]
    assert "refine_last_0.msgpack" in ranks[0]["refine"]
    assert ranks[1] == {"train": [], "refine": []}
