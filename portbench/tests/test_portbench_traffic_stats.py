"""The traffic generator's seeding, and the arithmetic of the end-to-end
metrics over a whole window."""

from __future__ import annotations

import pytest
import torch

from portbench.lib import harness, spec, stats, traffic as T

SEEDS = (2 ** 31 + 5, 2 ** 31 + 6)


@pytest.fixture(scope="module")
def photos():
    return T.Photos(spec.resolve(spec.load_benchmark(), "hyres.serve-seq").traffic, "cpu")


def test_mosaic_is_the_four_flips(photos):
    m = photos.mosaic
    assert tuple(m.shape) == (1, 1536, 1024, 3)
    x = m[:, :768, :512]
    assert torch.equal(m[:, :768, 512:], x.flip(2))
    assert torch.equal(m[:, 768:, :512], x.flip(1))
    assert torch.equal(m[:, 768:, 512:], x.flip(1).flip(2))


def test_requests_are_reproducible_and_seeds_reorder_the_same_windows(photos):
    offs = T.requests({"grid": 6, "shapes": [[768, 512]]}, photos)
    assert len(set(offs)) == 36
    assert all(h == 768 and w == 512 and 0 <= oy <= 768 and 0 <= ox <= 512
               for h, w, oy, ox in offs)
    assert tuple(photos.window(offs[7]).shape) == (1, 768, 512, 3)
    a, b = (T.request_order(s, offs) for s in SEEDS)
    assert a == T.request_order(SEEDS[0], offs)
    assert a != b and sorted(a) == sorted(b) == sorted(offs)
    pa = [i for i in range(64) if T.sampled(SEEDS[0], i, 16)]
    assert pa == [i for i in range(64) if T.sampled(SEEDS[0], i, 16)] and len(pa) == 4


def test_the_stream_checks_every_slot_of_a_list():
    tr = spec.resolve(spec.load_benchmark(), "hyres.serve-stream2").traffic
    n, every = int(tr["list_len"]), int(tr["sample_every"])
    for seed in SEEDS:
        slots = {i % n for i in range(n * every) if T.sampled(seed, i, every)}
        assert slots == set(range(n))


def test_training_crops_are_reproducible_distinct_and_seeded(photos):
    tr = {"batch": 16, "crop": 256}
    a = T.crop_offsets(SEEDS[0], 3, tr, photos)
    assert a == T.crop_offsets(SEEDS[0], 3, tr, photos) and len(set(a)) == 16
    assert a != T.crop_offsets(SEEDS[1], 3, tr, photos)
    assert a != T.crop_offsets(SEEDS[0], 4, tr, photos)
    g1, g2 = (T.noise_generator(SEEDS[0], "cpu") for _ in range(2))
    n1, n2 = (T.train_noise({"z": (4, 1, 8)}, g, "cpu") for g in (g1, g2))
    assert torch.equal(n1["z"], n2["z"]) and n1["z"].abs().max() <= 0.5


def test_percentile_interpolates_between_ranks():
    v = list(range(1, 101))  # 1..100
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_a_stall_is_in_the_tail_and_the_rate_is_over_the_whole_window():
    walls = [0.020] * 99 + [0.500]  # one stalled request of 100
    assert stats.percentile(walls, 95) == pytest.approx(0.020)
    assert stats.percentile(walls, 99.5) == pytest.approx(0.2624)  # rank 98.505
    # 100 requests in a window that the stall stretched to 2.48 s
    assert stats.rate(100, sum(walls)) == pytest.approx(100 / 2.48)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_mixed_shapes_each_get_their_lattice(photos):
    reqs = T.requests({"grid": 3, "shapes": [[768, 512], [512, 768], [1536, 1024]]}, photos)
    assert T.shapes(reqs) == [(768, 512), (512, 768), (1536, 1024)]
    assert len(reqs) == 9 + 9 + 1  # the whole mosaic has one offset
    with pytest.raises(ValueError):
        T.requests({"grid": 2, "shapes": [[2048, 64]]}, photos)


def test_end_to_end_metrics_of_a_hand_made_window():
    cell = spec.resolve(spec.load_benchmark(), "hyres.serve-seq")
    rec = {"window_s": 2.0, "images": 4, "setup_s": 12.5,
           "calls": {"compress": [0.01, 0.02, 0.03, 0.04], "decompress": [0.1] * 4}}
    m = harness.read_metrics(cell.end_to_end, rec)
    assert set(m) == {"setup_s", "compress_p95_ms", "decompress_p95_ms"}
    assert m["compress_p95_ms"]["value"] == pytest.approx(38.5)
    assert m["decompress_p95_ms"] == {"value": pytest.approx(100.0), "unit": "ms"}
    assert m["setup_s"] == {"value": 12.5, "unit": "s"}
    train = spec.resolve(spec.load_benchmark(), "hyres.train-recipe")
    m = harness.read_metrics(train.end_to_end,
                             {"window_s": 4.0, "images": 320, "calls": {}, "setup_s": 30.0})
    assert m["train_images_per_s"]["value"] == pytest.approx(80.0)
