"""Data pipeline: flat-folder PNG dataset + batched loader (NHWC numpy).

Counterpart of ``hyres_tpu/train/data.py:35-167`` without PIL (the card's
machine has none): PNGs decode through ``utils/png.py read_png``; any
other image file raises an error that names it. The random stream is the
reference's: a loader generator seeded once, a shuffled order an epoch,
then per image ``default_rng(int(rng.integers(2**31)))``, whose draws pick
the rescale factor, the crop and the dihedral augment in the reference's
order; so, for a seed, the crops equal the reference's. Resizing (the
upscale of small images with a 1% buffer, and ``scale_range``) uses
``F.interpolate(mode="bilinear", antialias=True)`` rounded back to 8
bits, which approximates PIL's BILINEAR.
"""

from __future__ import annotations

import concurrent.futures
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.png import load_image, read_png, save_image  # noqa: F401  (re-exported)

_EXTS = {".png", ".jpg", ".jpeg", ".bmp"}
_CACHE_BYTES_CAP = 1 << 29  # 512 MB of decoded sources


def _resize(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (height, width, 3) uint8, bilinear with
    antialiasing."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None].to(torch.float32)
    out = F.interpolate(t, size=(height, width), mode="bilinear", align_corners=False,
                        antialias=True)
    return torch.clamp(torch.round(out[0]), 0, 255).to(torch.uint8).permute(1, 2, 0).numpy()


class ImageFolder:
    def __init__(self, root: str, split: str = "train",
                 patch_size: Optional[Tuple[int, int]] = (256, 256),
                 train: bool = True, augment: bool = False,
                 scale_range: Optional[Tuple[float, float]] = None):
        base = Path(root) / split
        if not base.is_dir():
            raise RuntimeError(f"missing dataset split directory: {base}")
        self.samples: List[Path] = sorted(
            p for p in base.iterdir() if p.suffix.lower() in _EXTS)
        if not self.samples:
            raise RuntimeError(f"no images found in {base}")
        other = [p for p in self.samples if p.suffix.lower() != ".png"]
        if other:
            raise ValueError(f"{other[0]}: only PNG datasets are supported (no image "
                             "decoder but PNG is available)")
        self.patch_size = patch_size
        self.train = train
        self.augment = augment and train
        self.scale_range = scale_range if train else None
        self._cache: dict = {}
        self._cache_bytes = 0

    def __len__(self) -> int:
        return len(self.samples)

    def _open(self, index: int) -> np.ndarray:
        """Decoded (H, W, 3) uint8 source; cached up to the cap."""
        hit = self._cache.get(index)
        if hit is not None:
            return hit
        arr = read_png(self.samples[index])
        if self._cache_bytes + arr.nbytes <= _CACHE_BYTES_CAP:
            self._cache[index] = arr
            self._cache_bytes += arr.nbytes
        return arr

    def load(self, index: int, rng: np.random.Generator) -> np.ndarray:
        img = self._open(index)
        if self.scale_range is not None and self.patch_size is not None:
            lo, hi = self.scale_range
            s = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            h, w = img.shape[:2]
            ph, pw = self.patch_size
            s = max(s, pw / w, ph / h)  # keep the crop in range
            if abs(s - 1.0) > 1e-3:
                img = _resize(img, max(pw, int(round(w * s))), max(ph, int(round(h * s))))
        if self.patch_size is not None:
            ph, pw = self.patch_size
            h, w = img.shape[:2]
            if w < pw or h < ph:
                # upscale with a 1% buffer (the reference's)
                scale = max(pw / w, ph / h) * 1.01
                img = _resize(img, int(w * scale) + 1, int(h * scale) + 1)
                h, w = img.shape[:2]
            if self.train:
                x0 = int(rng.integers(0, w - pw + 1))
                y0 = int(rng.integers(0, h - ph + 1))
            else:
                x0, y0 = (w - pw) // 2, (h - ph) // 2
            img = img[y0:y0 + ph, x0:x0 + pw]
        arr = img.astype(np.float32) / 255.0
        if self.augment:
            if arr.shape[0] == arr.shape[1]:
                k = int(rng.integers(8))  # D4 element: 4 rotations x flip
                if k & 4:
                    arr = arr[:, ::-1]
                arr = np.rot90(arr, k & 3)
            else:  # non-square crops: flips only
                k = int(rng.integers(4))
                if k & 1:
                    arr = arr[:, ::-1]
                if k & 2:
                    arr = arr[::-1]
        return np.ascontiguousarray(arr)


class DataLoader:
    """Shuffled, thread-pooled batch iterator over an ImageFolder:
    (B, H, W, 3) float32 numpy batches."""

    def __init__(self, dataset: ImageFolder, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.pool = concurrent.futures.ThreadPoolExecutor(max(1, num_workers))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        stop = (len(order) // self.batch_size * self.batch_size
                if self.drop_last else len(order))
        for i in range(0, stop, self.batch_size):
            idx = order[i: i + self.batch_size]
            seeds = [np.random.default_rng(int(self.rng.integers(2 ** 31))) for _ in idx]
            yield np.stack(list(self.pool.map(self.dataset.load, idx, seeds)))

    def close(self) -> None:
        self.pool.shutdown(wait=True)
