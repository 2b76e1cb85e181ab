"""nvcc build of the CUDA kernels into shared libraries, loaded by ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
-Xcompiler -fPIC`` turns each ``csrc/<name>.cu`` into its own library
``libhyres_<name>-<hash>.so`` in the package's git-ignored ``_build/``,
keyed by a hash of the source. The sources have a plain C interface (no
PyTorch headers), so a build takes seconds.

    python -m hyres_tpu_torch.kernels.build   # builds every library

builds the kernel libraries and the host coding library
(``coding/build.py``), one compiler process each, all started together,
and prints the seconds each took.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..coding import build as coding_build

_CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = "arch=compute_90a,code=sm_90a"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return str(path)


def sources() -> list[str]:
    """Names of the kernel sources: ``csrc/<name>.cu``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def ensure_built(name: str) -> Path:
    """Path of the library built from ``csrc/<name>.cu``, building it on
    first use."""
    return coding_build.build_cached(
        f"hyres_{name}", [_CSRC / f"{name}.cu"],
        lambda srcs, out: [nvcc(), "-gencode", ARCH, "-O3", "-std=c++17",
                           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           "-o", out, *srcs])


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(ensure_built(name)))


def build_all() -> dict:
    """Build every native library at once (one compiler process each);
    return {name: (path, seconds)}."""
    def timed(fn):
        t = time.perf_counter()
        path = fn()
        return path, time.perf_counter() - t

    jobs = {f"hyres_{n}": functools.partial(ensure_built, n) for n in sources()}
    jobs["hyres_coding"] = coding_build.ensure_built
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


if __name__ == "__main__":
    for name, (path, secs) in build_all().items():
        print(f"{name}: {path} ({secs:.2f} s)")
