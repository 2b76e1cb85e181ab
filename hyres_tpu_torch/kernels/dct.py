"""Blockwise DCT + quantize / dequantize + IDCT: CUDA kernels K1 and K2.

Replace the Pallas TPU kernels of ``hyres_tpu/kernels/dct.py``:
``fdct_quant_blocks`` (``_fdct_kernel``, K1) and ``dequant_idct_blocks``
(``_idct_kernel``, K2). Each is one (N, 64) @ (64, 64) product with the
Kronecker DCT matrix, ``vec(D X D^T) = (D (x) D) vec(X)``, fused with its
level shift, quantizer and clip. The kernels are in ``csrc/dct.cu``
(built by ``kernels/build.py``, bound with ctypes); the plain PyTorch
versions sit beside them as ``*_ref``.

Dispatch is by the tensor's device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches (never plain-version calls).

Both the kernel and its plain version multiply by 1/q, as the TPU kernel
does (the reference's XLA path divides, ``hyres_tpu/jpeg/core.py:123``);
the two agree with that path except for rare ties at .5 (bar: at most
0.1% of coefficients off by one, ``tests/test_kernels.py:27-31``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

LAUNCHES = {"fdct_quant_blocks": 0, "dequant_idct_blocks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kron_dct_matrix() -> np.ndarray:
    x = np.arange(8)
    u = np.arange(8)[:, None]
    d = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    d[0, :] *= 1 / np.sqrt(2)
    return np.kron(d, d).astype(np.float32)  # (64, 64): row uv, col xy


KRON = _kron_dct_matrix()


@functools.lru_cache(maxsize=None)
def _matrix(device: torch.device, forward: bool) -> torch.Tensor:
    """Right-multiply form: forward uses KRON^T, inverse uses KRON."""
    m = KRON.T if forward else KRON
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


def fdct_quant_blocks_ref(blocks: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: (N, 64) pixels in [0, 255] -> (N, 64) int32."""
    x = blocks.to(torch.float32) - 128.0
    coef = x @ _matrix(blocks.device, True)
    q = coef * (1.0 / qtbl.to(device=blocks.device, dtype=torch.float32))
    rounded = torch.sign(q) * torch.floor(torch.abs(q) + 0.5)
    return torch.clamp(rounded, -1023.0, 1023.0).to(torch.int32)


def dequant_idct_blocks_ref(coef: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (N, 64) coefficients -> (N, 64) float32 pixels."""
    deq = coef.to(torch.float32) * qtbl.to(device=coef.device, dtype=torch.float32)
    pix = deq @ _matrix(coef.device, False) + 128.0
    return torch.clamp(pix, 0.0, 255.0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("dct")
    for fn in (lib.hyk_fdct_quant, lib.hyk_dequant_idct):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, dtype: torch.dtype, qtbl: torch.Tensor, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel input must be a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype != dtype or x.dim() != 2 or x.shape[1] != 64:
        raise ValueError(f"{name}: expected ({{N}}, 64) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if qtbl.numel() != 64 or qtbl.device != x.device:
        raise ValueError(f"{name}: qtbl must hold 64 entries on {x.device}")


def _launch(name: str, fn, x: torch.Tensor, qtbl: torch.Tensor,
            out_dtype: torch.dtype, forward: bool) -> torch.Tensor:
    q = qtbl.reshape(64).to(torch.float32).contiguous()
    m = _matrix(x.device, forward)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), m.data_ptr(), q.data_ptr(), out.data_ptr(),
                x.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


def fdct_quant_blocks(blocks: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    """K1: (N, 64) float32 pixel blocks in [0, 255] -> (N, 64) int32
    quantized coefficients (natural row-major order within a block)."""
    if blocks.device.type == "cpu":
        return fdct_quant_blocks_ref(blocks, qtbl)
    _check(blocks, torch.float32, qtbl, "fdct_quant_blocks")
    return _launch("fdct_quant_blocks", _lib().hyk_fdct_quant, blocks, qtbl,
                   torch.int32, True)


def dequant_idct_blocks(coef: torch.Tensor, qtbl: torch.Tensor) -> torch.Tensor:
    """K2: (N, 64) int32 quantized coefficients -> (N, 64) float32 pixels
    in [0, 255]."""
    if coef.device.type == "cpu":
        return dequant_idct_blocks_ref(coef, qtbl)
    _check(coef, torch.int32, qtbl, "dequant_idct_blocks")
    return _launch("dequant_idct_blocks", _lib().hyk_dequant_idct, coef, qtbl,
                   torch.float32, False)
