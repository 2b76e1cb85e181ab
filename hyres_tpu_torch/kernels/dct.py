"""Blockwise DCT + quantize / dequantize + IDCT: CUDA kernels K1 and K2.

Replace the Pallas TPU kernels of ``hyres_tpu/kernels/dct.py``:
``fdct_quant_blocks`` (``_fdct_kernel``, K1) and ``dequant_idct_blocks``
(``_idct_kernel``, K2). Each is one (N, 64) @ (64, 64) product with the
Kronecker DCT matrix, ``vec(D X D^T) = (D (x) D) vec(X)``, fused with its
level shift, quantizer and clip. The kernels are in ``csrc/dct.cu``
(built by ``kernels/build.py``, bound with ctypes); the plain PyTorch
versions sit beside them as ``*_ref``.

The plane calls take every plane of a request (at most three) in one
launch and address the planes in place: ``fdct_quant_planes`` reads
(B, H, W) float32 pixel planes and writes (B, H/8, W/8, 8, 8) int32
coefficients; ``dequant_idct_planes`` reads such coefficient planes in
int8, int16 or int32 and writes (B, H, W) float32 planes. The (N, 64)
block calls are one-plane calls of the same kernels (N blocks are the
plane (N, 8, 8)).

Dispatch is by the tensors' device: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. Quant tables are host values
(numpy arrays, sequences or CPU tensors): they travel in the kernel's
parameters, so a call makes no host-device copy and never synchronises.
A CUDA table raises, since reading it would synchronise. ``LAUNCHES``
counts kernel launches (never plain-version calls).

Both the kernel and its plain version multiply by 1/q, as the TPU kernel
does (the reference's XLA path divides, ``hyres_tpu/jpeg/core.py:123``);
the two agree with that path except for rare ties at .5 (bar: at most
0.1% of coefficients off by one, ``tests/test_kernels.py:27-31``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

LAUNCHES = {"fdct_quant_blocks": 0, "dequant_idct_blocks": 0}

_MAX_PLANES = 3  # csrc/dct.cu kMaxPlanes
_K2_INPUTS = (torch.int8, torch.int16, torch.int32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def dct8() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix scaled per JPEG, D[u, x], float64."""
    x = np.arange(8)
    u = np.arange(8)[:, None]
    d = np.cos((2 * x + 1) * u * np.pi / 16) * 0.5
    d[0, :] *= 1 / np.sqrt(2)
    return d


KRON = np.kron(dct8(), dct8()).astype(np.float32)  # (64, 64): row uv, col xy


@functools.lru_cache(maxsize=None)
def _matrix(device: torch.device, forward: bool) -> torch.Tensor:
    """Right-multiply form: forward uses KRON^T, inverse uses KRON. One
    upload a process and device."""
    m = KRON.T if forward else KRON
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


def blockify(p: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8, W/8, 8, 8) view."""
    B, H, W = p.shape
    return p.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4)


def unblockify(b: torch.Tensor) -> torch.Tensor:
    """(B, nh, nw, 8, 8) -> (B, 8 nh, 8 nw)."""
    B, nh, nw, _, _ = b.shape
    return b.permute(0, 1, 3, 2, 4).reshape(B, nh * 8, nw * 8)


def host_table(qtbl) -> np.ndarray:
    """A quant table as 64 host float32s. Raises ValueError for a tensor
    that is not on the CPU."""
    if isinstance(qtbl, torch.Tensor):
        if qtbl.device.type != "cpu":
            raise ValueError(f"quant table must be a host value (numpy, sequence or "
                             f"CPU tensor), got a {qtbl.device} tensor")
        qtbl = qtbl.detach().numpy()
    t = np.asarray(qtbl, dtype=np.float32).reshape(-1)
    if t.size != 64:
        raise ValueError(f"quant table must hold 64 entries, got {t.size}")
    return t


# -- plain versions ----------------------------------------------------------


def fdct_quant_blocks_ref(blocks: torch.Tensor, qtbl) -> torch.Tensor:
    """Plain version of K1: (N, 64) pixels in [0, 255] -> (N, 64) int32."""
    x = blocks.to(torch.float32) - 128.0
    coef = x @ _matrix(blocks.device, True)
    q = coef * (1.0 / torch.as_tensor(qtbl, dtype=torch.float32, device=blocks.device))
    rounded = torch.sign(q) * torch.floor(torch.abs(q) + 0.5)
    return torch.clamp(rounded, -1023.0, 1023.0).to(torch.int32)


def dequant_idct_blocks_ref(coef: torch.Tensor, qtbl) -> torch.Tensor:
    """Plain version of K2: (N, 64) coefficients -> (N, 64) float32 pixels."""
    deq = coef.to(torch.float32) * torch.as_tensor(qtbl, dtype=torch.float32,
                                                   device=coef.device)
    pix = deq @ _matrix(coef.device, False) + 128.0
    return torch.clamp(pix, 0.0, 255.0)


def fdct_quant_planes_ref(planes: Sequence[torch.Tensor], qtables) -> List[torch.Tensor]:
    """Plain version of ``fdct_quant_planes``, one plane at a time."""
    out = []
    for p, q in zip(planes, qtables):
        blocks = blockify(p.to(torch.float32))
        coef = fdct_quant_blocks_ref(blocks.reshape(-1, 64), q)
        out.append(coef.reshape(blocks.shape))
    return out


def dequant_idct_planes_ref(coefs: Sequence[torch.Tensor], qtables) -> List[torch.Tensor]:
    """Plain version of ``dequant_idct_planes``, one plane at a time."""
    return [unblockify(dequant_idct_blocks_ref(c.reshape(-1, 64), q).reshape(c.shape))
            for c, q in zip(coefs, qtables)]


# -- kernels -----------------------------------------------------------------


class _PlaneC(ctypes.Structure):
    """``HykDctPlane`` of csrc/dct.cu."""

    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("in_bstride", ctypes.c_int64), ("B", ctypes.c_int32),
                ("H", ctypes.c_int32), ("W", ctypes.c_int32), ("pad", ctypes.c_int32)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("dct")
    lib.hyk_fdct_quant.argtypes = [ctypes.POINTER(_PlaneC), ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.hyk_dequant_idct.argtypes = [ctypes.POINTER(_PlaneC), ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    for fn in (lib.hyk_fdct_quant, lib.hyk_dequant_idct):
        fn.restype = ctypes.c_int
    return lib


def _check_planes(name: str, xs: Sequence[torch.Tensor], ndim: int,
                  dtypes: Sequence[torch.dtype]) -> None:
    """What the kernel takes: at most three CUDA planes on one device, of
    one dtype, each image contiguous and 16-byte aligned, H and W
    multiples of 8. Anything else raises ValueError."""
    if len(xs) > _MAX_PLANES:
        raise ValueError(f"{name}: at most {_MAX_PLANES} planes a launch")
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: kernel input must be a CUDA tensor, got {x.device}")
        if x.device != xs[0].device or x.dtype != xs[0].dtype:
            raise ValueError(f"{name}: planes must share one device and dtype")
        if x.dtype not in dtypes:
            raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {x.dtype}")
        if x.dim() != ndim or (ndim == 3 and (x.shape[1] % 8 or x.shape[2] % 8)) or (
                ndim == 5 and tuple(x.shape[3:]) != (8, 8)):
            raise ValueError(f"{name}: bad plane shape {tuple(x.shape)} (H and W must be "
                             "multiples of 8)")
        if x.numel() == 0:
            continue
        if not x[0].is_contiguous():
            raise ValueError(f"{name}: each image of a plane must be contiguous")
        if x.data_ptr() % 16 or (x.shape[0] > 1 and x.stride(0) * x.element_size() % 16):
            raise ValueError(f"{name}: planes and their images must be 16-byte aligned")


def _launch(name: str, xs, qtables, outs, forward: bool) -> None:
    descs = (_PlaneC * len(xs))()
    for d, x, o in zip(descs, xs, outs):
        d.inp, d.out = x.data_ptr(), o.data_ptr()
        d.in_bstride, d.B = x.stride(0), x.shape[0]
        d.H, d.W = (x.shape[1], x.shape[2]) if forward else (8 * x.shape[1], 8 * x.shape[2])
    tabs = np.ascontiguousarray(np.stack(qtables), dtype=np.float32)
    m = _matrix(xs[0].device, forward)
    lib = _lib()
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream(xs[0].device).cuda_stream
        if forward:
            rc = lib.hyk_fdct_quant(descs, len(xs), tabs.ctypes.data, m.data_ptr(), stream)
        else:
            rc = lib.hyk_dequant_idct(descs, len(xs), tabs.ctypes.data,
                                      xs[0].element_size(), m.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    if sum(x.numel() for x in xs):
        LAUNCHES[name] += 1


def _dispatch(planes, qtables):
    """(the planes as a list, True where the plain version runs: every
    plane on the CPU)."""
    planes = list(planes)
    if len(planes) != len(qtables):
        raise ValueError(f"{len(planes)} planes but {len(qtables)} quant tables")
    cpu = bool(planes) and all(p.device.type == "cpu" for p in planes)
    return planes, cpu


def fdct_quant_planes(planes: Sequence[torch.Tensor], qtables) -> List[torch.Tensor]:
    """K1 on up to three (B, H, W) float32 planes in [0, 255] (H, W
    multiples of 8), one launch for all: -> per plane (B, H/8, W/8, 8, 8)
    int32 quantized coefficients (natural row-major order in a block).
    ``qtables``: one host quant table a plane."""
    planes, cpu = _dispatch(planes, qtables)
    if cpu:
        return fdct_quant_planes_ref(planes, [host_table(q) for q in qtables])
    _check_planes("fdct_quant_planes", planes, 3, (torch.float32,))
    tabs = [host_table(q) for q in qtables]
    outs = [torch.empty((p.shape[0], p.shape[1] // 8, p.shape[2] // 8, 8, 8),
                        dtype=torch.int32, device=p.device) for p in planes]
    if planes:
        _launch("fdct_quant_blocks", planes, tabs, outs, True)
    return outs


def dequant_idct_planes(coefs: Sequence[torch.Tensor], qtables) -> List[torch.Tensor]:
    """K2 on up to three (B, nh, nw, 8, 8) coefficient planes of one dtype
    (int8, int16 or int32), one launch for all: -> per plane
    (B, 8 nh, 8 nw) float32 pixels in [0, 255]. ``qtables``: one host
    quant table a plane."""
    coefs, cpu = _dispatch(coefs, qtables)
    if cpu:
        return dequant_idct_planes_ref(coefs, [host_table(q) for q in qtables])
    _check_planes("dequant_idct_planes", coefs, 5, _K2_INPUTS)
    tabs = [host_table(q) for q in qtables]
    outs = [torch.empty((c.shape[0], 8 * c.shape[1], 8 * c.shape[2]),
                        dtype=torch.float32, device=c.device) for c in coefs]
    if coefs:
        _launch("dequant_idct_blocks", coefs, tabs, outs, False)
    return outs


def _check_blocks(name: str, x: torch.Tensor, dtypes: Sequence[torch.dtype]) -> None:
    if x.dtype not in dtypes or x.dim() != 2 or x.shape[1] != 64:
        raise ValueError(f"{name}: expected (N, 64) {' or '.join(map(str, dtypes))}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def fdct_quant_blocks(blocks: torch.Tensor, qtbl) -> torch.Tensor:
    """K1: (N, 64) float32 pixel blocks in [0, 255] -> (N, 64) int32
    quantized coefficients (natural row-major order within a block)."""
    if blocks.device.type == "cpu":
        return fdct_quant_blocks_ref(blocks, host_table(qtbl))
    _check_blocks("fdct_quant_blocks", blocks, (torch.float32,))
    n = blocks.shape[0]
    return fdct_quant_planes([blocks.view(n, 8, 8)], [qtbl])[0].view(n, 64)


def dequant_idct_blocks(coef: torch.Tensor, qtbl) -> torch.Tensor:
    """K2: (N, 64) int8, int16 or int32 quantized coefficients -> (N, 64)
    float32 pixels in [0, 255]."""
    if coef.device.type == "cpu":
        return dequant_idct_blocks_ref(coef, host_table(qtbl))
    _check_blocks("dequant_idct_blocks", coef, _K2_INPUTS)
    n = coef.shape[0]
    return dequant_idct_planes([coef.view(n, 1, 1, 8, 8)], [qtbl])[0].view(n, 64)
