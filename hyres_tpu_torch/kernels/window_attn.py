"""Windowed multi-head self-attention, W and SW: CUDA kernel K7.

The core of the Swin / SCUNet window attention (``WMSA``) that TCM's
transformer blocks run (``nn/swin.py WindowAttention``). It takes the
(B, H, W, 3C) output of the block's one ``Linear(C -> 3C)`` on the image
as it stands, and does the roll (SW), the window partition, the scores
with the relative-position bias and the SW mask, the softmax, the product
with v and the inverse partition and roll in one launch, by index
arithmetic (``csrc/window_attn.cu``, built by ``kernels/build.py``, bound
with ctypes): no rolled copy, no rearranged copy and no score tensor
reaches memory. The output is (B, H, W, C) in image order, the heads
concatenated, ready for the block's output projection.

Dispatch is by the tensors' device: CPU tensors take the plain version
(``window_attention_ref``, which gathers the windows through the same
index map, ``window_index``); CUDA tensors launch the kernel or raise.

``WINDOW_ATTN_STATS`` counts kernel launches (never plain-version calls)
and what they covered: ``windows`` (p x p windows of all images),
``shifted_windows`` (those of SW calls) and ``tokens``. A replayed dispatch
graph advances it by what its capture counted (``models/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

WINDOW_ATTN_STATS = {"launches": 0, "windows": 0, "shifted_windows": 0, "tokens": 0}

WINDOWS = (4, 8)          # csrc/window_attn.cu's instantiations
HEAD_DIMS = (8, 16, 32)


def relative_bias(params: torch.Tensor, window: int) -> torch.Tensor:
    """(heads, 2p - 1, 2p - 1) relative-position parameters -> the (heads,
    p^2, p^2) table B[h, i, j] = params[h, ri - rj + p - 1, ci - cj + p - 1]
    of tokens i = (ri, ci) and j = (rj, cj) of a window."""
    p = window
    r = torch.arange(p, device=params.device)
    rr = (r[:, None] * torch.ones_like(r)[None, :]).reshape(-1)  # token rows
    cc = (torch.ones_like(r)[:, None] * r[None, :]).reshape(-1)  # token columns
    dr = rr[:, None] - rr[None, :] + p - 1
    dc = cc[:, None] - cc[None, :] + p - 1
    return params[:, dr, dc].contiguous()


def window_index(H: int, W: int, window: int, shifted: bool, device) -> torch.Tensor:
    """(windows, p^2) flat pixel index y W + x of each token of each window
    of the image rolled by (-p/2, -p/2) for SW (in place for W): token (r, c)
    of window (wr, wc) is pixel ((wr p + r + s) mod H, (wc p + c + s) mod
    W), s = p/2 or 0. The kernel's own map."""
    p, s = window, (window // 2 if shifted else 0)
    wr = torch.arange(H // p, device=device)[:, None, None, None]
    wc = torch.arange(W // p, device=device)[None, :, None, None]
    r = torch.arange(p, device=device)[None, None, :, None]
    c = torch.arange(p, device=device)[None, None, None, :]
    y = (wr * p + r + s) % H
    x = (wc * p + c + s) % W
    return (y * W + x).reshape((H // p) * (W // p), p * p)


def shift_mask(H: int, W: int, window: int, device) -> torch.Tensor:
    """(windows, p^2, p^2) bool, True where SW cuts a query from a key: in
    the last row of windows, rows on two sides of p - p/2; in the last
    column of windows, columns on two sides of it."""
    p = window
    split = p - p // 2
    nwr, nwc = H // p, W // p
    side = torch.arange(p, device=device) >= split
    rside = side[:, None].expand(p, p).reshape(-1)
    cside = side[None, :].expand(p, p).reshape(-1)
    rcut = rside[:, None] != rside[None, :]
    ccut = cside[:, None] != cside[None, :]
    last_r = (torch.arange(nwr, device=device) == nwr - 1)[:, None].expand(nwr, nwc).reshape(-1)
    last_c = (torch.arange(nwc, device=device) == nwc - 1)[None, :].expand(nwr, nwc).reshape(-1)
    return (last_r[:, None, None] & rcut) | (last_c[:, None, None] & ccut)


def _check(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int) -> tuple:
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"window_attention: qkv must be (B, H, W, 3C), got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    if heads <= 0 or C % heads:
        raise ValueError(f"window_attention: {C} channels do not split into {heads} heads")
    if H % window or W % window:
        raise ValueError(f"window_attention: {H}x{W} is not a whole number of "
                         f"{window}x{window} windows")
    if tuple(bias.shape) != (heads, window * window, window * window):
        raise ValueError(f"window_attention: bias must be ({heads}, {window ** 2}, "
                         f"{window ** 2}), got {tuple(bias.shape)}")
    return B, H, W, C


def window_attention_ref(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int,
                         shifted: bool) -> torch.Tensor:
    """Plain version of K7, through ``window_index`` and ``shift_mask``."""
    B, H, W, C = _check(qkv, bias, heads, window)
    d = C // heads
    idx = window_index(H, W, window, shifted, qkv.device)
    t = qkv.reshape(B, H * W, 3, heads, d)[:, idx]  # (B, windows, p^2, 3, heads, d)
    q, k, v = t.unbind(3)
    s = torch.einsum("bwihd,bwjhd->bhwij", q, k) * (d ** -0.5) + bias[None, :, None]
    if shifted:
        s = s.masked_fill(shift_mask(H, W, window, qkv.device), float("-inf"))
    o = torch.einsum("bhwij,bwjhd->bwihd", torch.softmax(s, dim=-1), v)
    out = torch.empty((B, H * W, C), dtype=qkv.dtype, device=qkv.device)
    out[:, idx.reshape(-1)] = o.reshape(B, -1, C)
    return out.reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("window_attn")
    lib.hyk_window_attn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    *([ctypes.c_int] * 7), ctypes.c_float, ctypes.c_void_p]
    lib.hyk_window_attn.restype = ctypes.c_int
    return lib


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int,
                     shifted: bool) -> torch.Tensor:
    """K7: qkv (B, H, W, 3C) float32 -> (B, H, W, C) float32; ``bias`` the
    (heads, p^2, p^2) table of ``relative_bias``; ``shifted``: SW."""
    if qkv.device.type == "cpu":
        return window_attention_ref(qkv, bias, heads, window, shifted)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for a {qkv.device} tensor")
    B, H, W, C = _check(qkv, bias, heads, window)
    d = C // heads
    if window not in WINDOWS or d not in HEAD_DIMS:
        raise ValueError(f"window_attention: no kernel for window {window}, head width {d} "
                         f"(windows {WINDOWS}, widths {HEAD_DIMS})")
    for name, t in (("qkv", qkv), ("bias", bias)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != qkv.device:
            raise ValueError(f"window_attention: {name} must be contiguous float32 on "
                             f"{qkv.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"window_attention: {name} must be 16-byte aligned")
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = _lib().hyk_window_attn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W,
                                    C, window, d, int(shifted), d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"window_attention: kernel launch failed (cudaError {rc})")
    n = B * (H // window) * (W // window)
    WINDOW_ATTN_STATS["launches"] += 1
    WINDOW_ATTN_STATS["windows"] += n
    WINDOW_ATTN_STATS["shifted_windows"] += n if shifted else 0
    WINDOW_ATTN_STATS["tokens"] += B * H * W
    return out
