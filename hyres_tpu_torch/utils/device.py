"""Device selection for the port's entry points, and the events that
let a caller wait for its own work on the card and no more."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; a missing
    card raises instead of falling back to the CPU, which runs only when
    the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        set_coder_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_coder_numerics() -> None:
    """Numerics for the coder-facing path on the card: full float32 in
    convolutions and matmuls (no TF32) and deterministic cuDNN algorithms,
    so the encoder's and decoder's entropy parameters come out equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions in full float32 (TF32 off) for the scope; the
    other cuDNN flags stay as they are and all are restored after."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark,
                 deterministic=c.deterministic, allow_tf32=False):
        yield


def record_event(device: torch.device):
    """A CUDA event recorded after the work queued so far on the current
    stream (None on the CPU, where every op has finished on return)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def wait_event(ev) -> None:
    """Wait until ``record_event``'s work is done (not for later work)."""
    if ev is not None:
        ev.synchronize()
