"""Named spans inside the port, on the profiler's own clock.

``span(name)`` marks a stretch of host work as ``hyres.<name>``: a
``torch.profiler.record_function`` range while a ``torch.profiler``
session runs (the benchmark's traced slice, ``cli/inference.py
--profile``), and nothing otherwise. Being Kineto ranges, the spans share
the clock of the device's kernels and copies in ``prof.events()``, and a
span's parent is the span open around it.

A name's first part is its group: the roots ``compress.dispatch``,
``compress.finish``, ``decompress.dispatch``, ``decompress.wait`` and
``train.step``; ``model.*`` (the networks' launches), ``coder.*`` (rANS
and its wire), ``optim.*`` (the training step's guard, clip and Adams),
``jfif.*`` and ``dp.*``.

``record_function`` costs microseconds a call even with no profiler
running, so the off path is a single test of the profiler's flag.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``hyres.<name>`` under a running
    profiler, else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function("hyres." + name)
