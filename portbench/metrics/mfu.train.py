"""Percent of the H100's FP32 peak over the whole training window: the
reference's operations of one RD step (forward and backward), times the
steps, over the window's seconds."""

from portbench.lib.readers import mfu_window


def read(run):
    return mfu_window(run)
