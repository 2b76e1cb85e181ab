"""Percent of the H100's FP32 peak over the whole window of the stream:
the reference's operations of the roundtrips completed, over the window's
seconds."""

from portbench.lib.readers import mfu_window


def read(run):
    return mfu_window(run)
