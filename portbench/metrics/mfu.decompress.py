"""Percent of the H100's FP32 peak reached by the window's decompress
calls: the reference's operations of each decompress, summed, over the
calls' summed host seconds."""

from portbench.lib.readers import mfu_calls


def read(run):
    return mfu_calls(run, "decompress")
