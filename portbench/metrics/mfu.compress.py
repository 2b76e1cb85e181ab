"""Percent of the H100's FP32 peak reached by the window's compress calls:
the reference's operations of each compress, summed, over the calls'
summed host seconds."""

from portbench.lib.readers import mfu_calls


def read(run):
    return mfu_calls(run, "compress")
