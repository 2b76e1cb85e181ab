"""K7's share of its bound in the decompress: the least time of the profiled
decompresses' window attentions (``counts/window_attn.py``, on the
reference's attention calls), over the device time of the program's
``window_attn_kernel`` (``kernels/csrc/window_attn.cu``) inside them."""

from portbench.counts.window_attn import roofline


def read(run):
    return roofline(run, "decompress")
