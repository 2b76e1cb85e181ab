"""K4 and K5's share of their bytes bound: the least bytes of the profiled
decompresses' coder work at 3.35 TB/s, over the device time of the
program's decode kernels (``decode_warp_kernel`` of
``kernels/csrc/rans.cu``) inside them."""

from portbench.lib.readers import roofline


def read(run):
    return roofline(run, "decompress", r"decode_warp_kernel", "decode")
