"""K3's share of its bytes bound: the least bytes of the profiled
compresses' coder work at 3.35 TB/s, over the device time of the program's
encode kernel (``encode_kernel`` of ``kernels/csrc/rans.cu``) inside them."""

from portbench.lib.readers import roofline


def read(run):
    return roofline(run, "compress", r"\bencode_kernel\b", "encode")
