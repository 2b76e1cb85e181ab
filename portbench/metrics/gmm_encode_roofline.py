"""The mixture encode's share of its bytes bound: the least bytes of the
profiled compresses' mixture coding (``counts/gmm.py``) at 3.35 TB/s, over
the device time of the program's row builder and encode scan
(``gmm_rows_kernel`` and ``encode_kernel`` of ``kernels/csrc/rans.cu``)
inside them."""

from portbench.lib.readers import roofline


def read(run):
    return roofline({**run, "coder_bytes": run.get("gmm_bytes")}, "compress",
                    r"\bgmm_rows_kernel\b|\bencode_kernel\b", "encode")
