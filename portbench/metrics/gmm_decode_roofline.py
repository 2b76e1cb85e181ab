"""The mixture decode's share of its bytes bound: the least bytes of the
profiled decompresses' mixture decoding (``counts/gmm.py``) at 3.35 TB/s,
over the device time of the program's row builder and mixture decode
(``gmm_rows_kernel``, and ``decode_warp_kernel`` of kind 3, ``kGmmRow``, of
``kernels/csrc/rans.cu``) inside them."""

from portbench.lib.readers import roofline


def read(run):
    return roofline({**run, "coder_bytes": run.get("gmm_bytes")}, "decompress",
                    r"\bgmm_rows_kernel\b|\bdecode_warp_kernel<\d+, 3>", "decode")
