"""The 95th percentile, over every compress of the window, of the host
seconds of one public compress call (one image; its bytes on the host)."""

from portbench.lib.readers import p95_ms


def read(run):
    return p95_ms(run, "compress")
