"""The 95th percentile, over every decompress of the window, of the host
seconds of one public decompress call (the payload in, the reconstruction
ready on the device)."""

from portbench.lib.readers import p95_ms


def read(run):
    return p95_ms(run, "decompress")
