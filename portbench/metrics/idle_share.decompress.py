"""Percent of the profiled slice's decompress spans in which the device ran
nothing (the host path's share)."""

from portbench.lib.readers import idle_share


def read(run):
    return idle_share(run, "decompress")
