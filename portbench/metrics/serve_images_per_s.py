"""Roundtrips completed over the whole window, per second of it."""

from portbench.lib.readers import rate


def read(run):
    return rate(run)
