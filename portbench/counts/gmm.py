"""The least bytes of the Gaussian-mixture coding of y, counted from a
request's shapes and payload, independent of how the program splits the
work into kernels.

Encode (the rows' build and the scan that codes y, with z's plane, which
shares the scan's launch): each y element's K (logit, mean, scale) read
once (12 K bytes), each y and z symbol read once (2 bytes), z's CDF table
read once, and the y and z streams written once. Decode (the rows' build
and the y decodes): the parameters read once, each y symbol written once,
the y stream read once.
"""

from __future__ import annotations

from . import CDF_BYTES, SYMBOL_BYTES, _nbytes, prior_table_entries

PARAM_BYTES = 4  # float32


def _count(s) -> int:
    return int(s.numel()) if hasattr(s, "numel") else int(s.size)


def gmm_bytes(W: dict, payloads, K: int) -> dict:
    """Per request of the profiled slice: {"encode": [...], "decode":
    [...]} least bytes."""
    z_table = CDF_BYTES * prior_table_entries(W)
    enc, dec = [], []
    for p in payloads:
        syms = p["symbols"]
        n_z, n_y = _count(syms[0]), sum(_count(s) for s in syms[1:])
        y_stream, z_stream = _nbytes(p["strings"][0]), _nbytes(p["strings"][1])
        y_work = 3 * K * PARAM_BYTES * n_y + SYMBOL_BYTES * n_y + y_stream
        enc.append(y_work + SYMBOL_BYTES * n_z + z_stream + z_table)
        dec.append(y_work)
    return {"encode": enc, "decode": dec}
