"""Shared machinery of the entropy-coded codec wrappers.

Counterpart of ``hyres_tpu/models/base.py:26-131``: the coder choice,
baked CDF table state with ``update``/``install_tables``/
``_require_tables`` (which also build the device coder), and the
factorized-prior (z) plane coding ``_eb_encode``/``_eb_decode`` of the
host coder.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..entropy import (CdfTables, build_bottleneck_tables,
                       build_gaussian_tables, get_scale_table)
from ..utils.device import resolve_device


class CodecBase:
    """Holds the model, its device and the baked tables."""

    def __init__(self, model, clamp: Tuple[float, float] | None = (0.0, 1.0),
                 coder: str = "host", device="cuda"):
        """coder: "host" = C++ rANS with per-chunk framing (rate-optimal, but
        a host synchronisation between decode stages); "device" = the
        lane-parallel rANS coder on the card (``coding/device_rans.py``,
        the JAX package's "tpu" coder): the decode chain runs without a
        host synchronisation, at ~4 bytes a lane of extra stream."""
        if coder not in ("host", "device"):
            raise ValueError(f"unknown coder {coder!r} (choose 'host' or "
                             "'device')")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.clamp = clamp
        self.coder = coder
        self.scale_table = get_scale_table()
        self._scale_table_t = torch.from_numpy(self.scale_table).to(self.device)
        self.gauss_tables: CdfTables | None = None
        self.eb_tables: CdfTables | None = None
        self.device_coder = None

    def _after_tables(self) -> None:
        """(Re)build the device coder when the tables change."""
        if self.coder == "device":
            from .codec import DevicePlaneCoder

            self.device_coder = DevicePlaneCoder(self.eb_tables, self.scale_table,
                                                 self.device)

    def _eb_param_dict(self) -> dict:
        return self.model.entropy_bottleneck.param_dict()

    def update(self, force: bool = False) -> bool:
        """Bake the Gaussian scale-table CDFs and the factorized-prior CDFs."""
        if self.gauss_tables is not None and not force:
            return False
        self.gauss_tables = build_gaussian_tables(self.scale_table)
        self.eb_tables = build_bottleneck_tables(self._eb_param_dict())
        self._after_tables()
        return True

    def install_tables(self, tables: dict) -> None:
        """Install pre-baked CDF tables (an artifact's ``tables`` tree)."""
        def mk(d):
            return CdfTables(
                quantized_cdf=np.asarray(d["quantized_cdf"], np.int32),
                cdf_length=np.asarray(d["cdf_length"], np.int32),
                offset=np.asarray(d["offset"], np.int32))

        self.gauss_tables = mk(tables["gaussian"])
        self.eb_tables = mk(tables["bottleneck"])
        self._after_tables()

    def _require_tables(self):
        if self.gauss_tables is None or self.eb_tables is None:
            raise RuntimeError("call update() or install_tables() before "
                               "compress/decompress")

    # -- factorized-prior (z) coding ---------------------------------------

    def _eb_encode(self, z_sym: np.ndarray) -> List[bytes]:
        from .codec import _encode_planes

        C = z_sym.shape[-1]
        idx = np.ascontiguousarray(
            np.broadcast_to(np.arange(C, dtype=np.int32), z_sym.shape))
        return _encode_planes(z_sym, idx, self.eb_tables)

    def _eb_decode(self, strings: Sequence[bytes],
                   shape: Tuple[int, int]) -> np.ndarray:
        from .codec import _decode_planes

        C = self.eb_tables.cdf_length.shape[0]
        idx = np.ascontiguousarray(np.broadcast_to(
            np.arange(C, dtype=np.int32), (len(strings), *shape, C)))
        return _decode_planes(strings, idx, self.eb_tables)
