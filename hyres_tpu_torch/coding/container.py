"""HYC1: the self-describing file (.hyc) of one compressed image.

Counterpart of ``hyres_tpu/coding/container.py``, byte for byte: a 4-byte
magic, then one msgpack map wrapping a ``compress()`` output with the
model identity needed to decode it later (family, N/M, JPEG quality,
coder). It is written with the port's own msgpack codec
(``utils/flax_msgpack.py``), so no ``msgpack`` package is needed.

The ``coder`` field names the frame format in the reference's words: a
payload of the port's device coder is written as ``"tpu"``, because its
frames are byte-identical to the reference's TPU-coder frames
(``coding/device_rans.py is_device_frame``); ``coder_for_container``
maps ``"tpu"`` back to ``"device"`` on read. A .hyc of either package
decodes in the other.
"""

from __future__ import annotations

from typing import Any, Dict

from ..utils.flax_msgpack import packb, unpackb

MAGIC = b"HYC1"

#: compress() keys that belong in the container (timers, decoded symbols
#: and other telemetry are not part of the rate)
_PAYLOAD_KEYS = ("strings", "shape", "size", "jpeg_buffers")

# the container's word for each of the port's coders, and back
_WIRE_CODER = {"host": "host", "device": "tpu"}
_PORT_CODER = {"host": "host", "tpu": "device"}


def container_coder(coder: str) -> str:
    """The port's coder name -> the container's ("device" -> "tpu")."""
    return _WIRE_CODER[coder]


def coder_for_container(coder: str) -> str:
    """The container's coder name -> the port's ("tpu" -> "device")."""
    if coder not in _PORT_CODER:
        raise ValueError(f"unknown coder {coder!r} in HYC container")
    return _PORT_CODER[coder]


def _normalize(obj):
    """The compress() nest in msgpack-native types: tuples -> lists,
    bytearray/memoryview -> bytes, numpy scalars -> Python numbers."""
    if isinstance(obj, bytes):
        return obj
    if isinstance(obj, (bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):  # numpy scalar
        return obj.item()
    return obj


def pack_compressed(comp: Dict[str, Any], *, model: str, N: int, M: int,
                    jpeg_quality: int | None = None,
                    coder: str = "host") -> bytes:
    """One image's compress() output -> a HYC1 blob. ``coder`` is the
    port's name ("host" or "device")."""
    payload = {k: _normalize(comp[k]) for k in _PAYLOAD_KEYS if k in comp}
    return MAGIC + packb({
        "version": 1,
        "model": model,
        "N": int(N),
        "M": int(M),
        "jpeg_quality": None if jpeg_quality is None else int(jpeg_quality),
        "coder": container_coder(coder),
        "payload": payload,
    })


def unpack_compressed(blob: bytes) -> Dict[str, Any]:
    """A HYC1 blob -> its meta map, with ``payload`` holding the compress()
    dict (shape and size as tuples). ``coder`` stays the container's word;
    ``coder_for_container`` gives the port's."""
    if blob[:4] != MAGIC:
        raise ValueError(f"not a HYC1 container (magic {blob[:4]!r})")
    doc = unpackb(blob[4:])
    if doc.get("version") != 1:
        raise ValueError(f"unsupported HYC version {doc.get('version')!r}")
    payload = doc["payload"]
    for key in ("shape", "size"):
        if key in payload and payload[key] is not None:
            payload[key] = tuple(int(v) for v in payload[key])
    return doc
