from . import core, tables
from .bitstream import ParsedJpeg, assemble_jfif
from .core import (JpegCoefficients, decode_from_coefficients,
                   decode_with_qtables, encode_to_coefficients, jpeg_roundtrip,
                   scan_bits)

__all__ = ["JpegCoefficients", "ParsedJpeg", "assemble_jfif", "core",
           "decode_from_coefficients", "decode_with_qtables",
           "encode_to_coefficients", "jpeg_roundtrip", "scan_bits", "tables"]
