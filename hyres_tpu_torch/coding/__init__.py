from .cdf import pmf_to_quantized_cdf
from .rans import BufferedRansEncoder, RansDecoder, RansEncoder, RansLut

__all__ = ["BufferedRansEncoder", "RansDecoder", "RansEncoder", "RansLut",
           "pmf_to_quantized_cdf"]
