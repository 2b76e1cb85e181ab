from .bottleneck import (CdfTables, EntropyBottleneck, build_bottleneck_tables,
                         refit_model_quantiles, refit_quantiles)
from .bound import LIKELIHOOD_BOUND, lower_bound
from .gaussian import (SCALES_LEVELS, SCALES_MAX, SCALES_MIN, SYMBOL_BOUND,
                       build_gaussian_tables, build_indexes, dequantize,
                       gaussian_likelihood, get_scale_table, narrow_symbols_i16,
                       quantize_noise, quantize_ste, quantize_symbols,
                       quantize_symbols_i16)

__all__ = ["CdfTables", "EntropyBottleneck", "LIKELIHOOD_BOUND",
           "SCALES_LEVELS", "SCALES_MAX", "SCALES_MIN", "SYMBOL_BOUND",
           "build_bottleneck_tables", "build_gaussian_tables",
           "build_indexes", "dequantize", "gaussian_likelihood", "get_scale_table",
           "lower_bound", "narrow_symbols_i16", "quantize_noise", "quantize_ste",
           "quantize_symbols", "quantize_symbols_i16", "refit_model_quantiles",
           "refit_quantiles"]
