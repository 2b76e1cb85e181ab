from . import checkerboard, quantizer
from .layers import (GDN, AttentionBlock, CheckboardMaskedConv, Conv, Deconv,
                     MultiScaleRefine, PReLU, ResidualBlock, ResidualBlockUpsample,
                     ResidualBlockWithStride, ResidualBottleneckBlock, SEBlock,
                     SpatialAttention, SubpelConv3x3, conv1x1, conv3x3,
                     init_parameters, pixel_shuffle)
from .quantizer import quantize

__all__ = ["AttentionBlock", "CheckboardMaskedConv", "Conv", "Deconv", "GDN",
           "MultiScaleRefine", "PReLU", "ResidualBlock", "ResidualBlockUpsample",
           "ResidualBlockWithStride", "ResidualBottleneckBlock", "SEBlock",
           "SpatialAttention", "SubpelConv3x3", "checkerboard", "conv1x1",
           "conv3x3", "init_parameters", "pixel_shuffle", "quantize", "quantizer"]
