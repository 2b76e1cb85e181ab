from . import checkerboard, quantizer
from .layers import (GDN, AttentionBlock, CheckboardMaskedConv, Conv, Deconv,
                     MultiScaleRefine, PReLU, ResidualBottleneckBlock,
                     SEBlock, SpatialAttention, conv1x1, conv3x3, init_parameters)

__all__ = ["AttentionBlock", "CheckboardMaskedConv", "Conv", "Deconv", "GDN",
           "MultiScaleRefine", "PReLU", "ResidualBottleneckBlock", "SEBlock",
           "SpatialAttention", "checkerboard", "conv1x1", "conv3x3",
           "init_parameters", "quantizer"]
