"""Losses and metrics (counterpart of ``hyres_tpu/losses``)."""


class AverageMeter:
    """Running average (``hyres_tpu/losses/__init__.py:4-18``)."""

    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


from .lpips import LPIPS, load_lpips  # noqa: E402
from .metrics import CompressionMetrics, ms_ssim, psnr  # noqa: E402
from .rd_loss import rate_distortion_loss  # noqa: E402
from .vgg import VGG16Features, VGGLoss  # noqa: E402

__all__ = ["LPIPS", "AverageMeter", "CompressionMetrics", "VGG16Features", "VGGLoss",
           "load_lpips", "ms_ssim", "psnr", "rate_distortion_loss"]
