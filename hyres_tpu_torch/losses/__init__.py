from .metrics import ms_ssim, psnr

__all__ = ["ms_ssim", "psnr"]
