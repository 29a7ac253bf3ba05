"""Offline evaluation of generated clips: PSNR, SSIM, LPIPS and FVD
(counterpart of ``ccvs_tpu/eval``)."""

from ccvs_tpu_torch.eval.metrics import lpips, psnr, ssim, video_metrics
from ccvs_tpu_torch.eval.fvd import frechet_distance, fvd_from_videos

__all__ = ["psnr", "ssim", "lpips", "video_metrics", "frechet_distance", "fvd_from_videos"]
