"""In-loop metrics (tensor2img, save, PSNR, SSIM; reference core/metrics.py)
and the BasicSR-grade PSNR/SSIM of `ssim.py`. Counterpart of
`ucdir_tpu/metrics/`, and LPIPS (`lpips.py`, on weights the user supplies);
Inception, FID and NIQE are not ported yet (ROADMAP.md)."""
from ucdir_tpu_torch.metrics.core import (tensor2img, save_img, save_jpg,
                                          calculate_psnr, calculate_ssim)
