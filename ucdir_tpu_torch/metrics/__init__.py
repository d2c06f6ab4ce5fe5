"""In-loop metrics (tensor2img, save, PSNR, SSIM; reference core/metrics.py)
and the offline ones: the BasicSR-grade PSNR/SSIM of `ssim.py`, NIQE
(`niqe.py`), LPIPS (`lpips.py`), InceptionV3 and FID/KID/IS (`inception.py`,
`fid.py`), on weights the user supplies. Counterpart of
`ucdir_tpu/metrics/`."""
from ucdir_tpu_torch.metrics.core import (tensor2img, save_img, save_jpg,
                                          calculate_psnr, calculate_ssim)
