"""Fused per-(slice, eb) quality sweep (PSNR / NRMSE of the quantization
proxy): the plain version in ``ref``, the CUDA kernel in
``csrc/quality.cu``, the public dispatch in ``ops``."""

from repro_torch.kernels.quality.ops import quality_sweep  # noqa: F401
from repro_torch.kernels.quality.ref import (  # noqa: F401
    DEFAULT_TILE,
    NRMSE_CAP,
    PSNR_CAP,
)
