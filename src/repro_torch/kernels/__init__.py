"""Hand-written Hopper kernels of the port and their plain versions.

``streaming_matmul`` and the NTX matmul (reached through :func:`matmul`) on
one tensor-core GEMM of K-tile partials (``csrc/ntx_gemm_wgmma.cu``), the
fused-region kernel (``csrc/fused_region.cu``), the SSD scan
(``csrc/ssd_scan.cu``, reached through :func:`ssd`), flash attention
(``csrc/flash_attention_wgmma.cu`` and ``csrc/flash_attention.cu``, reached
through :func:`attention`) and the NTX direct convolution
(``csrc/conv2d_ntx_wgmma.cu`` and ``csrc/conv2d_ntx.cu``,
:func:`conv2d_ntx`) are built with ``nvcc`` on first use; see
:mod:`repro_torch.kernels.build`.
"""

from repro_torch.kernels.conv2d import conv2d_ntx
from repro_torch.kernels.fused import build_region_callable, region_torch
from repro_torch.kernels.ops import (LaunchCounter, attention, matmul, resolve_device, ssd,
                                     strict_fp32, use_kernel)
from repro_torch.kernels.streaming import (
    streaming_conv2d,
    streaming_matmul,
    streaming_matmul_torch,
    streaming_tiles,
)

__all__ = [
    "LaunchCounter", "attention", "build_region_callable", "conv2d_ntx", "matmul",
    "region_torch", "resolve_device", "ssd",
    "streaming_conv2d", "streaming_matmul", "streaming_matmul_torch",
    "streaming_tiles", "strict_fp32", "use_kernel",
]
