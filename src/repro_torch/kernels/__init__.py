"""Hand-written Hopper kernels of the port and their plain versions.

``streaming_matmul`` (``csrc/streaming_mm.cu``) and the fused-region kernel
(``csrc/fused_region.cu``) are built with ``nvcc`` on first use; see
:mod:`repro_torch.kernels.build`.
"""

from repro_torch.kernels.fused import build_region_callable, region_torch
from repro_torch.kernels.ops import LaunchCounter, resolve_device, strict_fp32, use_kernel
from repro_torch.kernels.streaming import (
    streaming_conv2d,
    streaming_matmul,
    streaming_matmul_torch,
    streaming_tiles,
)

__all__ = [
    "LaunchCounter", "build_region_callable", "region_torch", "resolve_device",
    "streaming_conv2d", "streaming_matmul", "streaming_matmul_torch",
    "streaming_tiles", "strict_fp32", "use_kernel",
]
