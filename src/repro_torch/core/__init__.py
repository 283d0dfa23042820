"""Core numerics of the port: the strided-conv backward decomposition."""

from repro_torch.core.conv_decomp import (
    conv2d,
    conv2d_input_grad_decomposed,
    conv2d_weight_grad,
)

__all__ = ["conv2d", "conv2d_input_grad_decomposed", "conv2d_weight_grad"]
