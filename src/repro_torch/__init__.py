"""PyTorch / CUDA port of the NTX training engine.

The package mirrors :mod:`repro` module by module and keeps its layouts
(NHWC activations, HWIO conv weights, ``(K, N)`` matmul weights) and its
parameter names, so the two can be held against each other on the same
inputs. It imports ``torch``, numpy and the standard library only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version. Hand-written Hopper kernels live in :mod:`repro_torch.kernels`
and are built with ``nvcc`` on first use.
"""
