"""Backend policy shared by every kernel wrapper of the port.

Counterpart of the backend policy at the top of ``repro/kernels/ops.py``:

  * entry points take ``device=``; ``None`` and ``"cuda"`` mean the CUDA
    device, ``"cpu"`` must be asked for explicitly. Without a CUDA device
    and without ``device="cpu"`` they raise — they never fall back.
  * a kernel wrapper looks at the tensors it is given: CPU tensors go to
    the kernel's plain PyTorch version (the role Pallas ``interpret=True``
    plays for the JAX package), CUDA tensors go to the hand-written kernel,
    anything else raises. There is no ``try`` that gives way to the plain
    version on the device.
"""

from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions.

    The reference numerics are fp32 storage with an fp32 accumulator; TF32
    keeps a 10-bit mantissa. cuDNN's flag defaults to True.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``"cpu"`` is asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        strict_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors.

    Mixed devices and other device types raise.
    """
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return True
    raise ValueError(
        f"kernel operands must all lie on the CPU or all on one CUDA "
        f"device, got {sorted(types)}"
    )


class LaunchCounter:
    """Per-kernel counts: kernel launches and plain-version calls."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
