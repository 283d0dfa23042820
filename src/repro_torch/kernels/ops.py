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
    """Turn TF32 off for matmuls and cuDNN convolutions, and keep bf16
    matmuls from reducing in bf16.

    The reference numerics are fp32 storage with an fp32 accumulator; TF32
    keeps a 10-bit mantissa. cuDNN's flag defaults to True. A bf16 product
    must sum in fp32 and round once, as ``preferred_element_type=float32``
    followed by a cast does in the JAX package.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
    """Per-kernel counts: kernel launches and plain-version calls; a wrapper
    with more than one C entry also counts launches per entry."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        self.entries: dict[str, int] = {}

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.entries = {}


def matmul_block_k(k: int) -> int:
    """K tile of :func:`matmul`: the JAX wrapper's power of two, at most 128."""
    return min(128, 1 << (k - 1).bit_length()) if k < 128 else 128


def matmul(a: torch.Tensor, b: torch.Tensor, *, compensated: bool = False,
           out_dtype=torch.float32) -> torch.Tensor:
    """NTX wide-accumulation matmul (``repro/kernels/ops.py::matmul`` on its
    kernel route): the kernel for CUDA tensors, its plain version for CPU tensors.

    K tiles are the JAX wrapper's power-of-two block of at most 128
    (:func:`matmul_block_k`). The JAX wrapper pads M, N and K to whole
    blocks and slices the result; here the kernel and its plain version mask
    the ragged edges instead, which gives the same sums (zeros change neither
    ``acc`` nor 2Sum) without the copies. The output tiles set no result, so
    only K's block is chosen.
    """
    from repro_torch.kernels import ntx_matmul  # looked up at call time

    return ntx_matmul.tiled_matmul(a, b, block_k=matmul_block_k(a.shape[-1]),
                                   out_dtype=out_dtype, compensated=compensated)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, sm_scale: float | None = None, q_offset: int = 0,
              kv_valid_len: int | None = None) -> torch.Tensor:
    """Flash attention with GQA and causal / sliding-window masks
    (``repro/kernels/ops.py::attention`` on its kernel route).

    q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) -> o (B, Hq, Sq, D) in q's
    dtype: the kernel for CUDA tensors, its plain version for CPU tensors.
    ``sm_scale`` defaults to ``1/sqrt(D)``. As on the JAX kernel route, only
    the full prompt is served (``q_offset == 0``, ``kv_valid_len is None``).
    """
    if q_offset != 0 or kv_valid_len is not None:
        raise NotImplementedError(
            "attention with q_offset != 0 or kv_valid_len (the decode path, "
            "_blockwise_attention_xla) is not ported yet (ROADMAP A5: decode / KV cache)"
        )
    from repro_torch.kernels import flash_attention  # looked up at call time

    return flash_attention.flash_attention(q, k, v, causal=causal, window=window,
                                           sm_scale=sm_scale)


def ssd(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD scan (``repro/kernels/ops.py::ssd`` without ``return_state``).

    x (B, H, S, P), la (B, H, S), b / c (B, G, S, N) -> y (B, H, S, P):
    the kernel for CUDA tensors, its plain version for CPU tensors.
    """
    from repro_torch.kernels import ssd_scan  # looked up at call time

    return ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
