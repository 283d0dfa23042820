"""Wide-accumulation numerics — the NTX FMAC datapath (paper §2.3, Table 1).

A copy of ``repro/core/precision.py`` on tensors. NTX sums products into a
wide accumulator and rounds once at the store; in fp32 the same effect comes
from branch-free two-float arithmetic:

  * ``two_sum``  — Knuth's error-free addition, a + b = s + e exactly;
  * ``two_prod`` — Dekker's error-free product through a Veltkamp split (no
    FMA: a fused multiply-add would change ``e``);
  * ``wide_sum`` / ``wide_dot`` — compensated reductions whose error is
    O(eps), not O(n eps). They walk the axis in order, as JAX's ``lax.scan``
    does, so the two packages round at the same points.

Every function takes and returns tensors of one floating type. PyTorch on the
CPU keeps subnormals (``torch.set_flush_denormal`` is off by default), so the
identities hold there too; XLA on the CPU flushes them.
"""

from __future__ import annotations

import torch

# Veltkamp split constant for fp32: 2**ceil(24/2) + 1.
_SPLIT_F32 = 4097.0


def two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-free transformation: a + b = s + e exactly (Knuth 2Sum)."""
    s = a + b
    bp = s - a
    ap = s - bp
    e = (a - ap) + (b - bp)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2Sum specialization valid when |a| >= |b| (Dekker). 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Veltkamp split of an fp32 value into high/low halves (12+12 bits)."""
    c = _SPLIT_F32 * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-free transformation: a * b = p + e exactly (Dekker two-product).

    Exact when the error term does not underflow (|a b| well above the fp32
    subnormal range), the classical precondition.
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def wide_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Compensated (Neumaier) sum along ``axis``, element by element in order."""
    x = torch.movedim(x, axis, 0)
    s = torch.zeros_like(x[0])
    c = torch.zeros_like(x[0])
    for xi in x:
        s, e = two_sum(s, xi)
        c = c + e
    return s + c


def wide_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated inner product over the last axis: error ~ eps, not n eps.

    Each product is split error-free (``two_prod``); the products and both
    error streams are summed with compensation, in order.
    """
    a2 = torch.movedim(a, -1, 0)
    b2 = torch.movedim(b, -1, 0)
    shape = torch.broadcast_shapes(a2.shape[1:], b2.shape[1:])
    s = torch.zeros(shape, dtype=a.dtype, device=a.device)
    c = torch.zeros_like(s)
    for ai, bi in zip(a2, b2):
        p, ep = two_prod(ai, bi)
        s, es = two_sum(s, p)
        c = c + (ep + es)
    return s + c


def kahan_step(s: torch.Tensor, c: torch.Tensor,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One Neumaier update step: (s, c) += x."""
    t, e = two_sum(s, x)
    return t, c + e
