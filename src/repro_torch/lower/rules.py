"""Layer specs of the training graph (counterpart of ``repro/lower/rules.py``).

Only the spec dataclasses are here: the same fields and derived properties
as the JAX package, frozen and hashable, so they key the plan cache and
region compilations. The NTX command-template lowerings are not part of
the port yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MatmulSpec:
    """C[m,n] = A[m,k] @ B[k,n] (row major). dw = A^T dY, dx = dY B^T."""

    m: int
    n: int
    k: int


@dataclass(frozen=True)
class Conv2dSpec:
    """One conv layer per image: NHWC x HWIO -> NHWC with N=1."""

    in_h: int
    in_w: int
    cin: int
    kh: int
    kw: int
    cout: int
    stride: int = 1
    padding: int = 0

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.padding - self.kh) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.padding - self.kw) // self.stride + 1


@dataclass(frozen=True)
class MaxPool2dSpec:
    in_h: int
    in_w: int
    c: int
    window: int = 2
    stride: int = 2

    @property
    def out_h(self) -> int:
        return (self.in_h - self.window) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w - self.window) // self.stride + 1


@dataclass(frozen=True)
class ReluSpec:
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class FlattenSpec:
    """A zero-copy reshape to 1-D per item."""

    in_shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.in_shape)


@dataclass(frozen=True)
class BiasSpec:
    """y[r, c] = x[r, c] + b[c] over ``rows`` broadcast rows (rows folds
    batch and any spatial extent). db reduces dy over the rows."""

    rows: int
    c: int


@dataclass(frozen=True)
class SoftmaxXentSpec:
    """Softmax-cross-entropy over (batch, classes) logits; only the gradient
    pass runs: dz = (softmax(z) - onehot) / batch."""

    batch: int
    classes: int


@dataclass(frozen=True)
class SgdUpdateSpec:
    """SGD weight update over a flat parameter of ``n`` elements:
    v_new = momentum * v + dW, w_new = w - lr * v_new (v_new = dW without
    momentum)."""

    n: int
    lr: float
    momentum: float = 0.0
