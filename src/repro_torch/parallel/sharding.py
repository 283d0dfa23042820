"""Sharding rules of the CNN layers (``repro/parallel/sharding.py``'s
``CNN_RULES`` and ``cnn_param_spec``).

The 2D mesh splitter (:mod:`repro_torch.lower.mesh`, ``shard="2d"``) reads
these rows to decide which layers split their output-channel replication
level across a mesh row. The rows follow the column-parallel convention of
the model zoo's rules: the *output-feature* axis goes on the model axis —
conv weights are HWIO so cout is last, matmul weights are [k, n] so n is
last, bias is (c,). Layers without a row (pool, relu, flatten) stay
data-split. The zoo's parameter and cache rules come with the rest of the
model zoo's training path.
"""

from __future__ import annotations

from typing import Any

#: the model (tensor-parallel) axis name
TP = "model"

# keyed by spec class name, as the JAX package keys them
CNN_RULES: dict[str, tuple] = {
    "Conv2dSpec": (None, None, None, TP),
    "MatmulSpec": (None, TP),
    "BiasSpec": (TP,),
}


def cnn_param_spec(spec: Any) -> tuple | None:
    """Layer-local partition tuple for a CNN layer spec, or None.

    Returns the ``CNN_RULES`` row for the spec's class (None when the layer
    has no tensor-sharding rule). A row containing :data:`TP` means the
    layer's output features are split across the model axis.
    """
    return CNN_RULES.get(type(spec).__name__)
