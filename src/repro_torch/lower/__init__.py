"""Training-graph IR, region fuser and torch executor of the port."""

from repro_torch.lower.executors import PlanCache, run_torch
from repro_torch.lower.fuse import (
    FusionPlan,
    RegionSpec,
    Segment,
    Stage,
    plan_fusion,
    step_schedule,
)
from repro_torch.lower.graph import (
    GraphNode,
    NetworkGraph,
    edge_consumers,
    frequency_band_batches,
    paper_cnn_graph,
    softmax_xent_loss,
    train_graph,
)
from repro_torch.lower.rules import (
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    SgdUpdateSpec,
    SoftmaxXentSpec,
)

__all__ = [
    "BiasSpec", "Conv2dSpec", "FlattenSpec", "FusionPlan", "GraphNode",
    "MatmulSpec", "MaxPool2dSpec", "NetworkGraph", "PlanCache", "RegionSpec",
    "ReluSpec", "Segment", "SgdUpdateSpec", "SoftmaxXentSpec", "Stage",
    "edge_consumers", "frequency_band_batches", "paper_cnn_graph",
    "plan_fusion", "run_torch", "softmax_xent_loss", "step_schedule",
    "train_graph",
]
