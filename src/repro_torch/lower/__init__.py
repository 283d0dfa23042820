"""Training-graph IR, NTX command compiler, region fuser and executors of the port.

    graph = paper_cnn_graph(batch=64, img=32)
    prog  = lower_training_step(graph)            # one NtxProgram per step
    outs  = run_reference(prog, inputs)           # command by command (ntx_exec)
    outs  = run_torch(graph, inputs)              # region kernels (fused)
    res   = run_timing(prog, n_clusters=16)       # the NTX cycle model
"""

from repro_torch.lower.executors import PlanCache, run_reference, run_timing, run_torch
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
    lower_training_step,
    paper_cnn_graph,
    softmax_xent_loss,
    train_graph,
)
from repro_torch.lower.ir import (
    ELEM_BYTES,
    CommandBlock,
    DesignPoint,
    LivenessAllocator,
    NS_DESIGN,
    NTX_DESIGN,
    NtxProgram,
    RegionAllocator,
    TensorRegion,
)
from repro_torch.lower.rules import (
    PASSES,
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    SgdUpdateSpec,
    SoftmaxXentSpec,
    lower,
    lower_layer,
    register_lowering,
    supported_matrix,
)

__all__ = [
    "ELEM_BYTES", "PASSES", "BiasSpec", "CommandBlock", "Conv2dSpec", "DesignPoint",
    "FlattenSpec", "FusionPlan", "GraphNode", "LivenessAllocator", "MatmulSpec",
    "MaxPool2dSpec", "NS_DESIGN", "NTX_DESIGN", "NetworkGraph", "NtxProgram", "PlanCache",
    "RegionAllocator", "RegionSpec", "ReluSpec", "Segment", "SgdUpdateSpec",
    "SoftmaxXentSpec", "Stage", "TensorRegion", "edge_consumers", "frequency_band_batches",
    "lower", "lower_layer", "lower_training_step", "paper_cnn_graph", "plan_fusion",
    "register_lowering", "run_reference", "run_timing", "run_torch", "softmax_xent_loss",
    "step_schedule", "supported_matrix", "train_graph",
]
