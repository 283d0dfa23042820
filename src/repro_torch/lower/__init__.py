"""Training-graph IR, NTX command compiler, region fuser and executors of the port.

    graph = paper_cnn_graph(batch=64, img=32)
    prog  = lower_training_step(graph)            # one NtxProgram per step
    outs  = run_reference(prog, inputs)           # command by command (ntx_exec)
    outs  = run_torch(graph, inputs)              # region kernels (fused)
    res   = run_timing(prog, n_clusters=16)       # the NTX cycle model

    lm = NetworkGraph.from_model_config(cfg, batch=2, seq=64)  # a decoder-only LM DAG

    sharded = shard_training_step(graph, mesh_shape=(2, 2))  # a mesh of HMCs, "1d" / "2d"
    outs    = run_torch(sharded.program, inputs)  # the mesh route (executors.mesh_route)
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
    lm_token_batches,
    lower_training_step,
    one_hot_rows,
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
from repro_torch.lower.mesh import (
    ShardedTrainStep,
    parse_mesh,
    reshard_training_step,
    shard_training_step,
)
from repro_torch.lower.rules import (
    PASSES,
    AttentionSpec,
    BiasSpec,
    Conv2dSpec,
    EmbeddingSpec,
    FlattenSpec,
    LayerNormSpec,
    MatmulSpec,
    MaxPool2dSpec,
    PosEmbedSpec,
    ReluSpec,
    ResidualAddSpec,
    SgdUpdateSpec,
    SoftmaxXentSpec,
    lower,
    lower_layer,
    register_lowering,
    supported_matrix,
)

__all__ = [
    "ELEM_BYTES", "PASSES", "AttentionSpec", "BiasSpec", "CommandBlock", "Conv2dSpec",
    "DesignPoint", "EmbeddingSpec", "FlattenSpec", "FusionPlan", "GraphNode",
    "LayerNormSpec", "LivenessAllocator", "MatmulSpec", "MaxPool2dSpec", "NS_DESIGN",
    "NTX_DESIGN", "NetworkGraph", "NtxProgram", "PlanCache", "PosEmbedSpec",
    "RegionAllocator", "RegionSpec", "ReluSpec", "ResidualAddSpec", "Segment",
    "SgdUpdateSpec", "ShardedTrainStep", "SoftmaxXentSpec", "Stage", "TensorRegion",
    "edge_consumers", "frequency_band_batches", "lm_token_batches", "lower",
    "lower_layer", "lower_training_step", "one_hot_rows", "paper_cnn_graph",
    "parse_mesh", "plan_fusion", "register_lowering", "reshard_training_step",
    "run_reference", "run_timing", "run_torch", "shard_training_step",
    "softmax_xent_loss", "step_schedule", "supported_matrix", "train_graph",
]
