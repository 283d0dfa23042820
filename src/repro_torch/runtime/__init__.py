"""Offload runtime of the port: command queues, DMA streaming, multi-cluster
scheduling and the mesh's links — the NTX cycle model that
:func:`repro_torch.lower.run_timing` plays a lowered program through
(``repro/runtime``'s timing modules).

- :mod:`repro_torch.runtime.cmdqueue`  — per-engine command FIFOs with depth,
  back-pressure and issue/retire timestamps; one driver feeding 8 NTX; the
  event engine and the block-replicated steady-state engine.
- :mod:`repro_torch.runtime.dma`       — double-buffered cluster DMA with TCDM
  bank conflicts and the shared HMC vault bandwidth cap.
- :mod:`repro_torch.runtime.scheduler` — loop-nest partitioning across
  clusters, queue feeding, chrome-trace timelines, and the event-driven
  counterpart of the analytical model.
- :mod:`repro_torch.runtime.mesh`      — the inter-HMC serial links (§4.9):
  per-link transfer scheduling with congestion, the 4-pass systolic weight
  update (eqs. 14-15), failed cubes (survivor-ring allreduce routed around
  dead cubes), and :func:`~repro_torch.runtime.mesh.time_mesh_step` /
  :func:`~repro_torch.runtime.mesh.time_mesh_step_2d` over sharded
  train-step programs.
- :mod:`repro_torch.runtime.faults`    — fault injection on the mesh: the
  replayable :class:`~repro_torch.runtime.faults.ChaosSchedule`, bounded
  retry, the modeled recovery cost (:func:`~repro_torch.runtime.faults.time_recovery`)
  and the :class:`~repro_torch.runtime.faults.ChaosController` that
  ``train_graph(chaos=)`` calls around every step.
- :mod:`repro_torch.runtime.supervisor` — the fault-tolerant training loop
  of the model-zoo trainer (``--backend xla``): checkpoint/restart from the
  latest complete checkpoint with the data iterator's state, elastic
  fallback meshes, straggler deadlines and bounded retry.

Everything here but the controller and the supervisor is host arithmetic:
it takes no device and computes no tensor.
"""

from repro_torch.runtime import cmdqueue, dma, faults, mesh, scheduler, supervisor  # noqa: F401
from repro_torch.runtime.faults import (
    ChaosAction,
    ChaosController,
    ChaosSchedule,
    FaultEvent,
    RecoveryTiming,
    RetryPolicy,
    time_recovery,
)
from repro_torch.runtime.supervisor import (
    FailureInjector,
    SimulatedFailure,
    SimulatedStraggler,
    StragglerPolicy,
    Supervisor,
    SupervisorReport,
)
from repro_torch.runtime.mesh import (
    CUBE_POWER_MESH,
    HMC_DRAM_BYTES,
    HOP_LATENCY,
    LINK_BW,
    P_LINKS,
    LinkSchedule,
    LinkTransfer,
    MeshInterconnect,
    MeshStepTiming,
    MeshStepTiming2D,
    ScheduledTransfer,
    expected_update_time,
    time_mesh_step,
    time_mesh_step_2d,
)

__all__ = [
    "ChaosAction", "ChaosController", "ChaosSchedule", "FaultEvent", "RecoveryTiming",
    "RetryPolicy", "time_recovery",
    "CUBE_POWER_MESH", "HMC_DRAM_BYTES", "HOP_LATENCY", "LINK_BW", "P_LINKS",
    "LinkSchedule", "LinkTransfer", "MeshInterconnect", "MeshStepTiming",
    "MeshStepTiming2D", "ScheduledTransfer", "expected_update_time", "time_mesh_step",
    "time_mesh_step_2d",
    "FailureInjector", "SimulatedFailure", "SimulatedStraggler", "StragglerPolicy",
    "Supervisor", "SupervisorReport",
]
