"""Offload runtime of the port: command queues, DMA streaming, multi-cluster
scheduling — the NTX cycle model that :func:`repro_torch.lower.run_timing`
plays a lowered program through (``repro/runtime``'s timing modules).

- :mod:`repro_torch.runtime.cmdqueue`  — per-engine command FIFOs with depth,
  back-pressure and issue/retire timestamps; one driver feeding 8 NTX; the
  event engine and the block-replicated steady-state engine.
- :mod:`repro_torch.runtime.dma`       — double-buffered cluster DMA with TCDM
  bank conflicts and the shared HMC vault bandwidth cap.
- :mod:`repro_torch.runtime.scheduler` — loop-nest partitioning across
  clusters, queue feeding, chrome-trace timelines, and the event-driven
  counterpart of the analytical model.

Everything here is host arithmetic on integers: it takes no device and
computes no tensor. The mesh, fault and supervisor modules of the JAX
package are not ported yet.
"""

from repro_torch.runtime import cmdqueue, dma, scheduler  # noqa: F401
