"""NTX telemetry of the port: hierarchical counters, merged traces, reports
(``repro/obs``, without the mesh's link counters and lanes and without the
benchmark-artefact writers).

  * :mod:`repro_torch.obs.counters` — a hierarchical :class:`CounterRegistry`
    (scoped like ``step0/c1/fwd``) that the executors, the timing model and
    the plan cache record into when one is active. Totals equal the
    closed-form :class:`repro_torch.lower.ir.NtxProgram` counts — the
    counters *are* the program's arithmetic, not a parallel estimate.
  * :mod:`repro_torch.obs.trace` — merges the NTX cycle model's cluster
    exec/DMA lanes and the host's lowering and dispatch spans into one
    Perfetto-loadable chrome trace, with flow events tying a command block's
    lowering to its execution.
  * :mod:`repro_torch.obs.report` — per-step JSONL metrics and top-k hotspot
    tables.

Instrumentation costs one global read when disabled: every record site
starts with ``get_active()`` / ``get_active_trace()``, which return ``None``
unless a registry / collector was installed via ``use_registry`` /
``use_collector``.
"""

from repro_torch.obs.counters import (
    CounterRegistry,
    get_active,
    program_totals,
    record_program,
    record_schedule,
    use_registry,
)
from repro_torch.obs.report import (
    SCHEMA_VERSION,
    MetricsWriter,
    format_hotspots,
    hotspots,
    read_jsonl,
)
from repro_torch.obs.trace import TraceCollector, get_active_trace, use_collector

__all__ = [
    "CounterRegistry",
    "get_active",
    "record_program",
    "record_schedule",
    "program_totals",
    "use_registry",
    "SCHEMA_VERSION",
    "MetricsWriter",
    "format_hotspots",
    "hotspots",
    "read_jsonl",
    "TraceCollector",
    "get_active_trace",
    "use_collector",
]
