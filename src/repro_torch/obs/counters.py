"""Hierarchical performance counters for the NTX stack.

Counterpart of ``repro/obs/counters.py``.

A :class:`CounterRegistry` is a flat dict of ``scope/leaf -> number`` with a
stack of scope prefixes, so recording under ``with reg.scope("step0", "c1",
"fwd")`` lands on ``step0/c1/fwd/offloads``. The scheme deliberately mirrors
the lowering tags (``{node}:{pass}:{inner}``): :func:`record_program` walks a
program's blocks once and books each block's *closed-form* counts — the same
``n_commands`` / ``busy_cycles`` / ``dma_bytes`` arithmetic
:class:`repro_torch.lower.ir.NtxProgram` exposes — under the block's
node/pass scope. Registry totals therefore match the program's own
properties exactly (:func:`program_totals` is the cross-check;
``tests/test_torch_obs.py`` asserts equality).

Leaf names recorded by the stock instrumentation:

  ``offloads, staging_offloads, commands, busy_cycles, macs, dma_bytes,
  spill_bytes, fill_bytes`` (per program, via :func:`record_program`);
  ``timing/*_cycles`` (via :func:`record_schedule`);
  ``mesh/<pass>/link_transfers|link_hops|link_bytes`` and
  ``mesh/link_congestion_s`` (via :func:`record_link_schedule`);
  ``shard/*`` and ``reshard/*`` (the mesh splitter);
  ``plan_cache/hits|misses|calls`` and ``fusion/regions|fallback_dispatches|
  fused_commands|unfused_commands`` (the torch executor).

The counters are the *program's* arithmetic — what the NTX cube would
execute for the step — not a measurement of the device that computed the
numbers.

Zero overhead when disabled: instrument sites call :func:`get_active` (one
module-global read, returns ``None``) and skip everything else. Snapshots
are plain JSON dicts.
"""

from __future__ import annotations

from contextlib import contextmanager

_SEP = "/"

#: Process-wide active registry (None = instrumentation disabled).
_ACTIVE: "CounterRegistry | None" = None


def get_active() -> "CounterRegistry | None":
    """The currently installed registry, or None when telemetry is off."""
    return _ACTIVE


@contextmanager
def use_registry(reg: "CounterRegistry | None"):
    """Install ``reg`` as the process-wide active registry for the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = reg
    try:
        yield reg
    finally:
        _ACTIVE = prev


class CounterRegistry:
    """Hierarchical monotone counters with a pushdown scope prefix."""

    __slots__ = ("enabled", "_counters", "_prefix")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: dict[str, float] = {}
        self._prefix = ""

    # -- recording ----------------------------------------------------------

    @contextmanager
    def scope(self, *parts: str):
        """Push ``parts`` onto the scope prefix for the ``with`` block."""
        prev = self._prefix
        tail = _SEP.join(p for p in parts if p)
        self._prefix = f"{prev}{_SEP}{tail}" if prev and tail else (prev or tail)
        try:
            yield self
        finally:
            self._prefix = prev

    def inc(self, name: str, value: float = 1) -> None:
        if not self.enabled:
            return
        key = f"{self._prefix}{_SEP}{name}" if self._prefix else name
        self._counters[key] = self._counters.get(key, 0) + value

    # -- reading ------------------------------------------------------------

    def counters(self) -> dict[str, float]:
        """A copy of the flat ``scope/leaf -> value`` map."""
        return dict(self._counters)

    def get(self, key: str, default: float = 0) -> float:
        return self._counters.get(key, default)

    def total(self, leaf: str, prefix: str = "") -> float:
        """Sum of ``leaf`` across every scope under ``prefix``."""
        want = f"{_SEP}{leaf}"
        tot = 0
        for key, v in self._counters.items():
            if prefix and not key.startswith(prefix):
                continue
            if key == leaf or key.endswith(want):
                tot += v
        return tot

    def totals(self, prefix: str = "") -> dict[str, float]:
        """Aggregate every leaf name across scopes under ``prefix``."""
        out: dict[str, float] = {}
        for key, v in self._counters.items():
            if prefix and not key.startswith(prefix):
                continue
            leaf = key.rsplit(_SEP, 1)[-1]
            out[leaf] = out.get(leaf, 0) + v
        return out

    def tree(self) -> dict:
        """The counters as a nested dict (for pretty-printing)."""
        root: dict = {}
        for key, v in sorted(self._counters.items()):
            node = root
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return root

    # -- lifecycle ----------------------------------------------------------

    def snapshot(self) -> dict[str, float]:
        """JSON-safe copy of the counters (checkpoint ``extras`` friendly)."""
        return {k: float(v) for k, v in self._counters.items()}

    def restore(self, snap: dict[str, float]) -> None:
        """Roll the counters back to a :meth:`snapshot` (crash recovery)."""
        self._counters = {k: float(v) for k, v in (snap or {}).items()}

    def merge(self, other: "CounterRegistry | dict") -> None:
        """Add another registry's (or snapshot's) counters into this one."""
        src = other._counters if isinstance(other, CounterRegistry) else other
        for k, v in src.items():
            self._counters[k] = self._counters.get(k, 0) + v

    def clear(self) -> None:
        self._counters.clear()

    def __len__(self) -> int:
        return len(self._counters)

    def __bool__(self) -> bool:
        # A fresh registry is empty but NOT falsy — ``if reg:`` guards at
        # instrument sites must mean "is telemetry on", not "has counted".
        return True

    def __repr__(self) -> str:
        return f"CounterRegistry({len(self._counters)} counters, enabled={self.enabled})"


# ---------------------------------------------------------------------------
# Scope derivation from lowering tags
# ---------------------------------------------------------------------------


def block_scope(tag: str) -> tuple[str, ...]:
    """Map a block tag to its counter scope.

    ``"c1:fwd:..."`` -> ``("c1", "fwd")`` (the graph compiler's
    ``{node}:{pass}`` step keys), ``"spill:act1"``/``"fill:act1"`` ->
    ``("tcdm", "spill"|"fill")``, ``"allreduce:update:fc:upd[0]"`` ->
    ``("mesh", "allreduce")``, ``"allgather:w_c1[1]"`` ->
    ``("mesh", "allgather")`` (tags of the mesh epilogue, which the port
    does not lower yet). Anything else books under its first tag
    component (single-layer programs) or ``("untagged",)``.
    """
    if not tag:
        return ("untagged",)
    parts = tag.split(":")
    if parts[0] in ("spill", "fill"):
        return ("tcdm", parts[0])
    if parts[0] in ("allreduce", "allgather"):
        return ("mesh", parts[0])
    if len(parts) >= 2 and parts[1] in ("fwd", "dx", "dw", "upd"):
        return (parts[0], parts[1])
    return (parts[0],)


def _program_digest(program) -> dict[str, float]:
    """``scope/leaf -> value`` for one program, memoized on the program.

    A training loop records the SAME compiled program every step, so the
    per-block walk (properties, tag parsing) runs once; repeat recordings
    are a flat dict merge, which keeps the counters-on step wall close to
    the counters-off one.
    """
    digest = getattr(program, "_obs_digest", None)
    if digest is not None:
        return digest
    digest = {}

    def add(scope: tuple[str, ...], leaf: str, v: float) -> None:
        key = _SEP.join((*scope, leaf))
        digest[key] = digest.get(key, 0) + v

    for b in program.blocks:
        n = b.n_commands
        cycles = b.busy_cycles
        dma = (b.dma_bytes_in + b.dma_bytes_out) * n
        scope = block_scope(b.tag)
        add(scope, "staging_offloads" if b.is_staging else "offloads", n)
        add(scope, "commands", n)
        add(scope, "busy_cycles", cycles)
        add(scope, "dma_bytes", dma)
        if b.template.opcode == "mac":
            add(scope, "macs", cycles)
        if b.tag.startswith("spill:"):
            add(scope, "spill_bytes", b.dma_bytes_out * n)
        elif b.tag.startswith("fill:"):
            add(scope, "fill_bytes", b.dma_bytes_in * n)
    try:
        object.__setattr__(program, "_obs_digest", digest)
    except (AttributeError, TypeError):
        pass  # slotted/uncachable program: recompute per call
    return digest


def record_program(reg: CounterRegistry, program) -> None:
    """Book ``program``'s closed-form per-block counts into ``reg``.

    O(blocks) once per program, O(tags) after (:func:`_program_digest`).
    Totals across scopes equal the program's own properties:
    ``offloads == program.n_offloads``, ``commands == program.n_commands``,
    ``busy_cycles == program.busy_cycles``, ``dma_bytes ==
    program.dma_bytes``. MACs count one multiply-accumulate per active
    datapath cycle of ``mac``-opcode blocks (the NTX FPU issues one FMA per
    cycle), spill/fill bytes are the DMA traffic of the liveness
    allocator's spill blocks.
    """
    if reg is None or not reg.enabled:
        return
    for key, v in _program_digest(program).items():
        reg.inc(key, v)


def program_totals(program) -> dict[str, float]:
    """The closed-form totals :func:`record_program` must reproduce."""
    return {
        "offloads": program.n_offloads,
        "staging_offloads": program.n_staging_offloads,
        "commands": program.n_commands,
        "busy_cycles": program.busy_cycles,
        "dma_bytes": program.dma_bytes,
    }


def record_schedule(reg: CounterRegistry, result) -> None:
    """Book a :class:`ScheduleResult`'s cycle accounting under ``timing/``."""
    if reg is None or not reg.enabled:
        return
    s = result.summary()
    with reg.scope("timing"):
        reg.inc("scheduled_programs", 1)
        reg.inc("total_cycles", s["total_cycles"])
        reg.inc("exec_cycles", result.exec_cycles)
        reg.inc("dma_stall_cycles", s["dma_stall_cycles"])
        reg.inc("queue_stall_cycles", s["queue_stall_cycles"])
        reg.inc("overhead_cycles", s["overhead_cycles"])


def record_link_schedule(reg: CounterRegistry, schedule) -> None:
    """Book a :class:`~repro_torch.runtime.mesh.LinkSchedule`'s traffic
    under ``mesh/<pass>/``.

    One scheduled transfer = one hop on one directed link, so
    ``link_hops`` counts transfers and ``link_bytes`` sums their payloads;
    scoping by the transfer tag's head (``reduce_v``, ``bcast_h``,
    ``ring``, ...) makes per-pass link traffic rankable in the hotspot
    table while totals stay the whole schedule's.
    """
    if reg is None or not reg.enabled:
        return
    with reg.scope("mesh"):
        for st in schedule.transfers:
            head = (st.transfer.tag or "link").split(":")[0]
            with reg.scope(head):
                reg.inc("link_transfers", 1)
                reg.inc("link_hops", 1)
                reg.inc("link_bytes", st.transfer.num_bytes)
        reg.inc("link_congestion_s", schedule.congestion_time)
