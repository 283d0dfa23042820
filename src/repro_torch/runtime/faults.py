"""Deterministic, seedable fault injection for the mesh of HMCs
(``repro/runtime/faults.py``).

A production mesh loses cubes and suffers stragglers; the paper's scaling
story (§4.9) assumes neither. This module supplies the failure model, kept
strictly deterministic so every chaos run is replayable:

  * :class:`FaultEvent` / :class:`ChaosSchedule` — *what* fails and
    *when*. Scripted specs name exact events (``"kill:hmc=1@step=2"``);
    seeded specs (``"random:seed=7,p_kill=0.02"``) draw per-(seed, step,
    cube) Bernoulli faults from a counter-keyed RNG, so the same seed
    replays the same fault history regardless of how the mesh is swept —
    and the same history as the JAX package's schedule.
  * :class:`RetryPolicy` — bounded retry with exponential backoff.
  * :class:`RecoveryTiming` / :func:`time_recovery` — the *modeled* cost
    of surviving a kill: detection (the weight exchange that never
    completes), parameter re-load, and the replayed step on the degraded
    mesh, in the cycle currency of
    :func:`repro_torch.runtime.mesh.time_mesh_step` (the NTX cycle model
    and the modeled links, not a time on any chip).
  * :class:`ChaosController` — the train-loop hook
    (:func:`repro_torch.lower.graph.train_graph`'s ``chaos=``): it
    intercepts each executed step BEFORE its outputs commit, so a killed
    cube's step is discarded, the program re-shards onto the survivors
    (:func:`repro_torch.lower.mesh.reshard_training_step`), and the same
    step replays; a preemption restores the latest checkpoint
    (:mod:`repro_torch.checkpoint`) and rewinds.

The model layer is plain Python and numpy; the controller imports the
re-sharder, the checkpoint store and the telemetry lazily.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

KINDS = ("kill", "straggle", "preempt")

_EVENT_RE = re.compile(
    r"^(?P<kind>kill|straggle|preempt)"
    r"(?::(?P<params>[a-z0-9_=.,]+))?"
    r"@step=(?P<step>\d+)$"
)


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault: ``kind`` at ``step``, targeting cube ``hmc``.

    ``hmc`` is a flat row-major cube id for kill/straggle and ``None``
    for a whole-job preemption; ``slow`` is the straggler's slowdown
    factor (its step takes ``slow`` times longer than its peers').
    """

    step: int
    kind: str
    hmc: int | None = None
    slow: float = 4.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (want {KINDS})")

    def describe(self) -> str:
        target = "job" if self.hmc is None else f"hmc{self.hmc}"
        extra = f" x{self.slow:g}" if self.kind == "straggle" else ""
        return f"{self.kind}:{target}@step{self.step}{extra}"


class ChaosSchedule:
    """A replayable fault schedule, scripted or seeded-random.

    Scripted grammar (events joined by ``;``)::

        kill:hmc=1@step=2
        straggle:hmc=0,slow=4@step=3
        preempt@step=5

    Seeded grammar::

        random:seed=7,p_kill=0.02,p_straggle=0.05,slow=4,max_kills=1

    draws one Bernoulli per (cube, step) from an RNG keyed on
    ``(seed, step, hmc)`` — the same seed yields the same fault history
    for any query order, and ``max_kills`` caps total cube deaths so a
    long run cannot chew through the whole mesh.
    """

    def __init__(self, events: list[FaultEvent] | None = None, *,
                 seed: int | None = None, p_kill: float = 0.0,
                 p_straggle: float = 0.0, slow: float = 4.0,
                 max_kills: int = 1):
        self.events = tuple(events or ())
        self.seed = seed
        self.p_kill = p_kill
        self.p_straggle = p_straggle
        self.slow = slow
        self.max_kills = max_kills
        self._kills_emitted = 0
        self._fired: set[tuple[int, str, int | None]] = set()

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        """Parse a ``--chaos`` spec (see the class docstring for the grammar)."""
        spec = spec.strip().lower()
        if not spec or spec == "none":
            return cls()
        if spec.startswith("random:"):
            kw: dict = {}
            for tok in spec[len("random:"):].split(","):
                k, _, v = tok.partition("=")
                if k in ("seed", "max_kills"):
                    kw[k] = int(v)
                elif k in ("p_kill", "p_straggle", "slow"):
                    kw[k] = float(v)
                else:
                    raise ValueError(f"unknown random-chaos key {k!r} in {spec!r}")
            if kw.get("seed") is None:
                raise ValueError(f"random chaos spec needs seed=: {spec!r}")
            return cls(**kw)
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            m = _EVENT_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad chaos event {part!r} "
                    "(want e.g. 'kill:hmc=1@step=2' or 'preempt@step=5')"
                )
            hmc, slow = None, 4.0
            for tok in filter(None, (m.group("params") or "").split(",")):
                k, _, v = tok.partition("=")
                if k == "hmc":
                    hmc = int(v)
                elif k == "slow":
                    slow = float(v)
                else:
                    raise ValueError(f"unknown chaos param {k!r} in {part!r}")
            kind = m.group("kind")
            if kind != "preempt" and hmc is None:
                raise ValueError(f"{kind!r} event needs hmc=: {part!r}")
            events.append(FaultEvent(int(m.group("step")), kind, hmc, slow))
        return cls(sorted(events, key=lambda e: e.step))

    def events_at(self, step: int, n_hmcs: int) -> list[FaultEvent]:
        """The faults firing at ``step``; each scripted event fires once."""
        out = []
        for e in self.events:
            key = (e.step, e.kind, e.hmc)
            if e.step == step and key not in self._fired:
                self._fired.add(key)
                out.append(e)
        if self.seed is not None and (self.p_kill or self.p_straggle):
            for h in range(n_hmcs):
                u = np.random.default_rng((self.seed, step, h)).random()
                if u < self.p_kill:
                    if self._kills_emitted < self.max_kills:
                        self._kills_emitted += 1
                        out.append(FaultEvent(step, "kill", h))
                elif u < self.p_kill + self.p_straggle:
                    out.append(FaultEvent(step, "straggle", h, self.slow))
        return out

    def __bool__(self) -> bool:
        return bool(self.events) or (
            self.seed is not None and bool(self.p_kill or self.p_straggle)
        )


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff (deterministic, no jitter).

    ``delay(attempt)`` for attempt = 0, 1, 2, ... is
    ``min(base_delay * factor**attempt, max_delay)``; after
    ``max_retries`` consecutive failures the caller gives up and
    re-raises.
    """

    max_retries: int = 3
    base_delay: float = 0.5
    factor: float = 2.0
    max_delay: float = 30.0

    def delay(self, attempt: int) -> float:
        if attempt < 0:
            raise ValueError(f"attempt {attempt} < 0")
        return min(self.base_delay * self.factor ** attempt, self.max_delay)

    def delays(self) -> list[float]:
        """The full backoff schedule, one delay per permitted retry."""
        return [self.delay(a) for a in range(self.max_retries)]


# ---------------------------------------------------------------------------
# Modeled recovery cost
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RecoveryTiming:
    """The modeled cost of surviving one cube kill, in seconds.

    ``t_detect``: the weight exchange that never completes — survivors
    notice the dead cube after one healthy update-time deadline.
    ``t_restore``: streaming the full parameter set back out to the
    survivors (one broadcast over the degraded ring).
    ``t_replay``: the discarded step re-executed on the degraded mesh.
    """

    t_detect: float
    t_restore: float
    t_replay: float
    healthy_step: float  # s, the steady-state healthy step (overhead basis)
    degraded_step: float  # s, the steady-state degraded step

    @property
    def t_total(self) -> float:
        return self.t_detect + self.t_restore + self.t_replay

    def cycles(self, f_ntx: float = 1.5e9) -> int:
        return int(round(self.t_total * f_ntx))

    @property
    def overhead_steps(self) -> float:
        """Recovery cost in units of healthy steps."""
        return self.t_total / self.healthy_step

    def summary(self) -> dict:
        return {
            "t_detect_ms": self.t_detect * 1e3,
            "t_restore_ms": self.t_restore * 1e3,
            "t_replay_ms": self.t_replay * 1e3,
            "t_total_ms": self.t_total * 1e3,
            "recovery_cycles": self.cycles(),
            "overhead_steps": self.overhead_steps,
        }


def time_recovery(healthy, degraded, *, n_clusters: int = 16,
                  f_ntx: float = 1.5e9, single_result=None) -> RecoveryTiming:
    """Model the recovery cost of going from ``healthy`` to ``degraded``.

    Both arguments are :class:`repro_torch.lower.mesh.ShardedTrainStep`\\ s
    over the same graph (``degraded`` from
    :func:`~repro_torch.lower.mesh.reshard_training_step`). Detection is
    one healthy update-time (the exchange the dead cube never answers),
    restore streams the parameter bytes over the survivor ring, and the
    replay is the degraded step itself — all through the link scheduler
    that times normal steps, so recovery cycles and steady-state cycles
    are one currency.
    """
    from repro_torch.runtime.mesh import MeshInterconnect, time_mesh_step

    t_healthy = time_mesh_step(healthy, n_clusters=n_clusters, f_ntx=f_ntx,
                               single_result=single_result)
    t_degraded = time_mesh_step(degraded, n_clusters=n_clusters, f_ntx=f_ntx,
                                single_result=single_result)
    rows, cols = healthy.mesh_shape
    net = MeshInterconnect(rows, cols, failed=degraded.failed_hmcs)
    w = healthy.allreduce_bytes
    t_detect = max(t_healthy.t_update, net.hop_latency)
    # one broadcast pass of the full parameters over the survivor ring
    t_restore = (w / net.link_bw + len(net.alive_nodes) * net.hop_latency
                 if degraded.n_alive > 1 else w / net.link_bw)
    return RecoveryTiming(
        t_detect=t_detect,
        t_restore=t_restore,
        t_replay=t_degraded.t_step,
        healthy_step=t_healthy.t_step,
        degraded_step=t_degraded.t_step,
    )


# ---------------------------------------------------------------------------
# The train-loop chaos hook
# ---------------------------------------------------------------------------


@dataclass
class ChaosAction:
    """What the controller wants the train loop to do instead of commit:
    discard the just-executed step and resume at ``resume_step``, with an
    optionally re-sharded ``program`` and/or rewound ``params``."""

    resume_step: int
    program: object | None = None
    params: dict | None = None


class ChaosController:
    """Drives :func:`repro_torch.lower.graph.train_graph` through injected faults.

    The loop calls three hooks:

      * ``start(program, params)`` — before step 0; writes the initial
        checkpoint (a preemption at step 0 must have something to rewind
        to) and returns the program to run.
      * ``intercept(step, outs, params)`` — after the step executed but
        BEFORE its outputs commit. Returns ``None`` (commit normally) or
        a :class:`ChaosAction` discarding the step: a **kill** re-shards
        onto the survivors and replays the same step; a **preempt**
        restores the latest checkpoint and rewinds. A **straggle** only
        records the event (the step's numerics are unaffected).
      * ``committed(step, params)`` — after the commit; checkpoints every
        ``ckpt_every`` steps.

    Because nothing commits until the step survives, a chaos run's losses
    and parameters are the healthy run's wherever the step's route gives
    the healthy step's bits. ``params`` may be torch tensors on any device
    (the checkpoint store copies them to the host, and a restore puts them
    back where the template's tensors are) or numpy arrays. Counters are
    booked under ``chaos/`` in the active registry.
    """

    def __init__(self, schedule: ChaosSchedule | str, *, sharded=None,
                 ckpt_dir=None, ckpt_every: int = 1,
                 retry: RetryPolicy | None = None, n_clusters: int = 16,
                 sleep_fn=None):
        if isinstance(schedule, str):
            schedule = ChaosSchedule.parse(schedule)
        self.schedule = schedule
        self.sharded = sharded  # ShardedTrainStep (None = single cube)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.retry = retry or RetryPolicy()
        self.n_clusters = n_clusters
        self.sleep_fn = sleep_fn if sleep_fn is not None else (lambda s: None)
        self.events: list[str] = []
        self.recoveries: list[RecoveryTiming] = []
        self.remesh_events = 0
        self.preemptions = 0
        self.straggler_events = 0
        self.backoffs: list[float] = []
        self._failures_in_a_row = 0
        self._last_ckpt_step = None

    # -- hooks ---------------------------------------------------------------

    def start(self, program, params):
        if self.ckpt_dir is not None:
            # The controller OWNS this directory: wipe leftovers from a
            # previous run so a preemption can never rewind into stale state.
            import shutil
            from pathlib import Path

            p = Path(self.ckpt_dir)
            if p.exists():
                shutil.rmtree(p)
            self._save(0, params)
            self._last_ckpt_step = 0
        return program

    def intercept(self, step: int, outs, params) -> ChaosAction | None:
        n = self.sharded.n_hmcs if self.sharded is not None else 1
        events = self.schedule.events_at(step, n)
        if not events:
            self._failures_in_a_row = 0
            return None
        action: ChaosAction | None = None
        for e in events:
            self.events.append(e.describe())
            if e.kind == "straggle":
                self.straggler_events += 1
                self._record("stragglers")
                continue
            self._backoff()
            if e.kind == "kill" and self.sharded is not None:
                if e.hmc in self.sharded.failed_hmcs:
                    continue  # already dead
                action = self._handle_kill(step, e)
            else:
                # a kill without a mesh takes the whole job down, like preempt
                action = self._handle_preempt(step, params)
        if action is None:
            self._failures_in_a_row = 0
        return action

    def committed(self, step: int, params):
        self._failures_in_a_row = 0
        if self.ckpt_dir is not None and (step + 1) % self.ckpt_every == 0:
            self._save(step + 1, params)
            self._last_ckpt_step = step + 1

    # -- fault handlers ------------------------------------------------------

    def _handle_kill(self, step: int, e: FaultEvent) -> ChaosAction:
        from repro_torch.lower.mesh import reshard_training_step

        healthy = self.sharded
        degraded = reshard_training_step(healthy, e.hmc)
        rec = time_recovery(healthy, degraded, n_clusters=self.n_clusters)
        self.recoveries.append(rec)
        self.remesh_events += 1
        self.sharded = degraded
        self._record("remesh_events")
        self._record("recovery_cycles", rec.cycles())
        self._trace_recovery(step, e, rec, degraded)
        self.events.append(
            f"reshard@step{step}: {degraded.n_alive}/{degraded.n_hmcs} alive, "
            f"recovery {rec.t_total * 1e3:.2f} ms"
        )
        return ChaosAction(resume_step=step, program=degraded.program)

    def _handle_preempt(self, step: int, params) -> ChaosAction:
        self.preemptions += 1
        self._record("preemptions")
        if self.ckpt_dir is None:
            # nothing on disk: replay from the current (uncommitted) params
            self.events.append(f"preempt@step{step}: no ckpt dir, replaying step")
            return ChaosAction(resume_step=step)
        from repro_torch.checkpoint import checkpoint as ckpt

        state, extras = ckpt.restore(self.ckpt_dir, params)
        resume = int(extras["step"])
        self.events.append(f"preempt@step{step}: restored step {resume}")
        return ChaosAction(resume_step=resume, params=state)

    # -- plumbing ------------------------------------------------------------

    def _backoff(self):
        if self._failures_in_a_row >= self.retry.max_retries:
            raise RuntimeError(
                f"gave up after {self._failures_in_a_row} consecutive "
                f"failures (RetryPolicy.max_retries={self.retry.max_retries})"
            )
        delay = self.retry.delay(self._failures_in_a_row)
        self._failures_in_a_row += 1
        self.backoffs.append(delay)
        self.sleep_fn(delay)

    def _save(self, step: int, params):
        from repro_torch.checkpoint import checkpoint as ckpt

        ckpt.save(self.ckpt_dir, step, params, extras={"step": step})

    def _record(self, name: str, value: float = 1):
        from repro_torch.obs import counters as obs

        reg = obs.get_active()
        if reg is not None:
            with reg.scope("chaos"):
                reg.inc(name, value)

    def _trace_recovery(self, step, e, rec, degraded):
        from repro_torch.obs import trace as obs_trace

        tc = obs_trace.get_active_trace()
        if tc is not None:
            tc.add_recovery(step, e, rec, degraded)

    def report(self) -> dict:
        return {
            "events": list(self.events),
            "remesh_events": self.remesh_events,
            "preemptions": self.preemptions,
            "straggler_events": self.straggler_events,
            "backoffs": list(self.backoffs),
            "recovery_cycles": sum(r.cycles() for r in self.recoveries),
            "alive_hmcs": (self.sharded.n_alive
                           if self.sharded is not None else 1),
        }
