"""Fault-tolerant training supervisor: restart, elastic re-mesh, stragglers
(``repro/runtime/supervisor.py``).

The mechanisms are real; failures are injected:

  * **checkpoint/restart** — :class:`~repro_torch.checkpoint.checkpoint.AsyncCheckpointer`
    every ``ckpt_every`` steps; on failure the supervisor restores the
    latest complete checkpoint and resumes the data iterator at the
    restored step (a bit-identical stream: the (seed, step) contract of
    :mod:`repro_torch.data.pipeline`).
  * **elastic re-mesh** — after a crash the job goes on with the next entry
    of ``meshes`` (largest first). The entries are opaque to the
    supervisor: it hands each to ``make_step`` and ``init_state``. On one
    card the list is ``[None]``.
  * **straggler mitigation** — a per-step deadline from the paper's
    mesh-update model (eqs. 14-15) plus an EWMA of the step time; the
    policy is drop-and-rescale, and a straggler's step may be re-dispatched
    to a backup worker (the accounting and the log line; the step itself
    runs once, deterministically).
  * **failure detection** — heartbeats are the step returns themselves; a
    :class:`FailureInjector` raises at configured steps to exercise the
    recovery path deterministically.

Counters (``supervisor/steps``, ``restarts``, ``stragglers``,
``redispatches``) go to an :mod:`repro_torch.obs` registry, which rides the
checkpoint, and one JSON line a step to ``metrics_path``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.runtime.faults import RetryPolicy


def mesh_update_time_model(weight_bytes: float, mesh_side: int, link_bw: float = 60e9,
                           hop_latency: float = 20e-6) -> float:
    """Paper eqs. (14)-(15): T_update = 4 * (T_tx + N * T_lat)
    (``repro/core/systolic.py::mesh_update_time_model``)."""
    t_tx = weight_bytes / link_bw
    t_pass = t_tx + mesh_side * hop_latency
    return 4.0 * t_pass


class SimulatedFailure(RuntimeError):
    pass


class SimulatedStraggler(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic fault schedule: {step: kind}; kind in {"crash","straggler"}."""

    schedule: dict = field(default_factory=dict)

    def check(self, step: int):
        kind = self.schedule.get(step)
        if kind == "crash":
            # fire once
            del self.schedule[step]
            raise SimulatedFailure(f"injected crash at step {step}")
        if kind == "straggler":
            del self.schedule[step]
            raise SimulatedStraggler(f"injected straggler at step {step}")


@dataclass
class StragglerPolicy:
    """Deadline = ewma(compute) * slack + mesh update bound (paper eq. 14/15)."""

    slack: float = 3.0
    weight_bytes: float = 300e6  # paper's 300 MB update
    mesh_side: int = 16
    ewma: float | None = None

    def deadline(self) -> float:
        base = self.ewma if self.ewma is not None else 60.0
        return base * self.slack + mesh_update_time_model(self.weight_bytes, self.mesh_side)

    def observe(self, dt: float):
        self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: int = 0
    redispatches: int = 0
    remesh_events: int = 0
    backoffs: list = field(default_factory=list)  # seconds slept per retry
    log: list = field(default_factory=list)


class Supervisor:
    """Drives (train_step, iterator) to ``total_steps`` surviving failures."""

    def __init__(
        self,
        make_step,  # (mesh) -> train_step callable
        init_state,  # (mesh) -> fresh state (used only on cold start)
        iterator,
        ckpt_dir,
        *,
        ckpt_every: int = 10,
        injector: FailureInjector | None = None,
        straggler_policy: StragglerPolicy | None = None,
        meshes=None,  # fallback meshes for elastic re-mesh (largest first)
        registry=None,  # repro_torch.obs.CounterRegistry (checkpointed with state)
        metrics_path=None,  # per-step metrics JSONL (repro_torch.obs.report schema)
        retry: RetryPolicy | None = None,  # bounded restart backoff schedule
        sleep_fn=time.sleep,  # injectable for tests (no real sleeping)
        redispatch: bool = True,  # re-dispatch straggler steps to a backup
    ):
        self.make_step = make_step
        self.init_state = init_state
        self.iterator = iterator
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.injector = injector or FailureInjector()
        self.straggler = straggler_policy or StragglerPolicy()
        self.meshes = list(meshes) if meshes else [None]
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir)
        self.report = SupervisorReport()
        self.registry = registry
        self.metrics_path = metrics_path
        self.retry = retry or RetryPolicy()
        self.sleep_fn = sleep_fn
        self.redispatch = redispatch

    def _restore_or_init(self, mesh):
        state = self.init_state(mesh)
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            return state, 0
        # leaves come back on the fresh state's devices
        state, extras = ckpt.restore(self.ckpt_dir, state)
        self.iterator.load_state_dict(extras["iterator"])
        if self.registry is not None:
            # Counters ride the checkpoint like the model state: a crash
            # rolls them back to the restored step, so totals stay exact
            # over any number of failure/restore cycles (no double counts
            # from replayed steps). Lifecycle events (restarts, stragglers)
            # are not replayed — their live values survive the rollback.
            reg = self.registry
            live = reg.counters()
            reg.restore(extras.get("counters", {}))
            for k in ("supervisor/restarts", "supervisor/stragglers"):
                if live.get(k, 0) > reg.get(k):
                    reg.inc(k, live.get(k, 0) - reg.get(k))
        return state, int(extras["step"])

    def run(self, total_steps: int, metrics_cb=None) -> SupervisorReport:
        from contextlib import nullcontext

        from repro_torch.obs import counters as obs
        from repro_torch.obs import report as obs_report

        reg = self.registry
        writer = (
            obs_report.MetricsWriter(self.metrics_path)
            if self.metrics_path
            else None
        )
        install = obs.use_registry(reg) if reg is not None else nullcontext()
        with install:
            try:
                return self._run(total_steps, metrics_cb, reg, writer)
            finally:
                if writer is not None:
                    writer.close()

    def _redispatch(self, step, reg, why: str):
        """Deadline re-dispatch: hand the straggler's step to a backup.

        The backup's (deterministic) execution is the step run the loop
        performs next — same batch, same state, so numerics are unchanged;
        what the policy adds is the *accounting*: the event, its counter,
        and the log line a fleet scheduler would act on.
        """
        self.report.redispatches += 1
        if reg is not None:
            reg.inc("supervisor/redispatches")
        self.report.log.append(
            f"step {step}: {why} — re-dispatched to backup worker"
        )

    def _run(self, total_steps, metrics_cb, reg, writer) -> SupervisorReport:
        mesh_idx = 0
        consecutive_failures = 0
        while True:
            mesh = self.meshes[mesh_idx]
            step_fn = self.make_step(mesh)
            state, step = self._restore_or_init(mesh)
            try:
                while step < total_steps:
                    t0 = time.time()
                    try:
                        self.injector.check(step)
                    except SimulatedStraggler as e:
                        # Straggler != failure: the drop-and-rescale policy
                        # proceeds with the step (over responsive workers).
                        self.report.straggler_events += 1
                        if reg is not None:
                            reg.inc("supervisor/stragglers")
                        self.report.log.append(
                            f"straggler: {e} — continuing (drop-and-rescale)"
                        )
                        if self.redispatch:
                            self._redispatch(step, reg, "straggler detected")
                    batch = next(self.iterator)
                    state, metrics = step_fn(state, batch)
                    dt = time.time() - t0
                    self.straggler.observe(dt)
                    if dt > self.straggler.deadline():
                        self.report.straggler_events += 1
                        if reg is not None:
                            reg.inc("supervisor/stragglers")
                        self.report.log.append(
                            f"step {step}: exceeded deadline ({dt:.2f}s) — "
                            "drop-and-rescale policy would engage"
                        )
                        if self.redispatch:
                            self._redispatch(step, reg, "deadline exceeded")
                    step += 1
                    self.report.steps_run += 1
                    consecutive_failures = 0  # progress resets the backoff
                    if reg is not None:
                        reg.inc("supervisor/steps")
                    if writer is not None:
                        writer.write({
                            "step": step,
                            "wall_s": dt,
                            "metrics": dict(metrics),
                            "counters": reg.totals() if reg is not None else {},
                        })
                    if metrics_cb:
                        metrics_cb(step, metrics)
                    if step % self.ckpt_every == 0 or step == total_steps:
                        extras = {
                            "step": step,
                            "iterator": self.iterator.state_dict(),
                        }
                        if reg is not None:
                            extras["counters"] = reg.snapshot()
                        self.checkpointer.save(step, state, extras=extras)
                self.checkpointer.wait()
                return self.report
            except SimulatedStraggler as e:
                self.report.straggler_events += 1
                self.report.log.append(f"straggler: {e} — continuing (drop-and-rescale)")
                continue
            except (SimulatedFailure, ckpt.CheckpointError) as e:
                self.report.restarts += 1
                if reg is not None:
                    reg.inc("supervisor/restarts")
                consecutive_failures += 1
                if consecutive_failures > self.retry.max_retries:
                    self.report.log.append(
                        f"crash: {e} — giving up after "
                        f"{consecutive_failures - 1} retries"
                    )
                    raise
                # bounded retry: exponential backoff before the restore
                delay = self.retry.delay(consecutive_failures - 1)
                self.report.backoffs.append(delay)
                self.report.log.append(
                    f"crash: {e} — retry {consecutive_failures}/"
                    f"{self.retry.max_retries} after {delay:.2f}s backoff, "
                    "restoring latest checkpoint"
                )
                self.sleep_fn(delay)
                try:
                    self.checkpointer.wait()
                except ckpt.CheckpointError as ce:
                    # the in-flight save is also broken: recovery proceeds
                    # from the last checkpoint that DID land
                    self.report.log.append(f"pending checkpoint failed: {ce}")
                # Elastic policy: after a crash, optionally fail over to the
                # next (smaller) mesh if one is configured.
                if mesh_idx + 1 < len(self.meshes):
                    mesh_idx += 1
                    self.report.remesh_events += 1
                    self.report.log.append(
                        f"re-mesh: continuing on fallback mesh #{mesh_idx}"
                    )
                continue
