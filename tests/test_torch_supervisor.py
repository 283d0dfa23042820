"""The port's supervisor (``repro_torch.runtime.supervisor``) on the toy step.

The cases of ``tests/test_supervisor.py`` run on the port: a linear
"model" in torch fed by the port's ``DataIterator``, checkpoints by the
port's store, ``sleep_fn`` recording instead of sleeping. Then the same
injectors drive JAX's supervisor on its toy step and the port's on this
one: ``steps_run``, ``restarts``, ``remesh_events``, the backoffs, the
kinds of the log's lines and the final state are equal (the straggler
deadline is set out of reach on both, since it reads wall time).
"""

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import DataIterator, InMemoryDataset
from repro_torch.runtime.faults import RetryPolicy
from repro_torch.runtime.supervisor import FailureInjector, StragglerPolicy, Supervisor


def _toy_setup(tmp_path):
    """A linear-regression 'model' so we can check exact-resume numerics."""
    ds = InMemoryDataset.synthetic(50_000, 31, 8, seed=0)
    it = DataIterator(ds, batch_size=4, seed=1)

    def init_state(mesh):
        return {"w": torch.zeros((31,)), "count": torch.zeros((), dtype=torch.int32)}

    def make_step(mesh):
        def step(state, batch):
            ids = torch.as_tensor(batch["inputs"][:, 0]).long()
            x = torch.nn.functional.one_hot(ids, 31).float().mean(0)
            w = state["w"] + 0.1 * x
            return {"w": w, "count": state["count"] + 1}, {"loss": torch.sum(w)}

        return step

    return init_state, make_step, it


def test_run_to_completion(tmp_path):
    init_state, make_step, it = _toy_setup(tmp_path)
    sup = Supervisor(make_step, init_state, it, tmp_path / "ck", ckpt_every=5)
    report = sup.run(12)
    assert report.steps_run == 12
    assert report.restarts == 0


def test_crash_restart_is_exact(tmp_path):
    """State after crash+restore must equal the uninterrupted run."""
    # uninterrupted reference
    init_state, make_step, it = _toy_setup(tmp_path)
    sup = Supervisor(make_step, init_state, it, tmp_path / "a", ckpt_every=4)
    sup.run(16)
    from repro_torch.checkpoint import checkpoint as ckpt

    ref_state, _ = ckpt.restore(tmp_path / "a", init_state(None))

    # crashing run
    init_state, make_step, it2 = _toy_setup(tmp_path)
    inj = FailureInjector({7: "crash", 13: "crash"})
    sup2 = Supervisor(make_step, init_state, it2, tmp_path / "b", ckpt_every=4,
                      injector=inj, sleep_fn=lambda s: None)
    report = sup2.run(16)
    assert report.restarts == 2
    got_state, _ = ckpt.restore(tmp_path / "b", init_state(None))
    np.testing.assert_allclose(
        np.asarray(got_state["w"]), np.asarray(ref_state["w"]), atol=1e-6
    )
    assert int(got_state["count"]) == 16


def test_straggler_logged_and_continues(tmp_path):
    init_state, make_step, it = _toy_setup(tmp_path)
    inj = FailureInjector({3: "straggler"})
    sup = Supervisor(make_step, init_state, it, tmp_path / "c", ckpt_every=5, injector=inj)
    report = sup.run(10)
    assert report.steps_run == 10
    assert report.straggler_events >= 1
    assert any("straggler" in line for line in report.log)


def test_elastic_remesh_failover(tmp_path):
    """After a crash, the job continues on the fallback mesh entry."""
    init_state, make_step, it = _toy_setup(tmp_path)
    inj = FailureInjector({5: "crash"})
    sup = Supervisor(
        make_step, init_state, it, tmp_path / "d", ckpt_every=2,
        injector=inj, meshes=["mesh-large", "mesh-small"],
        sleep_fn=lambda s: None,
    )
    report = sup.run(9)
    assert report.remesh_events == 1
    assert any("re-mesh" in line for line in report.log)
    from repro_torch.checkpoint import checkpoint as ckpt

    st, _ = ckpt.restore(tmp_path / "d", init_state(None))
    assert int(st["count"]) == 9


def test_crash_backoff_follows_retry_schedule(tmp_path):
    """Each restart sleeps the RetryPolicy's delay; progress resets it."""
    init_state, make_step, it = _toy_setup(tmp_path)
    inj = FailureInjector({3: "crash", 9: "crash"})
    slept = []
    sup = Supervisor(make_step, init_state, it, tmp_path / "bo", ckpt_every=2,
                     injector=inj, retry=RetryPolicy(base_delay=0.25),
                     sleep_fn=slept.append)
    report = sup.run(12)
    assert report.restarts == 2
    # steps committed between the crashes reset the attempt counter, so
    # BOTH retries back off at the first-attempt delay
    assert report.backoffs == [0.25, 0.25]
    assert slept == report.backoffs


def test_consecutive_crashes_escalate_then_give_up(tmp_path):
    """Back-to-back failures walk the exponential schedule, then re-raise."""
    from repro_torch.runtime.supervisor import SimulatedFailure

    init_state, make_step, it = _toy_setup(tmp_path)

    class AlwaysCrash:
        def check(self, step):
            raise SimulatedFailure(f"injected crash at step {step}")

    sup = Supervisor(make_step, init_state, it, tmp_path / "gu", ckpt_every=2,
                     injector=AlwaysCrash(),
                     retry=RetryPolicy(max_retries=3, base_delay=0.5),
                     sleep_fn=lambda s: None)
    with pytest.raises(SimulatedFailure):
        sup.run(12)
    assert sup.report.restarts == 4  # 3 retries + the one that gave up
    assert sup.report.backoffs == [0.5, 1.0, 2.0]  # doubling, no progress
    assert any("giving up" in line for line in sup.report.log)


def test_straggler_redispatches_to_backup(tmp_path):
    init_state, make_step, it = _toy_setup(tmp_path)
    inj = FailureInjector({3: "straggler", 6: "straggler"})
    sup = Supervisor(make_step, init_state, it, tmp_path / "rd", ckpt_every=5,
                     injector=inj)
    report = sup.run(10)
    assert report.steps_run == 10
    assert report.redispatches == 2
    assert sum("backup worker" in line for line in report.log) == 2
    # the accounting is optional: redispatch=False records only the event
    init_state, make_step, it = _toy_setup(tmp_path)
    sup2 = Supervisor(make_step, init_state, it, tmp_path / "rd2",
                      ckpt_every=5, injector=FailureInjector({3: "straggler"}),
                      redispatch=False)
    report2 = sup2.run(10)
    assert report2.straggler_events >= 1 and report2.redispatches == 0


def test_checkpoint_error_triggers_restart(tmp_path):
    """A broken checkpoint cadence restarts the loop, not the process."""
    from repro_torch.checkpoint import checkpoint as ckpt

    init_state, make_step, it = _toy_setup(tmp_path)
    fired = []

    class BadCkptOnce:
        def check(self, step):
            if step == 5 and not fired:
                fired.append(step)
                raise ckpt.CheckpointError("background checkpoint save failed")

    sup = Supervisor(make_step, init_state, it, tmp_path / "ce", ckpt_every=2,
                     injector=BadCkptOnce(), sleep_fn=lambda s: None)
    report = sup.run(10)
    assert report.restarts == 1
    assert int(ckpt.restore(tmp_path / "ce", init_state(None))[0]["count"]) == 10


def test_straggler_deadline_uses_paper_model():
    pol = StragglerPolicy(slack=2.0, weight_bytes=300e6, mesh_side=16)
    pol.observe(0.5)
    # paper: T_update = 4*(300MB/60GBps + 16*20us) = 4*(5ms + 0.32ms) ~ 21.3ms
    d = pol.deadline()
    assert 1.0 < d < 2.0  # 2*0.5 + 0.0213


def test_metrics_cb_with_counter_registry_end_to_end(tmp_path):
    """Counters + JSONL through the supervisor, no failures injected."""
    from repro_torch import obs

    init_state, make_step, it = _toy_setup(tmp_path)
    reg = obs.CounterRegistry()
    path = tmp_path / "metrics.jsonl"
    seen = []
    sup = Supervisor(make_step, init_state, it, tmp_path / "m", ckpt_every=5,
                     registry=reg, metrics_path=str(path))
    report = sup.run(12, metrics_cb=lambda step, m: seen.append(step))
    assert report.steps_run == 12
    assert seen == list(range(1, 13))
    assert reg.get("supervisor/steps") == 12
    assert reg.get("supervisor/restarts", 0) == 0
    recs = obs.read_jsonl(path)
    assert [r["step"] for r in recs] == list(range(1, 13))
    for r in recs:
        assert r["schema_version"] == obs.SCHEMA_VERSION
        assert "loss" in r["metrics"]
        assert r["counters"]["steps"] == r["step"]


def test_counters_survive_crash_restore_cycle(tmp_path):
    """Counters roll back with the checkpoint: totals stay exact across a
    simulated failure (replayed steps are not double-counted), while
    lifecycle counters (restarts) survive the rollback."""
    from repro_torch import obs

    init_state, make_step, it = _toy_setup(tmp_path)
    reg = obs.CounterRegistry()
    inj = FailureInjector({7: "crash"})
    path = tmp_path / "metrics.jsonl"
    sup = Supervisor(make_step, init_state, it, tmp_path / "cc", ckpt_every=2,
                     injector=inj, registry=reg, metrics_path=str(path),
                     sleep_fn=lambda s: None)
    report = sup.run(10)
    assert report.steps_run > 10  # steps 7..8 replayed after the crash
    assert report.restarts == 1
    # rollback-to-checkpoint keeps the counter total EXACT despite replay
    assert reg.get("supervisor/steps") == 10
    assert reg.get("supervisor/restarts") == 1
    # the JSONL stream shows the replay (re-run steps appear twice)
    recs = obs.read_jsonl(path)
    steps = [r["step"] for r in recs]
    assert len(steps) == report.steps_run > 10
    assert len(set(steps)) < len(steps)
    assert recs[-1]["step"] == 10
    assert recs[-1]["counters"]["restarts"] == 1


# -- the same injectors on JAX's supervisor and the port's --------------------

def _jax_toy(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import DataIterator as JaxIterator
    from repro.data.pipeline import InMemoryDataset as JaxDataset

    it = JaxIterator(JaxDataset.synthetic(50_000, 31, 8, seed=0), batch_size=4, seed=1)

    def init_state(mesh):
        return {"w": jnp.zeros((31,)), "count": jnp.int32(0)}

    def make_step(mesh):
        @jax.jit
        def step(state, batch):
            x = jax.nn.one_hot(batch["inputs"][:, 0], 31).mean(0)
            w = state["w"] + 0.1 * x
            return {"w": w, "count": state["count"] + 1}, {"loss": jnp.sum(w)}

        return step

    return init_state, make_step, it


def _kind(line: str) -> str:
    return line.split(":")[0] if not line.startswith("step ") else "step"


class _AlwaysCrash:
    def __init__(self, failure):
        self.failure = failure

    def check(self, step):
        raise self.failure(f"injected crash at step {step}")


SCHEDULES = {
    "crashes": (dict(schedule={7: "crash", 13: "crash"}), dict(ckpt_every=4), 16),
    "straggler_and_crash": (dict(schedule={3: "straggler", 9: "crash"}),
                            dict(ckpt_every=2, retry="backoff"), 12),
    "remesh": (dict(schedule={5: "crash"}), dict(ckpt_every=2, meshes=["large", "small"]), 9),
    "no_redispatch": (dict(schedule={3: "straggler", 6: "straggler"}),
                      dict(ckpt_every=5, redispatch=False), 10),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_report_equals_jax_for_the_same_injector(tmp_path, name):
    from repro.checkpoint import checkpoint as jckpt
    from repro.runtime.faults import RetryPolicy as JaxRetry
    from repro.runtime.supervisor import FailureInjector as JaxInjector
    from repro.runtime.supervisor import StragglerPolicy as JaxStraggler
    from repro.runtime.supervisor import Supervisor as JaxSupervisor
    from repro_torch.checkpoint import checkpoint as ckpt

    inj_kw, sup_kw, steps = SCHEDULES[name]
    reports, finals = [], []
    for tag, (toy, sup_cls, injector, straggler, retry, store) in {
        "jax": (_jax_toy, JaxSupervisor, JaxInjector, JaxStraggler, JaxRetry, jckpt),
        "port": (_toy_setup, Supervisor, FailureInjector, StragglerPolicy, RetryPolicy, ckpt),
    }.items():
        init_state, make_step, it = toy(tmp_path)
        kw = dict(sup_kw)
        if kw.pop("retry", None):
            kw["retry"] = retry(base_delay=0.25)
        sup = sup_cls(make_step, init_state, it, tmp_path / tag, injector=injector(
            dict(inj_kw["schedule"])), straggler_policy=straggler(slack=1e9),
            sleep_fn=lambda s: None, **kw)
        reports.append(sup.run(steps))
        finals.append(store.restore(tmp_path / tag, init_state(None))[0])
    want, got = reports
    for field in ("steps_run", "restarts", "remesh_events", "straggler_events",
                  "redispatches", "backoffs"):
        assert getattr(got, field) == getattr(want, field), field
    assert [_kind(s) for s in got.log] == [_kind(s) for s in want.log]
    assert np.array_equal(np.asarray(finals[0]["w"]), finals[1]["w"].numpy())
    assert int(finals[0]["count"]) == int(finals[1]["count"]) == steps


def test_give_up_equals_jax(tmp_path):
    from repro.runtime.faults import RetryPolicy as JaxRetry
    from repro.runtime.supervisor import SimulatedFailure as JaxFailure
    from repro.runtime.supervisor import Supervisor as JaxSupervisor
    from repro_torch.runtime.supervisor import SimulatedFailure

    sups = []
    for tag, (toy, sup_cls, failure, retry) in {
        "jax": (_jax_toy, JaxSupervisor, JaxFailure, JaxRetry),
        "port": (_toy_setup, Supervisor, SimulatedFailure, RetryPolicy),
    }.items():
        init_state, make_step, it = toy(tmp_path)
        sup = sup_cls(make_step, init_state, it, tmp_path / tag, ckpt_every=2,
                      injector=_AlwaysCrash(failure),
                      retry=retry(max_retries=3, base_delay=0.5), sleep_fn=lambda s: None)
        with pytest.raises(failure):
            sup.run(12)
        sups.append(sup.report)
    want, got = sups
    assert (got.restarts, got.backoffs, got.steps_run) == (want.restarts, want.backoffs,
                                                           want.steps_run)
    assert [_kind(s) for s in got.log] == [_kind(s) for s in want.log]
