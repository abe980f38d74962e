"""The port's autoscaler decisions and the supervisor's service mode on the
CPU.

- ``elastic.plan`` against the reference's on hypothesis-drawn replica
  samples and configurations: ``Decision.to_json()`` equal field for
  field; the same for ``ElasticController.observe`` over drawn tick
  sequences.
- The reference's decision and controller cases
  (``tests/test_elastic.py``).
- ``Supervisor`` in service mode against real subprocesses: deferred add
  on the supervision thread, graceful retirement, a duplicate slot, an
  added worker's restart budget and a budget exhausted; the gang scope
  raises.
"""

import os
import signal
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from incubator_predictionio_tpu.workflow import elastic as ref_elastic  # noqa: E402
from incubator_predictionio_torch.parallel.supervisor import (  # noqa: E402
    DRAIN_EXIT_CODE, GangConfig, Supervisor,
)
from incubator_predictionio_torch.workflow import elastic  # noqa: E402


def _samples(*specs):
    """specs: (slot, ready, pending, limit[, shed_delta[, draining]])"""
    out = []
    for spec in specs:
        slot, ready, pending, limit = spec[:4]
        shed = spec[4] if len(spec) > 4 else 0
        draining = spec[5] if len(spec) > 5 else False
        out.append(elastic.ReplicaSample(
            slot=slot, alive=True, ready=ready, draining=draining,
            pending=pending, pending_limit=limit, shed_delta=shed))
    return out


def _cfg(**kw):
    base = dict(min_replicas=1, max_replicas=3, up_threshold=0.8,
                down_threshold=0.2, hysteresis_ticks=2,
                cooldown_ms=1000.0, tick_ms=100.0)
    base.update(kw)
    return elastic.ElasticConfig(**base)


# -- the decision function against the reference's ----------------------------

_sample = st.fixed_dictionaries({
    "alive": st.booleans(), "ready": st.booleans(),
    "draining": st.booleans(), "pending": st.integers(0, 40),
    "pending_limit": st.integers(0, 40), "shed_delta": st.integers(-2, 6)})
_config = st.fixed_dictionaries({
    "min_replicas": st.integers(1, 4), "max_replicas": st.integers(1, 6),
    "up_threshold": st.floats(0.01, 1.0), "down_threshold": st.floats(0, 1),
    "hysteresis_ticks": st.integers(1, 4),
    "cooldown_ms": st.sampled_from([0.0, 250.0, 1000.0]),
    "tick_ms": st.just(100.0)})


def _both(samples: list, cfg: dict):
    port = [elastic.ReplicaSample(slot=i, **s) for i, s in enumerate(samples)]
    ref = [ref_elastic.ReplicaSample(slot=i, **s)
           for i, s in enumerate(samples)]
    return (port, elastic.ElasticConfig(**cfg),
            ref, ref_elastic.ElasticConfig(**cfg))


@settings(max_examples=300, deadline=None)
@given(samples=st.lists(_sample, max_size=7), cfg=_config)
def test_plan_matches_the_reference(samples, cfg):
    port, pcfg, ref, rcfg = _both(samples, cfg)
    assert elastic.plan(port, pcfg).to_json() == \
        ref_elastic.plan(ref, rcfg).to_json()


@settings(max_examples=100, deadline=None)
@given(ticks=st.lists(st.lists(_sample, min_size=1, max_size=4),
                      min_size=1, max_size=8),
       cfg=_config, act=st.lists(st.booleans(), min_size=8, max_size=8))
def test_controller_matches_the_reference(ticks, cfg, act):
    pc = elastic.ElasticController(elastic.ElasticConfig(**cfg))
    rc = ref_elastic.ElasticController(ref_elastic.ElasticConfig(**cfg))
    for k, tick in enumerate(ticks):
        port, _, ref, _ = _both(tick, cfg)
        now = k * 0.3
        pd, rd = pc.observe(port, now=now), rc.observe(ref, now=now)
        assert pd.to_json() == rd.to_json()
        if pd.direction != "hold" and act[k]:
            pe = pc.record_action(pd, now=now)
            re_ = rc.record_action(rd, now=now)
            assert {k2: v for k2, v in pe.items() if k2 != "at"} == \
                {k2: v for k2, v in re_.items() if k2 != "at"}


def test_config_from_env_matches_the_reference(monkeypatch):
    for env in ({"PIO_FLEET_MIN_REPLICAS": "4",
                 "PIO_FLEET_MAX_REPLICAS": "2",
                 "PIO_SCALE_UP_THRESHOLD": "7.5",
                 "PIO_SCALE_DOWN_THRESHOLD": "9.0"},
                {"PIO_SCALE_HYSTERESIS_TICKS": "0",
                 "PIO_SCALE_COOLDOWN_MS": "bad",
                 "PIO_SCALE_TICK_MS": "10"},
                {}):
        for k in list(os.environ):
            if k.startswith(("PIO_FLEET_", "PIO_SCALE_")):
                monkeypatch.delenv(k)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for kw in ({}, {"default_min": 2, "default_max": 5}):
            assert elastic.ElasticConfig.from_env(**kw).to_json() == \
                ref_elastic.ElasticConfig.from_env(**kw).to_json()


# -- the reference's decision cases ---------------------------------------------

class TestDecision:
    def test_below_floor_scales_up(self):
        d = elastic.plan(_samples((0, True, 0, 8)), _cfg(min_replicas=2))
        assert (d.direction, d.reason, d.target) == ("up", "floor", 2)

    def test_shed_pressure_scales_up(self):
        d = elastic.plan(_samples((0, True, 1, 8, 5)), _cfg())
        assert (d.direction, d.reason, d.target) == ("up", "shed", 2)
        assert d.shed_delta == 5

    def test_utilization_pressure_scales_up(self):
        d = elastic.plan(_samples((0, True, 7, 8)), _cfg())
        assert (d.direction, d.reason) == ("up", "utilization")

    def test_at_max_holds_under_pressure(self):
        d = elastic.plan(_samples((0, True, 8, 8)), _cfg(max_replicas=1))
        assert (d.direction, d.reason, d.target) == ("hold", "at-max", 1)

    def test_quiet_drains_least_loaded_highest_slot(self):
        d = elastic.plan(_samples((0, True, 0, 8), (1, True, 0, 8)), _cfg())
        assert (d.direction, d.reason, d.slot, d.target) == \
            ("down", "quiet", 1, 1)
        d = elastic.plan(_samples((0, True, 0, 8), (1, True, 3, 8)),
                         _cfg(down_threshold=0.5))
        assert (d.direction, d.slot) == ("down", 0)

    def test_quiet_while_settling_holds(self):
        d = elastic.plan(_samples((0, True, 0, 8), (1, False, 0, 8)), _cfg())
        assert (d.direction, d.reason, d.actual) == ("hold", "settling", 2)

    def test_no_ready_replicas_holds(self):
        d = elastic.plan(_samples((0, False, 0, 8), (1, False, 0, 8)),
                         _cfg())
        assert (d.direction, d.reason) == ("hold", "settling")

    def test_sheds_veto_scale_down(self):
        d = elastic.plan(_samples((0, True, 0, 8), (1, True, 0, 8, 1)),
                         _cfg())
        assert d.direction != "down"

    def test_at_floor_quiet_is_steady(self):
        d = elastic.plan(_samples((0, True, 0, 8)), _cfg())
        assert (d.direction, d.reason, d.target) == ("hold", "steady", 1)

    def test_draining_replicas_do_not_count_as_actual(self):
        d = elastic.plan(
            _samples((0, True, 0, 8), (1, False, 0, 8, 0, True)),
            _cfg(min_replicas=2))
        assert (d.direction, d.reason, d.actual) == ("up", "floor", 1)


class TestController:
    def test_hysteresis_gates_until_ticks_agree(self):
        c = elastic.ElasticController(_cfg(hysteresis_ticks=3))
        hot = _samples((0, True, 8, 8))
        d1 = c.observe(hot, now=0.0)
        assert (d1.direction, d1.gates) == ("hold", ("hysteresis",))
        assert c.observe(hot, now=0.1).direction == "hold"
        d3 = c.observe(hot, now=0.2)
        assert (d3.direction, d3.gates) == ("up", ())

    def test_disagreeing_tick_resets_the_counter(self):
        c = elastic.ElasticController(_cfg(hysteresis_ticks=2))
        hot, calm = _samples((0, True, 8, 8)), _samples((0, True, 4, 8))
        c.observe(hot, now=0.0)
        c.observe(calm, now=0.1)
        d = c.observe(hot, now=0.2)
        assert (d.direction, d.gates) == ("hold", ("hysteresis",))

    def test_floor_skips_hysteresis(self):
        c = elastic.ElasticController(_cfg(min_replicas=2,
                                           hysteresis_ticks=5))
        d = c.observe(_samples((0, True, 0, 8)), now=0.0)
        assert (d.direction, d.reason) == ("up", "floor")

    def test_cooldown_gates_after_an_acted_decision(self):
        c = elastic.ElasticController(_cfg(hysteresis_ticks=1,
                                           cooldown_ms=1000.0))
        hot = _samples((0, True, 8, 8))
        d = c.observe(hot, now=0.0)
        assert d.direction == "up"
        c.record_action(d, now=0.0)
        d2 = c.observe(hot, now=0.5)
        assert (d2.direction, "cooldown" in d2.gates) == ("hold", True)
        assert c.observe(hot, now=1.5).direction == "up"

    def test_record_action_caps_decision_log_at_16(self):
        c = elastic.ElasticController(_cfg(hysteresis_ticks=1))
        hot = _samples((0, True, 8, 8))
        for i in range(20):
            d = c.observe(hot, now=float(i) * 10.0)
            if d.direction == "up":
                c.record_action(d, now=float(i) * 10.0)
        assert len(c.decisions) == 16
        assert all("at" in e and e["direction"] == "up"
                   for e in c.decisions)


# -- the supervisor in service mode (real subprocesses) ---------------------------

# a service worker: beats its heartbeat file and exits DRAIN_EXIT_CODE on
# SIGTERM (the graceful drain retirement relies on)
_WORKER_SRC = """
import os, signal, sys, time
hb = os.environ["PIO_WORKER_HEARTBEAT_FILE"]
signal.signal(signal.SIGTERM, lambda s, f: sys.exit(3))
while True:
    with open(hb, "a"):
        os.utime(hb, None)
    time.sleep(0.05)
"""


def _service_sup(tmp_path, workers=1, max_restarts=3):
    return Supervisor(
        [sys.executable, "-c", _WORKER_SRC], workers,
        config=GangConfig(num_workers=workers, heartbeat_ms=50,
                          stall_ms=30_000, init_grace_ms=30_000,
                          max_restarts=max_restarts, drain_ms=10_000,
                          poll_ms=25),
        run_dir=str(tmp_path / "run"), restart_scope="worker")


def _sup_poll(fn, deadline_s=30, msg="condition"):
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        last = fn()
        if last:
            return last
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}; last={last!r}")


class TestDynamicMembership:
    def test_gang_scope_raises(self, tmp_path):
        # a gang's size is its process group's world size: no dynamic
        # membership there (the reference's rule)
        sup = Supervisor(["true"], 1, run_dir=str(tmp_path / "g"))
        assert sup.restart_scope == "gang"
        with pytest.raises(RuntimeError, match="restart_scope='worker'"):
            sup.add_worker()
        with pytest.raises(RuntimeError, match="restart_scope='worker'"):
            sup.retire_worker(0)

    def test_duplicate_slot_rejected(self, tmp_path):
        sup = _service_sup(tmp_path)
        assert sup.add_worker(1) == 1
        with pytest.raises(ValueError):
            sup.add_worker(1)                 # a queued add holds the slot
        assert sup.add_worker() == 0
        assert sup.add_worker() == 2

    def test_add_retire_lifecycle(self, tmp_path):
        sup = _service_sup(tmp_path)
        # enqueued before the supervision thread exists: the spawn waits
        # for that thread
        slot = sup.add_worker(1)
        assert slot == 1 and sup.worker_pid(1) is None
        t = threading.Thread(target=sup.run, daemon=True)
        t.start()
        try:
            _sup_poll(lambda: sup.worker_pid(0) and sup.worker_pid(1),
                      msg="both workers spawned")
            assert sorted(e["worker"] for e in sup.events
                          if e["type"] == "workerAdded") == [1]
            hb = os.path.join(sup.run_dir, "worker_1.hb")
            _sup_poll(lambda: os.path.exists(hb),
                      msg="late worker heartbeat file")
            assert sup.live_worker_indices() == [0, 1]
            sup.retire_worker(1)
            _sup_poll(lambda: 1 not in sup.live_worker_indices()
                      and not sup.is_retiring(1), msg="retirement")
            retired = [e for e in sup.events
                       if e["type"] == "workerRetired"]
            assert [(e["worker"], e["rc"]) for e in retired] == \
                [(1, DRAIN_EXIT_CODE)]
            assert not any(e["type"] == "workerFailure"
                           for e in sup.events)
            assert sup.worker_restarts[1] == 0
        finally:
            sup.request_stop()
            t.join(timeout=30)
        assert sup.state == "drained"

    def test_added_worker_has_restart_budget(self, tmp_path):
        sup = _service_sup(tmp_path, max_restarts=1)
        t = threading.Thread(target=sup.run, daemon=True)
        t.start()
        try:
            _sup_poll(lambda: sup.worker_pid(0), msg="launch worker")
            slot = sup.add_worker()
            pid = _sup_poll(lambda: sup.worker_pid(slot),
                            msg="added worker spawned")
            os.kill(pid, signal.SIGKILL)
            _sup_poll(lambda: (sup.worker_pid(slot) or 0) not in (0, pid),
                      msg="added worker relaunched")
            assert sup.worker_restarts[slot] == 1
            assert any(e["type"] == "workerFailure" and e["worker"] == slot
                       for e in sup.events)
            assert any(e["type"] == "workerRestart" and e["worker"] == slot
                       for e in sup.events)
        finally:
            sup.request_stop()
            t.join(timeout=30)

    def test_restart_budget_exhaustion_fails_service(self, tmp_path):
        sup = _service_sup(tmp_path, max_restarts=0)
        outcome = {}
        t = threading.Thread(
            target=lambda: outcome.update(state=sup.run()), daemon=True)
        t.start()
        try:
            pid = _sup_poll(lambda: sup.worker_pid(0), msg="worker up")
            os.kill(pid, signal.SIGKILL)
            t.join(timeout=30)
            assert outcome.get("state") == "failed"
            assert any(e["type"] == "gaveUp" for e in sup.events)
        finally:
            sup.request_stop()
            t.join(timeout=30)
