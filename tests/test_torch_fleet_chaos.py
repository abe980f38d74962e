"""The port's serving fleet under chaos on the CPU (the port's copies of
``tests/test_fleet.py``'s subprocess cases): a replica SIGKILLed mid-flood
is relaunched while the front keeps answering, a SIGKILLed front orphans
no replica, and a replica crashing at spawn (``fleet.spawn``) is recovered
by the supervisor.
"""

import os
import signal
import time

import pytest

pytest.importorskip("torch")

import torch_fleet as tf  # noqa: E402
import torch_serving as ts  # noqa: E402

pytestmark = [pytest.mark.fleet, pytest.mark.chaos]


def _post_retrying(base, body, window_s=1.0):
    """Bounded retry for the kill-window TCP race: connections the dying
    listener accepted are reset until the kernel tears the process down."""
    deadline = time.monotonic() + window_s
    while True:
        try:
            return ts.query(base, body, timeout=10)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def test_replica_sigkill_mid_flood(tmp_path):
    env = tf.sqlite_env(tmp_path)
    storage = tf.storage_for(env)
    tf.train(storage, "one")
    fleet = tf.Fleet(env, replicas=2)
    try:
        doc = fleet.wait_ready()
        victim = doc["backends"][0]["pid"]
        assert victim
        with tf.Clients(fleet.base, threads=2, pause=0.05) as clients:
            time.sleep(0.5)
            os.kill(victim, signal.SIGKILL)
            # the front keeps answering: new connections skip the dead
            # backend (connect-refused retry and readiness)
            t_kill = time.monotonic()
            probe_drops = 0
            while time.monotonic() - t_kill < 1.0:
                try:
                    status, _, _ = ts.query(fleet.base, {"user": "probe"},
                                            timeout=10)
                except OSError:
                    probe_drops += 1
                    status, _, _ = _post_retrying(fleet.base,
                                                  {"user": "probe"})
                assert status == 200
            assert probe_drops <= 10, probe_drops

            def relaunched():
                h = fleet.healthz()
                return (all(b["alive"] for b in h["backends"])
                        and any(b["restarts"] >= 1 for b in h["backends"])
                        and h["readyReplicas"] == 2) and h
            tf.poll(relaunched, 60, msg="replica relaunched")
            time.sleep(0.5)
        # no non-{200,503,504} answer across the flood; the only tolerated
        # casualties are connections in flight ON the killed replica
        assert set(clients.codes) <= {200, 503, 504}, \
            sorted(set(clients.codes))
        assert clients.codes.count(200) > 50
        assert clients.conn_errors <= 12, clients.conn_errors
        fleet.stop()
    finally:
        storage.close()
        fleet.kill()


def test_sigkilled_front_does_not_orphan_replicas(tmp_path):
    """A front that dies WITHOUT draining must not orphan replicas serving
    forever: PR_SET_PDEATHSIG (and the reparenting watchdog) in the
    replica entry deliver SIGTERM, the normal drain."""
    env = tf.sqlite_env(tmp_path)
    storage = tf.storage_for(env)
    tf.train(storage, "one")
    fleet = tf.Fleet(env, replicas=2)
    pids = []
    try:
        doc = fleet.wait_ready()
        pids = [b["pid"] for b in doc["backends"]]
        assert all(pids)
        fleet.proc.kill()               # SIGKILL: no drain possible
        fleet._reap()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and any(tf.alive(p) for p in pids):
            time.sleep(0.2)
        assert not any(tf.alive(p) for p in pids), (
            f"replicas {[p for p in pids if tf.alive(p)]} orphaned by a "
            "SIGKILLed front")
    finally:
        storage.close()
        fleet.kill()
        for p in pids:                  # never leak into later tests
            if tf.alive(p):
                os.kill(p, signal.SIGKILL)


def test_fleet_spawn_crash_recovered_by_supervisor(tmp_path):
    env = tf.sqlite_env(tmp_path,
                        PIO_FLEET_WORKER_FAULT_SPEC="fleet.spawn:crash:1")
    storage = tf.storage_for(env)
    tf.train(storage, "one")
    fleet = tf.Fleet(env, replicas=2)
    try:
        # every first-launch replica SIGKILLs itself at fleet.spawn; the
        # supervisor relaunches each one clean and the fleet comes up
        doc = fleet.wait_ready(deadline_s=120)
        assert all(b["restarts"] >= 1 for b in doc["backends"]), doc
        status, body, _ = ts.query(fleet.base, {"user": "u"}, timeout=10)
        assert status == 200 and body["tag"] == "one"
        fleet.stop()
    finally:
        storage.close()
        fleet.kill()
