"""The port's serving fleet end to end on the CPU: the staged canary, the
promote, a fleet rollback through the CLI and a poisoned retrain pinned
fleet-wide, with every client query answered 200 (the port's copy of
``tests/test_fleet.py::test_staged_canary_promote_cli_rollback_and_poison``,
on three replicas of tests/torch_fleet_server.py behind the port's front).
"""

import io
import time
from contextlib import redirect_stdout

import pytest

pytest.importorskip("torch")

import torch_fleet as tf  # noqa: E402

pytestmark = [pytest.mark.fleet, pytest.mark.chaos]


def test_staged_canary_promote_cli_rollback_and_poison(tmp_path):
    env = tf.sqlite_env(tmp_path,
                        # wide enough that the canary sees several client
                        # queries inside the window: a quiet window closes
                        # clean by design, which would promote the poison
                        PIO_SWAP_WATCH_MS="2500",
                        PIO_SWAP_MAX_ERROR_RATE="0.3")
    storage = tf.storage_for(env)
    iid_a = tf.train(storage, "one")
    fleet = tf.Fleet(env, replicas=3)
    try:
        fleet.wait_ready()
        # bootstrap: the coordinator adopts the converged instance
        tf.poll(lambda: ((fleet.fleet_view().get("directive") or {})
                         .get("instance") == iid_a), 30,
                msg="bootstrap adoption")

        with tf.Clients(fleet.base) as clients:
            time.sleep(0.5)                 # steady-state 200s first
            # -- staged rollout of a GOOD retrain -------------------------
            iid_b = tf.train(storage, "two")
            saw_canary = tf.poll(
                lambda: (lambda v: v if (v.get("directive") or {})
                         .get("state") == "canary" else None)(
                             fleet.fleet_view()),
                20, msg="canary staged")
            assert saw_canary["directive"]["target"] == iid_b
            # exactly ONE replica swaps first (the canary); the rest hold
            on_b = [p for p in saw_canary["peers"]
                    if p.get("instance") == iid_b]
            assert len(on_b) <= 1, saw_canary
            held = [p for p in saw_canary["peers"]
                    if p.get("instance") == iid_a]
            assert len(held) >= len(saw_canary["peers"]) - 1

            def promoted():
                v = fleet.fleet_view()
                dd = v.get("directive") or {}
                peers = v.get("peers") or []
                return (dd.get("state") == "steady"
                        and dd.get("instance") == iid_b
                        and len(peers) == 3
                        and all(p.get("instance") == iid_b
                                for p in peers)) and v
            tf.poll(promoted, 30, msg="fleet promoted to the retrain")

            # -- FLEET rollback through the front -------------------------
            from incubator_predictionio_torch.tools.console import main as pio

            t0 = time.monotonic()
            assert pio(["models", "rollback", "--engine-url",
                        fleet.base]) == 0

            def converged_back():
                v = fleet.fleet_view()
                dd = v.get("directive") or {}
                peers = v.get("peers") or []
                return (dd.get("instance") == iid_a
                        and dd.get("pinned", {}).get(iid_b) == "manual"
                        and len(peers) == 3
                        and all(p.get("instance") == iid_a for p in peers)
                        and not v.get("divergence")) and v
            tf.poll(converged_back, 15,
                    msg="fleet rollback converged on last-good")
            # the mixed-brain window: a few PIO_FLEET_SYNC_MS polls
            assert time.monotonic() - t0 < 10.0

            # -- poisoned retrain: gate-passing, traffic-failing ----------
            iid_c = tf.train(storage, "poisoned", mode="poison")

            def poisoned_pinned():
                v = fleet.fleet_view()
                dd = v.get("directive") or {}
                return (dd.get("state") == "steady"
                        and dd.get("pinned", {}).get(iid_c) == "error-rate"
                        and dd.get("instance") == iid_a
                        and all(p.get("instance") == iid_a
                                for p in (v.get("peers") or []))) and v
            tf.poll(poisoned_pinned, 30,
                    msg="poisoned canary rolled back + pinned fleet-wide")
            time.sleep(0.5)     # two more sync ticks: the pin holds
            assert poisoned_pinned()

        # EVERY client query answered 200, through canary, promote, fleet
        # rollback and the poisoned swap (hedged on the canary)
        assert clients.codes and set(clients.codes) == {200}, \
            sorted(set(clients.codes))
        assert clients.conn_errors == 0
        assert clients.tags <= {"one", "two"}, clients.tags

        # `pio status --engine-url` shows the converged fleet
        from incubator_predictionio_torch.tools.commands.management import (
            _print_engine_overload,
        )

        buf = io.StringIO()
        with redirect_stdout(buf):
            _print_engine_overload(fleet.base)
        out = buf.getvalue()
        assert "fleet lifecycle::default" in out
        assert "3/3 replica(s) reporting" in out
        assert "DIVERGE" not in out
        assert out.count(f"instance {iid_a}") >= 3

        # `pio fleet plan`: the autoscaler's dry run over a fixed fleet
        # scrapes each backend's /status; an idle fleet above the floor
        # (min 1 here) would drain its highest slot
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert pio(["fleet", "plan", "--engine-url", fleet.base]) == 0
        out = buf.getvalue()
        assert "local backend /status scrape" in out
        assert "replicas: 3 active" in out
        assert "would drain replica 2 (quiet) -> 2 replica(s)" in out
        assert "dry run only" in out

        # the front's /healthz carries the reference's pio_fleet_* counts
        counts = fleet.healthz()["metrics"]
        assert counts["pio_fleet_promotes_total"] >= 1
        assert counts["pio_fleet_rollbacks_total"].get("manual") == 1
        assert counts["pio_fleet_replicas_ready"] == 3
        fleet.stop()
    finally:
        storage.close()
        fleet.kill()
