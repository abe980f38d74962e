"""The port's elastic fleet end to end on the CPU (the port's copy of
``tests/test_elastic.py::test_elastic_fleet_scales_up_under_flood_and_drains_on_quiet``):
launched at the floor (1 replica), a query flood makes the autoscaler
spawn replica 1 through the supervisor; on quiet it drains the
least-loaded replica back to the floor, every client answer in
{200, 503, 504} throughout.
"""

import http.client
import threading

import pytest

pytest.importorskip("torch")

import torch_fleet as tf  # noqa: E402
import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402

pytestmark = [pytest.mark.fleet, pytest.mark.chaos]


def test_elastic_fleet_scales_up_under_flood_and_drains_on_quiet(tmp_path):
    env = tf.sqlite_env(
        tmp_path,
        PIO_FLEET_MIN_REPLICAS="1",
        PIO_FLEET_MAX_REPLICAS="2",
        # a tiny admission queue: the flood reads as shed/utilization
        # within a tick or two
        PIO_QUERY_MAX_PENDING="2",
        PIO_SCALE_TICK_MS="100",
        PIO_SCALE_COOLDOWN_MS="1000",
        PIO_SCALE_HYSTERESIS_TICKS="2",
        PIO_SCALE_DOWN_THRESHOLD="0.1",
    )
    storage = tf.storage_for(env)
    tf.train(storage, "one")
    fleet = tf.Fleet(env, replicas=1, elastic=True)
    codes: list = []
    stop_flood = threading.Event()

    def flood(idx):
        # sleepS keeps each accepted query resident for a beat, so the
        # admission queue stays occupied between snapshots
        n = 0
        while not stop_flood.is_set():
            n += 1
            try:
                status, _, _ = ts.query(fleet.base, {"user": f"f{idx}-{n}",
                                                     "sleepS": 0.25},
                                        timeout=20)
                codes.append(status)
            except (OSError, http.client.HTTPException):
                pass  # connection-level noise, judged by the HTTP codes

    try:
        doc = fleet.wait_ready()
        assert doc["targetReplicas"] == 1
        assert doc["elastic"]["enabled"] is True
        threads = [threading.Thread(target=flood, args=(i,))
                   for i in range(20)]
        for t in threads:
            t.start()
        try:
            grown = tf.poll(
                lambda: (lambda h: h if h.get("readyReplicas", 0) >= 2
                         else None)(fleet.healthz()),
                60, msg="scale-up to 2 ready replicas")
            assert grown["targetReplicas"] == 2
            assert grown["elastic"]["decisions"], "acted decision log empty"
            up = grown["elastic"]["decisions"][0]
            assert up["direction"] == "up"
            assert up["reason"] in ("shed", "utilization")
        finally:
            stop_flood.set()
            for t in threads:
                t.join(30)
        # quiet: drain back to the floor; the drained slot is released
        shrunk = tf.poll(
            lambda: (lambda h: h if (h.get("activeReplicas") == 1
                                     and not h.get("drainingReplicas"))
                     else None)(fleet.healthz()),
            90, msg="drain back to the floor")
        assert shrunk["targetReplicas"] == 1
        downs = [d for d in shrunk["elastic"]["decisions"]
                 if d["direction"] == "down"]
        assert downs and downs[-1]["reason"] == "quiet"
        # the directive record carries the acted decisions
        directive = tf.poll(
            lambda: (lambda v: v if (v.get("scale") or {}).get("target") == 1
                     else None)(model_artifact.read_fleet_doc(
                         storage, model_artifact.fleet_row_id(tf.GROUP))),
            10, msg="scale payload committed")
        assert [d["direction"] for d in directive["scale"]["decisions"]] \
            == ["up", "down"]
        bad = [c for c in codes if c not in (200, 503, 504)]
        assert not bad, f"non-contract responses: {sorted(set(bad))}"
        assert 200 in codes, "flood never got an accepted answer"
        fleet.stop()
    finally:
        storage.close()
        fleet.kill()
