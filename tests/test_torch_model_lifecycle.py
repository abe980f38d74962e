"""The port's validated model lifecycle on the CPU:
``tests/test_model_lifecycle.py``'s contracts on the port's engine server
(the lifecycle engine of ``tests/torch_serving.py``, whose models persist
as arrays): a NaN model is refused by the gate and serving stays on
last-good; an initial deploy pins a refused newest instance and walks
back; refresh swaps; the watch window hedges failing queries onto the
previous model and rolls back on the error rate (504s of a slow canary
count too); ``/rollback`` pins and ``/reload?instance=`` removes the pin;
the serving stages' fault points answer 500; and ``pio models
list|verify|gc|rollback``.
"""

import dataclasses
import datetime as dt
import json
import threading

import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage.base import Model  # noqa: E402
from incubator_predictionio_torch.tools.console import main as pio  # noqa: E402
from incubator_predictionio_torch.workflow import model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    EngineServer,
)


@pytest.fixture()
def chaos(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PIO_FAULT_SPEC", spec)
        faultinject.reset()
    yield arm
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faultinject.reset()


@pytest.fixture()
def store():
    return ts.memory_storage()


def _server(storage, **kw):
    return EngineServer(ts.lifecycle_engine(), engine_factory_name="lifecycle",
                        storage=storage, device="cpu", **kw)


def _tag(base, user="u"):
    code, doc, _ = ts.query(base, {"user": user})
    assert code == 200, doc
    return doc["tag"]


def _lifecycle(base):
    return ts.status(base)["lifecycle"]


def test_initial_deploy_walks_back_past_validation_failure(store):
    iid1 = ts.train_lifecycle(store, "one")
    nan_iid = ts.train_lifecycle(store, "broken", mode="nan")
    server = _server(store)
    assert server.instance.id == iid1
    lc = server.lifecycle_snapshot()
    assert lc["pinned"] == {nan_iid: "validate"}
    assert lc["validateFailures"] == 1
    assert server.deployment.query({"user": "u"})["tag"] == "one"


def test_nan_model_refused_by_gate_and_pinned_by_refresh(store):
    """The refresh loop's validated swap hits the NaN guard: serving stays
    on last-good, the instance is pinned, degraded is set; a good retrain
    heals it (refresh swaps)."""
    iid1 = ts.train_lifecycle(store, "one")
    with ts.serving(_server(store, model_refresh_ms=50)) as base:
        nan_iid = ts.train_lifecycle(store, "broken", mode="nan")
        lc = ts.wait_for(lambda: (lambda c: c if c["pinned"] else None)(
            _lifecycle(base)))
        assert lc["pinned"] == {nan_iid: "validate"}, lc
        assert lc["instance"] == iid1 and lc["validateFailures"] >= 1
        doc = ts.status(base)
        assert doc["degraded"] and "non-finite" in doc["degradedReason"]
        assert _tag(base) == "one"
        good2 = ts.train_lifecycle(store, "fresh")
        doc = ts.wait_for(lambda: (lambda d: d if d["engineInstanceId"]
                                   == good2 else None)(ts.status(base)))
        assert doc["degraded"] is False
        assert doc["lifecycle"]["refreshSwaps"] >= 1
        assert doc["lifecycle"]["previous"] == iid1
        assert _tag(base) == "fresh"


def test_auto_rollback_on_error_rate_hedges_onto_last_good(store):
    """A model that passes the gate but fails real traffic: each failure
    is hedged onto the retained previous model (clients see 200), and past
    the error rate the swap rolls back and the bad instance is pinned."""
    iid1 = ts.train_lifecycle(store, "one")
    server = _server(store, swap_watch_ms=60_000, swap_max_error_rate=0.3)
    bad = ts.train_lifecycle(store, "bad", mode="poison")
    with ts.serving(server) as base:
        code, doc, _ = ts.call(base, "GET", "/reload")
        assert code == 200 and doc["engineInstanceId"] == bad
        assert [_tag(base, f"u{i}") for i in range(6)] == ["one"] * 6
        lc = _lifecycle(base)
        assert lc["instance"] == iid1
        assert lc["pinned"] == {bad: "error-rate"}
        assert lc["rollbacks"] == {"error-rate": 1}
        # the rolled-back model stays pinned: reload-latest keeps last-good
        code, doc, _ = ts.call(base, "GET", "/reload")
        assert code == 200 and doc["engineInstanceId"] == iid1


def test_watch_straggler_after_rollback_served_not_500(store):
    """A failure landing on a deployment that is no longer live (a
    rollback cleared the watch meanwhile) is retried on the live model."""
    ts.train_lifecycle(store, "one")
    server = _server(store, swap_watch_ms=60_000, swap_max_error_rate=0.3)
    ts.train_lifecycle(store, "bad", mode="poison")
    with ts.serving(server) as base:
        assert ts.call(base, "GET", "/reload")[0] == 200
        assert [_tag(base, f"u{i}") for i in range(2)] == ["one", "one"]
        assert _lifecycle(base)["rollbacks"] == {"error-rate": 1}

        class _RetiredCanary:
            def query(self, q):
                raise RuntimeError("late canary failure")

        out = server._watched_failure(_RetiredCanary(), {"user": "s"}, None)
        assert out is not None and out["tag"] == "one"


def test_hedge_overrun_answers_504_not_500(store):
    """When the hedge itself runs out of budget the client gets 504, and
    the overrun does not count against the watch."""
    ts.train_lifecycle(store, "one")
    server = _server(store, swap_watch_ms=60_000, swap_max_error_rate=0.3)
    bad = ts.train_lifecycle(store, "bad", mode="poison")
    with ts.serving(server) as base:
        assert ts.call(base, "GET", "/reload")[1]["engineInstanceId"] == bad
        code, doc, _ = ts.query(base, {"user": "slow", "sleepS": 0.4},
                                headers={"X-Pio-Deadline-Ms": "150"})
        assert code == 504, doc
        status = ts.status(base)
        assert status["overload"]["deadlineExceeded"] >= 1
        assert status["lifecycle"]["instance"] == bad
        assert status["lifecycle"]["rollbacks"] == {}
        assert _tag(base, "after") == "one"


def test_slow_canary_times_out_into_rollback(store):
    """A swapped-in model whose queries overrun their deadline in compute
    trips the watch and rolls back: 504s are failures too."""
    iid1 = ts.train_lifecycle(store, "one")
    server = _server(store, query_deadline_ms=100, swap_watch_ms=60_000,
                     swap_max_error_rate=0.3)
    iid2 = ts.train_lifecycle(store, "two")
    with ts.serving(server) as base:
        assert ts.call(base, "GET", "/reload")[1]["engineInstanceId"] == iid2
        codes = [ts.query(base, {"user": f"u{i}", "sleepS": 0.2})[0]
                 for i in range(2)]
        assert codes == [504, 504]
        lc = _lifecycle(base)
        assert lc["rollbacks"] == {"error-rate": 1}
        assert lc["instance"] == iid1 and lc["pinned"] == {iid2: "error-rate"}


def test_query_stage_faults_surface_as_500(store, chaos):
    ts.train_lifecycle(store, "one")
    with ts.serving(_server(store)) as base:
        for point in ("query.featurize", "query.predict", "query.serve"):
            chaos(f"{point}:fail:1")
            assert ts.query(base, {"user": "u1"})[0] == 500, point
            assert ts.query(base, {"user": "u1"})[0] == 200, point


def test_reload_explicit_instance_and_manual_rollback(store):
    iid1 = ts.train_lifecycle(store, "one")
    iid2 = ts.train_lifecycle(store, "two")
    server = _server(store)
    assert server.instance.id == iid2
    with ts.serving(server) as base:
        code, doc, _ = ts.call(base, "GET", f"/reload?instance={iid1}")
        assert code == 200 and doc["engineInstanceId"] == iid1
        assert _tag(base) == "one"
        lc = _lifecycle(base)
        assert lc["instance"] == iid1 and lc["previous"] == iid2
        # unknown target → 500 + degraded, still serving iid1
        assert ts.call(base, "GET", "/reload?instance=nope")[0] == 500
        assert ts.status(base)["degraded"]
        assert _tag(base) == "one"
        # back to latest, then /rollback swaps to previous and PINS it
        assert ts.call(base, "GET", "/reload")[0] == 200
        code, doc, _ = ts.call(base, "POST", "/rollback")
        assert code == 200 and doc["engineInstanceId"] == iid1
        lc = _lifecycle(base)
        assert lc["instance"] == iid1 and lc["pinned"] == {iid2: "manual"}
        assert lc["rollbacks"] == {"manual": 1}
        # pinned: reload-latest does not re-pick iid2
        assert ts.call(base, "GET", "/reload")[1]["engineInstanceId"] == iid1
        # no previous left → 409
        assert ts.call(base, "POST", "/rollback")[0] == 409
        # an explicit reload of the pinned instance un-pins it
        code, doc, _ = ts.call(base, "GET", f"/reload?instance={iid2}")
        assert code == 200 and doc["engineInstanceId"] == iid2
        assert _lifecycle(base)["pinned"] == {}


def test_pin_holds_across_refresh_polls(store):
    """/rollback pins the newer instance; the refresh loop polls past it
    and never re-picks it until /reload?instance= removes the pin."""
    ts.train_lifecycle(store, "one")
    with ts.serving(_server(store, model_refresh_ms=40)) as base:
        iid2 = ts.train_lifecycle(store, "two")
        assert ts.wait_for(lambda: _tag(base) == "two")
        assert ts.call(base, "POST", "/rollback")[0] == 200
        import time

        time.sleep(0.25)  # ≥ 5 refresh polls
        lc = _lifecycle(base)
        assert lc["pinned"] == {iid2: "manual"} and lc["refreshSwaps"] == 1
        assert _tag(base) == "one"
        assert ts.call(base, "GET", f"/reload?instance={iid2}")[0] == 200
        assert _lifecycle(base)["pinned"] == {} and _tag(base) == "two"


def test_swap_validate_failure_under_query_fire(store, chaos):
    iid1 = ts.train_lifecycle(store, "one")
    server = _server(store)
    ts.train_lifecycle(store, "two")
    stop = threading.Event()
    codes: list[int] = []
    with ts.serving(server) as base:
        def fire():
            while not stop.is_set():
                codes.append(ts.query(base, {"user": "u1"})[0])

        threads = [threading.Thread(target=fire) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            chaos("swap.validate:fail:1")
            code, doc, _ = ts.call(base, "GET", "/reload")
            assert code == 500 and "swap validation" in doc["message"]
            status = ts.status(base)
            assert status["degraded"] is True
            assert status["engineInstanceId"] == iid1
            assert status["lifecycle"]["validateFailures"] == 1
            code, doc, _ = ts.call(base, "GET", "/reload")
            assert code == 200 and doc["engineInstanceId"] != iid1
        finally:
            stop.set()
            for t in threads:
                t.join(30)
    assert codes and set(codes) == {200}, set(codes)


def test_completed_row_without_model_skipped(store):
    iid1 = ts.train_lifecycle(store, "one")
    instances = store.get_meta_data_engine_instances()
    good = instances.get(iid1)
    instances.insert(dataclasses.replace(
        good, id="orphan-completed",
        start_time=good.start_time + dt.timedelta(seconds=5)))
    before = model_artifact.integrity_failure_counts().get("missing", 0)
    server = _server(store)
    assert server.instance.id == iid1
    assert model_artifact.integrity_failure_counts()["missing"] == before + 1


def _sqlite_env(tmp_path):
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite")}


@pytest.fixture()
def sqlite_instance(tmp_path, monkeypatch):
    """The process's ``Storage.instance()`` on a SQLite file for the
    console's verbs; the in-memory default restored after."""
    env = _sqlite_env(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    storage = Storage.reset_instance(env)
    yield storage
    Storage.reset_instance(dict(ts.MEM_ENV))


def test_pio_models_cli_list_verify_gc(sqlite_instance, capsys):
    storage = sqlite_instance
    iids = [ts.train_lifecycle(storage, f"t{i}") for i in range(4)]
    dao = storage.get_model_data_models()
    # corrupt one; strip the newest one's blob (a crash-window row: it must
    # not take a place of the GC keep window)
    t = bytearray(dao.get(iids[1]).models)
    t[-2] ^= 0x04
    dao.insert(Model(iids[1], bytes(t)))
    dao.delete(iids[3])

    assert pio(["models", "list"]) == 0
    out = capsys.readouterr().out
    assert "CORRUPT (checksum)" in out and "no model (crash window" in out
    assert out.count("verified") == 2
    assert pio(["models", "verify"]) == 1       # corruption → rc 1
    capsys.readouterr()
    assert pio(["models", "gc", "--keep", "1", "--dry-run"]) == 0
    assert "would delete" in capsys.readouterr().out
    assert dao.get(iids[2]) is not None
    assert pio(["models", "gc", "--keep", "1"]) == 0
    capsys.readouterr()
    assert dao.get(iids[2]) is not None     # the newest with a blob stays
    assert dao.get(iids[1]) is None and dao.get(iids[0]) is None
    assert pio(["models", "verify"]) == 0
    assert "0 corrupt" in capsys.readouterr().out


def test_pio_models_gc_protects_served_and_rollback_via_url(sqlite_instance,
                                                            capsys):
    """``gc --engine-url`` keeps the live server's deployed, previous and
    pinned instances; ``models rollback`` (and ``deploy --rollback``) POST
    /rollback."""
    storage = sqlite_instance
    iids = [ts.train_lifecycle(storage, f"t{i}") for i in range(4)]
    server = _server(storage)
    with ts.serving(server) as base:
        assert ts.call(base, "GET", f"/reload?instance={iids[0]}")[0] == 200
        assert pio(["models", "rollback", "--engine-url", base]) == 0
        assert "now serving " + iids[3] in capsys.readouterr().out
        # served iids[3], previous none, pinned iids[0]; keep 1 (iids[3])
        assert ts.call(base, "GET", f"/reload?instance={iids[1]}")[0] == 200
        lc = _lifecycle(base)
        assert (lc["instance"], lc["previous"]) == (iids[1], iids[3])
        assert lc["pinned"] == {iids[0]: "manual"}
        assert pio(["models", "gc", "--keep", "1", "--engine-url", base]) == 0
        out = capsys.readouterr().out
        assert "protected=3" in out
        dao = storage.get_model_data_models()
        assert [dao.get(i) is not None for i in iids] == [
            True, True, False, True]
        host, port = base.rsplit(":", 1)
        assert pio(["deploy", "--rollback", "--ip", "127.0.0.1",
                    "--port", port]) == 0
        assert _lifecycle(base)["instance"] == iids[3]
    assert pio(["models", "gc", "--keep", "1", "--engine-url",
                "http://127.0.0.1:9"]) == 1
    assert "refusing to GC" in capsys.readouterr().err


def test_undeploy_drains_and_stops_the_server(store, capsys):
    ts.train_lifecycle(store, "one")
    server = _server(store)
    host, port = server.start("127.0.0.1", 0)
    try:
        assert pio(["undeploy", "--ip", host, "--port", str(port)]) == 0
        assert "Shutting down." in capsys.readouterr().out
        server._serve_thread.join(10)
        assert not server._serve_thread.is_alive()
    finally:
        server.stop()
    assert pio(["undeploy", "--ip", host, "--port", str(port)]) == 1


def test_golden_query_from_instance_row_or_env(store, monkeypatch):
    """The gate's smoke predict uses the instance row's golden query, else
    $PIO_GOLDEN_QUERY, else the model's example_query()."""
    iid = ts.train_lifecycle(store, "one", mode="poison")
    server_dep = _server(store, swap_validate=False)
    inst = store.get_meta_data_engine_instances().get(iid)
    golden = server_dep._golden_query(inst, server_dep.deployment)
    assert golden == {"user": "golden"}
    monkeypatch.setenv("PIO_GOLDEN_QUERY", json.dumps({"user": "env"}))
    assert server_dep._golden_query(inst, server_dep.deployment) == {
        "user": "env"}
    # a poison model fails the smoke predict of a non-golden user: the
    # initial deploy pins it and finds nothing older
    with pytest.raises(RuntimeError, match="excluded"):
        _server(store)
