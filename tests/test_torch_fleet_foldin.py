"""The online fold-in in a serving fleet on the CPU (the port's copies of
the three fleet cases of ``tests/test_online_foldin.py``): replica 0
produces and commits increments but the coordinator owns their publish
(and a deferred increment chains the next one), a standby replica
produces nothing, and the refresh knob's refusal in fleet mode is explicit
on ``/status`` and in ``pio status``.
"""

import io
import time
from contextlib import redirect_stdout

import pytest

pytest.importorskip("torch")

import torch_foldin_engine as fe  # noqa: E402
import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.data.storage import App, DataMap, Event, Storage  # noqa: E402
from incubator_predictionio_torch.tools.commands.management import (  # noqa: E402
    _print_engine_overload,
)
from incubator_predictionio_torch.workflow import core_workflow, model_artifact, online  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402
from incubator_predictionio_torch.workflow.persist import models_from_bytes  # noqa: E402

pytestmark = [pytest.mark.fleet]

FACTORY = "torch_foldin_engine.engine_factory"


def _mixed_storage(tmp_path) -> Storage:
    """Memory metadata and models, and a real JSONL event log."""
    return Storage({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events"),
    })


def _mk_app(storage) -> int:
    return storage.get_meta_data_apps().insert(App(0, "foldapp"))


def _rate(le, app_id, user, rating=1.0):
    le.insert(Event("rate", "user", user, "item", "i0",
                    DataMap({"rating": rating})), app_id)


def _train(storage) -> str:
    iid = core_workflow.run_train(
        fe.engine_factory(), fe.engine_params("foldapp"),
        WorkflowContext(app_name="foldapp", storage=storage, device="cpu"),
        engine_factory_name=FACTORY)
    time.sleep(0.002)
    return iid


def _server(storage, **kw):
    kw.setdefault("foldin_ms", 60)
    return EngineServer(fe.engine_factory(), engine_factory_name=FACTORY,
                        storage=storage, device="cpu", **kw)


def _increments(storage) -> list:
    return [r for r in storage.get_meta_data_engine_instances()
            .get_completed(FACTORY, "1", "default")
            if online.is_foldin_instance(r)]


def test_fleet_producer_commits_but_coordinator_owns_publish(tmp_path):
    storage = _mixed_storage(tmp_path)
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0")
    trained = _train(storage)
    server = _server(storage, fleet_replica=0, fleet_replicas=2,
                     fleet_sync_ms=100)
    with ts.serving(server) as base:
        _rate(le, app_id, "newbie", rating=5.0)
        # the increment lands in the store...
        rows = ts.wait_for(lambda: _increments(storage), 15)
        assert rows
        # ...but the replica does NOT publish it (no coordinator ran: no
        # directive, so the served instance stays the trained one)
        time.sleep(0.3)
        doc = ts.status(base)
        assert doc["engineInstanceId"] == trained
        assert doc["foldin"]["producer"] is True
        # while publication is deferred the next increment CHAINS onto the
        # previous one: the newest holds both batches
        n_before = len(rows)
        _rate(le, app_id, "second", rating=2.0)
        rows = ts.wait_for(lambda: (lambda rs: rs if len(rs) > n_before
                                    else None)(_increments(storage)), 15)
        assert rows
        newest = max(rows, key=lambda r: r.start_time)
        _, stored = models_from_bytes(
            model_artifact.read_model(storage, newest.id))
        scores = stored[0]["scores"]
        assert scores.get("newbie") == 5.0 and scores.get("second") == 2.0
        assert ts.status(base)["engineInstanceId"] == trained


def test_fleet_standby_replica_does_not_produce(tmp_path):
    storage = _mixed_storage(tmp_path)
    app_id = _mk_app(storage)
    le = storage.get_l_events()
    _rate(le, app_id, "u0")
    _train(storage)
    server = _server(storage, fleet_replica=1, fleet_replicas=2,
                     fleet_sync_ms=100)
    with ts.serving(server) as base:
        _rate(le, app_id, "newbie")
        time.sleep(0.5)
        assert _increments(storage) == []
        assert ts.status(base)["foldin"]["producer"] is False


def test_fleet_refresh_knob_refusal_is_explicit(tmp_path):
    storage = _mixed_storage(tmp_path)
    app_id = _mk_app(storage)
    _rate(storage.get_l_events(), app_id, "u0")
    _train(storage)
    server = EngineServer(fe.engine_factory(), engine_factory_name=FACTORY,
                          storage=storage, device="cpu", fleet_replica=0,
                          fleet_replicas=2, model_refresh_ms=5000)
    assert server.model_refresh_ms == 0.0
    assert server.lifecycle_snapshot()["refreshMs"] == "disabled(fleet)"
    # ...and the operator surface prints the reason, not "off"
    with ts.serving(server) as base:
        buf = io.StringIO()
        with redirect_stdout(buf):
            _print_engine_overload(base)
    assert "disabled(fleet)" in buf.getvalue()
    # a server outside a fleet still reports the number
    plain = EngineServer(fe.engine_factory(), engine_factory_name=FACTORY,
                         storage=storage, device="cpu",
                         model_refresh_ms=5000)
    assert plain.lifecycle_snapshot()["refreshMs"] == 5000.0
    plain.close()
