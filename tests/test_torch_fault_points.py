"""Chaos tests that arm the port's remaining fault points through
``PIO_FAULT_SPEC``, each with the reference test's contract:

- ``archive.put`` / ``archive.manifest``: a failed archive leaves the hot
  copy of the generation authoritative (file kept, manifest tier "hot",
  reads unchanged) and a clean rerun converges;
- ``wal.mark``: the store confirmed a group but its commit marker was
  lost; the POST still answers 201 and recovery dedupes by event id;
- ``query.batch_predict``: a micro-batch that overruns its query's
  deadline answers 504 and the batcher keeps serving.

With them every fault point of the package is armed by a test
(``pio lint``'s ``fault-point-coverage``).
"""

import os

import pytest
import requests

pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api import (  # noqa: E402
    event_log, ingest_wal,
)
from incubator_predictionio_torch.data.api.event_server import (  # noqa: E402
    EventServer,
)
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    EngineServer,
)
from test_torch_eventlog_archive import (  # noqa: E402
    _build, _env, _log_path, _tiers,
)
from test_torch_ingest_wal import KEY, _ev, _store  # noqa: E402


@pytest.fixture()
def chaos(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PIO_FAULT_SPEC", spec)
        faultinject.reset()

    yield arm
    monkeypatch.delenv("PIO_FAULT_SPEC", raising=False)
    faultinject.reset()


def _event_ids(root, app_id):
    storage = port_pkg.Storage(_env(root))
    try:
        return sorted(e.event_id for e in storage.get_l_events().find(app_id))
    finally:
        storage.close()


@pytest.mark.parametrize("point", ["archive.put", "archive.manifest"])
def test_failed_archive_keeps_the_hot_copy_and_a_rerun_converges(
        tmp_path, monkeypatch, chaos, point):
    app_id = _build(tmp_path)
    log = _log_path(tmp_path)
    g1 = event_log._read_manifest(log)["generations"][0]
    local = os.path.join(os.path.dirname(log), g1["file"])
    before = _event_ids(tmp_path, app_id)
    assert len(before) == 150
    for k, v in _env(tmp_path).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PIO_EVENT_ARCHIVE_SOURCE", "COLD")
    storage = port_pkg.Storage(_env(tmp_path))
    try:
        chaos(f"{point}:fail:1")
        with pytest.raises(Exception):
            event_log.archive_generation(log, 1, storage=storage)
        chaos("")
        assert os.path.exists(local), point
        assert _tiers(tmp_path)[0] == (1, "hot"), point
        assert _event_ids(tmp_path, app_id) == before, point
        entry = event_log.archive_generation(log, 1, storage=storage)
        assert entry["tier"] == "archived" and not os.path.exists(local)
        assert event_log.archive_generation(
            log, 1, storage=storage)["tier"] == "archived"
    finally:
        storage.close()


def test_lost_wal_marker_answers_201_and_recovery_dedupes(
        tmp_path, monkeypatch, chaos):
    """The store confirmed the group, then the WAL's commit marker failed
    (the crash window between store and marker): the POST is not a 500,
    and recovery dedupes the event by id instead of writing it twice."""
    monkeypatch.setenv("PIO_WAL", "1")
    monkeypatch.setenv("PIO_WAL_DIR", str(tmp_path / "wal"))
    storage, app_id = _store(port_pkg, tmp_path, "mark")
    chaos("wal.mark:fail:1")
    server = EventServer(storage, "127.0.0.1", 0)
    host, port = server.start()
    try:
        r = requests.post(f"http://{host}:{port}/events.json?accessKey={KEY}",
                          json=_ev(1), timeout=30)
        assert r.status_code == 201, r.text
        eid = r.json()["eventId"]
    finally:
        server.stop()
    le = storage.get_l_events()
    assert [e.event_id for e in le.find(app_id)] == [eid]
    summary = ingest_wal.recover(storage)
    assert summary["deduped"] == 1 and summary["replayed"] == 0
    assert [e.event_id for e in le.find(app_id)] == [eid]
    storage.close()


def test_slow_micro_batch_answers_504_and_the_batcher_keeps_serving(chaos):
    storage = ts.memory_storage()
    ts.train_lifecycle(storage, "one")
    server = EngineServer(ts.lifecycle_engine(),
                          engine_factory_name="lifecycle", storage=storage,
                          device="cpu", batch_window_ms=5.0, max_batch=4,
                          query_conc=1, query_max_pending=4,
                          query_deadline_ms=20_000)
    # armed after construction: the batch-shape warm-up walks
    # query.batch_predict too and would spend the rule
    chaos("query.batch_predict:latency:1:0.5")
    with ts.serving(server) as base:
        code, _, _ = ts.query(base, {"user": "u1"},
                              headers={"X-Pio-Deadline-Ms": "100"})
        assert code == 504
        assert ts.wait_for(
            lambda: ts.status(base)["overload"]["pending"] == 0, 10)
        code, doc, _ = ts.query(base, {"user": "u2"})
        assert code == 200 and doc["tag"] == "one"
