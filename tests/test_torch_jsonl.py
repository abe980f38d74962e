"""The port's JSONL event log (``data/storage/jsonl.py``,
``data/api/event_log.py``, ``data/api/log_tail.py``, the columnar
``PEventStore.find_ratings`` and the training window) on the CPU, held
against the JAX package's on the same directories.

- ``find_ratings`` through the columnar path equals the reference's on the
  same log and the row path (memory backend) over the same operations:
  tied times, deletes, re-inserts, upserts, ``buy`` defaults, unusable
  ratings and missing targets, over several generations and an
  uncompacted tail; windowed by explicit bounds and by the ambient
  ``PIO_TRAIN_WINDOW_START_US``.
- One directory serves both packages: a line written by either is
  byte-identical, a log compacted by either reads in the other, and the
  ``.g<N>.colseg`` bytes and the manifest (``compactedAt`` aside) are
  equal when both compact the same log at the same zip clock.
- A directory of ``.p<i>`` shards written by the reference (deletes that
  cross shards), compacted and not, reads in the port as in the
  reference; the port itself writes only the base log.
- A windowed scan skips generations by their manifest bounds and equals
  the row filter of the full scan.
- A failure at each ``compact.*`` / ``retire.rename`` fault point leaves
  the previous chain serving, and the next pass converges.
- ``retire_expired``, ``scrub_log_dir`` and the ``LogTailer`` cursors
  equal the reference's.
- ``run_train`` on a JSONL store is within 2e-4 of the reference's and
  seeds the same fold-in cursor.
- The verbs ``app new → import → eventlog compact → train --window →
  deploy`` in subprocesses with ``--device cpu``.
"""

import datetime as dt
import http.client
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu.controller import EngineParams as RefEngineParams  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api import event_log as ref_log  # noqa: E402
from incubator_predictionio_tpu.data.api import log_tail as ref_tail  # noqa: E402
from incubator_predictionio_tpu.data.storage import jsonl as ref_jsonl  # noqa: E402
from incubator_predictionio_tpu.data.store.p_event_store import (  # noqa: E402
    PEventStore as RefPEventStore,
)
from incubator_predictionio_tpu.models import recommendation as ref_rec  # noqa: E402
from incubator_predictionio_tpu.workflow import core_workflow as ref_core  # noqa: E402
from incubator_predictionio_tpu.workflow import model_artifact as ref_artifact  # noqa: E402
from incubator_predictionio_tpu.workflow.context import WorkflowContext as RefContext  # noqa: E402
from incubator_predictionio_tpu.workflow.workflow_params import (  # noqa: E402
    WorkflowParams as RefWorkflowParams,
)
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.controller import EngineParams  # noqa: E402
from incubator_predictionio_torch.data import storage as port_storage  # noqa: E402
from incubator_predictionio_torch.data.api import event_log, log_tail  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage import jsonl as port_jsonl  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402
from incubator_predictionio_torch.models import recommendation as port_rec  # noqa: E402
from incubator_predictionio_torch.workflow import core_workflow, model_artifact  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402

TOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
PORT_FACTORY = ("incubator_predictionio_torch.models.recommendation."
                "RecommendationEngine")
REF_FACTORY = ("incubator_predictionio_tpu.models.recommendation."
               "RecommendationEngine")
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
CREATED = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
#: the unusable and odd ratings the codec and the row path must agree on
RATINGS = [4.5, 1, "3.5", " 2 ", "n/a", "1_0", True, None, 1e999, "0x10"]


def _env(kind, root):
    if kind == "memory":
        return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
                for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
            "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY"}
    root.mkdir(parents=True, exist_ok=True)
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(root / "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(root / "events")}


def _wire(rng, k, month=1):
    """One seeded wire event: every seventh a ``buy`` without a rating,
    every eleventh without a target, ratings drawn from RATINGS, times on
    a coarse grid (ties)."""
    e = {"event": "buy" if k % 7 == 0 else "rate", "entityType": "user",
         "entityId": f"u{rng.integers(12)}",
         "eventTime": (T0.replace(month=month) + dt.timedelta(
             minutes=int(rng.integers(6)))).isoformat()}
    if k % 11:
        e |= {"targetEntityType": "item",
              "targetEntityId": f"i{rng.integers(15)}"}
    if e["event"] == "rate":
        e["properties"] = {"rating": RATINGS[rng.integers(len(RATINGS))]}
    return e


def _events(pkg, rng, n, month=1, start=0, ids=True):
    """``n`` Events of ``pkg`` with client event ids and a fixed creation
    time, so both packages write byte-identical lines."""
    out = []
    for k in range(start, start + n):
        wire = _wire(rng, k, month)
        if ids:
            wire["eventId"] = f"ev{k}"
        wire["creationTime"] = CREATED.isoformat()
        out.append(pkg.Event.from_json(wire))
    return out


def _populate(pkg, storage, log_compact, seed=0):
    """The same operations on any store: three batches (January, March,
    May), deletes, a re-insert after a delete and an upsert of a live id,
    with ``log_compact`` (or None) sealing a generation after the first
    two batches; the May batch stays an uncompacted tail. Returns the app
    id."""
    rng = np.random.default_rng(seed)
    app_id = storage.get_meta_data_apps().insert(pkg.App(0, "logapp"))
    le = storage.get_l_events()
    le.init(app_id)
    le.insert_batch(_events(pkg, rng, 60, month=1), app_id)
    le.delete_batch(["ev3", "ev4", "ev50"], app_id)
    if log_compact:
        log_compact()
    le.insert_batch(_events(pkg, rng, 60, month=3, start=60), app_id)
    # re-insert of a deleted id and an upsert of a live one
    le.insert_batch(_events(pkg, np.random.default_rng(99), 1, month=3,
                            start=3), app_id)
    le.insert_batch(_events(pkg, np.random.default_rng(98), 1, month=3,
                            start=10), app_id)
    le.delete("ev70", app_id)
    if log_compact:
        log_compact()
    le.insert_batch(_events(pkg, rng, 40, month=5, start=120, ids=False),
                    app_id)
    return app_id


def _log_path(root, app_id=1):
    return str(root / "events" / "pio_eventdata" / f"events_{app_id}.jsonl")


def _compactor(root, compact=event_log.compact_log):
    return lambda: compact(_log_path(root))


def _same_triples(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(got[3].to_dict().items()) == list(want[3].to_dict().items())
    assert list(got[4].to_dict().items()) == list(want[4].to_dict().items())


KW = {"event_names": ["rate", "buy"], "event_default_ratings": {"buy": 4.0}}
WINDOWS = {"full": (None, None),
           "from-march": (T0.replace(month=3), None),
           "until-march": (None, T0.replace(month=3)),
           "march-only": (T0.replace(month=3), T0.replace(month=4)),
           "mid-january": (T0 + dt.timedelta(minutes=2), None)}


@pytest.fixture()
def logs(tmp_path):
    """The port writes and compacts one JSONL store; the memory backend
    takes the same operations (the row path)."""
    port = Storage(_env("jsonl", tmp_path))
    _populate(port_storage, port, _compactor(tmp_path))
    mem = Storage(_env("memory", tmp_path))
    _populate(port_storage, mem, None)
    yield tmp_path, port, mem
    port.close()
    mem.close()


@pytest.mark.parametrize("window", list(WINDOWS), ids=list(WINDOWS))
def test_find_ratings_fast_path_equals_row_path_and_reference(logs, window):
    root, port, mem = logs
    start, until = WINDOWS[window]
    got = PEventStore.find_ratings("logapp", storage=port, start_time=start,
                                   until_time=until, **KW)
    _same_triples(got, PEventStore.find_ratings(
        "logapp", storage=mem, start_time=start, until_time=until, **KW))
    ref = ref_storage.Storage(_env("jsonl", root))
    _same_triples(got, RefPEventStore.find_ratings(
        "logapp", storage=ref, start_time=start, until_time=until, **KW))
    ref.close()
    assert len(got[0]) > 10


def test_ambient_window_equals_explicit_bounds(logs, monkeypatch):
    root, port, mem = logs
    start = T0.replace(month=3)
    monkeypatch.setenv("PIO_TRAIN_WINDOW_START_US",
                       str(int(start.timestamp() * 1e6)))
    ambient = PEventStore.find_ratings("logapp", storage=port, **KW)
    _same_triples(ambient, PEventStore.find_ratings(
        "logapp", storage=mem, **KW))
    monkeypatch.delenv("PIO_TRAIN_WINDOW_START_US")
    _same_triples(ambient, PEventStore.find_ratings(
        "logapp", storage=port, start_time=start, **KW))
    batch = PEventStore.find_batch("logapp", storage=mem, start_time=start)
    assert batch.event_time_us.min() >= start.timestamp() * 1e6


def test_lines_are_byte_identical_across_packages(tmp_path, monkeypatch):
    roots = {k: tmp_path / k for k in ("port", "ref")}
    for pkg, key in ((port_storage, "port"), (ref_storage, "ref")):
        # the same server-assigned ids in both packages
        counter = iter(range(1, 1 << 20))
        monkeypatch.setattr("os.urandom",
                            lambda n: next(counter).to_bytes(n, "big"))
        s = pkg.Storage(_env("jsonl", roots[key]))
        _populate(pkg, s, None)
        s.close()
    assert Path(_log_path(roots["port"])).read_bytes() == \
        Path(_log_path(roots["ref"])).read_bytes()


def _freeze_zip_clock(monkeypatch):
    """np.savez stamps each member with the wall clock (2 s resolution):
    one fixed clock makes the two packages' snapshot bytes comparable."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1_700_000_000.0, localtime=time.localtime))


def _manifest(path):
    doc = json.loads(Path(path + ".manifest").read_text())
    doc.pop("compactedAt")
    return doc


def test_snapshots_and_manifests_equal_and_read_across_packages(
        tmp_path, monkeypatch):
    _freeze_zip_clock(monkeypatch)
    roots = {k: tmp_path / k for k in ("port", "ref")}
    compacts = {"port": event_log.compact_log, "ref": ref_log.compact_log}
    for key in roots:
        s = Storage(_env("jsonl", roots[key]))
        _populate(port_storage, s, _compactor(roots[key], compacts[key]))
        s.close()
    paths = {k: _log_path(r) for k, r in roots.items()}
    assert _manifest(paths["port"]) == _manifest(paths["ref"])
    for gen in (1, 2):
        assert Path(f"{paths['port']}.g{gen}.colseg").read_bytes() == \
            Path(f"{paths['ref']}.g{gen}.colseg").read_bytes()
    # the reference reads the port's generations and the reverse
    for reader, writer in (("ref", "port"), ("port", "ref")):
        env = _env("jsonl", roots[writer])
        port = Storage(env)
        ref = ref_storage.Storage(env)
        pc, prow = port.get_p_events().scan_columnar(1)
        rc, rrow = ref.get_p_events().scan_columnar(1)
        assert np.array_equal(prow, rrow)
        for f in ("event", "eid", "teid", "event_id", "time_us", "span"):
            assert np.array_equal(getattr(pc, f), getattr(rc, f)), f
        assert np.array_equal(pc.rating, rc.rating, equal_nan=True)
        assert pc.tables == rc.tables and pc.raw == rc.raw
        _same_triples(PEventStore.find_ratings("logapp", storage=port, **KW),
                      RefPEventStore.find_ratings("logapp", storage=ref, **KW))
        port.close()
        ref.close()


def _write_shards(root, monkeypatch):
    """The reference's partitioned layout: two ``.p<i>`` shards of one
    app's log, written by the reference with ``PIO_EVENT_PARTITION`` set
    as its multi-worker event server sets it. Shard 1 deletes two ids that
    live in shard 0, then re-inserts one of them and upserts a shard-0
    id; shard 0 deletes an id of shard 1. Returns the shard paths."""
    rng = np.random.default_rng(5)
    for part, (month, start) in enumerate(((1, 0), (3, 40))):
        monkeypatch.setenv("PIO_EVENT_PARTITION", str(part))
        s = ref_storage.Storage(_env("jsonl", root))
        if part == 0:
            app_id = s.get_meta_data_apps().insert(ref_storage.App(0, "logapp"))
            s.get_l_events().init(app_id)
        le = s.get_l_events()
        le.insert_batch(_events(ref_storage, rng, 40, month, start), 1)
        if part == 1:
            le.delete_batch(["ev5", "ev6"], 1)
            le.insert_batch(_events(ref_storage, np.random.default_rng(97),
                                    1, 3, start=5), 1)
            le.insert_batch(_events(ref_storage, np.random.default_rng(96),
                                    1, 3, start=12), 1)
        s.close()
    monkeypatch.setenv("PIO_EVENT_PARTITION", "0")
    s = ref_storage.Storage(_env("jsonl", root))
    s.get_l_events().delete("ev45", 1)
    s.close()
    monkeypatch.delenv("PIO_EVENT_PARTITION")
    return [_log_path(root)[:-6] + f".p{i}.jsonl" for i in (0, 1)]


@pytest.mark.parametrize("compacted", [False, True],
                         ids=["uncompacted", "compacted"])
def test_reference_shards_read_as_one_merged_log(tmp_path, monkeypatch,
                                                 compacted):
    shards = _write_shards(tmp_path, monkeypatch)
    assert all(os.path.getsize(p) > 0 for p in shards)
    if compacted:
        for p in shards:
            ref_log.compact_log(p)
    env = _env("jsonl", tmp_path)
    port, ref = Storage(env), ref_storage.Storage(env)
    pc, prow = port.get_p_events().scan_columnar(1)
    rc, rrow = ref.get_p_events().scan_columnar(1)
    assert [pc.record_dict(i) for i in prow] == \
        [rc.record_dict(i) for i in rrow]
    got = [e.to_json() for e in port.get_p_events().find(1)]
    assert got == [e.to_json() for e in ref.get_p_events().find(1)]
    ids = [e["eventId"] for e in got]
    # a delete in one shard kills the id in every shard (the re-insert of
    # ev5 too); the upserted ev12 keeps one record
    assert not {"ev5", "ev6", "ev45"} & set(ids) and "ev12" in ids
    assert len(ids) == len(set(ids)) == 77
    _same_triples(PEventStore.find_ratings("logapp", storage=port, **KW),
                  RefPEventStore.find_ratings("logapp", storage=ref, **KW))
    port.close()
    ref.close()


def test_port_writes_the_base_log_whatever_the_partition_knob(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_EVENT_PARTITION", "1")
    s = Storage(_env("jsonl", tmp_path))
    _populate(port_storage, s, None)
    s.close()
    d = os.path.dirname(_log_path(tmp_path))
    assert sorted(os.listdir(d)) == ["events_1.jsonl"]


def test_windowed_scan_skips_generations_and_equals_the_row_filter(logs):
    root, port, _ = logs
    path = _log_path(root)
    event_log.compact_log(path)  # seal the May tail as generation 3
    may = int(T0.replace(month=5).timestamp() * 1e6)
    chain = event_log.load_chain(path, may, None)
    assert chain["skipped"] == 2
    assert [p[0] for p in chain["pieces"]] == ["skip", "skip", "cols"]
    assert ref_log.load_chain(path, may, None)["skipped"] == 2
    fresh = Storage(_env("jsonl", root))  # cold: the windowed chain load
    cols, rows = fresh.get_p_events().scan_columnar(
        1, start_time=T0.replace(month=5))
    full_cols, full_rows = port.get_p_events().scan_columnar(1)
    want = full_rows[full_cols.time_us[full_rows] >= may]
    assert [cols.record_dict(i) for i in rows] == \
        [full_cols.record_dict(i) for i in want]
    fresh.close()
    # the one-shot scan of one shard skips the same generations
    for bounds in ((None, None), (may, None)):
        got, *got_bytes = port_jsonl.scan_log_file(path, *bounds)
        ref, *ref_bytes = ref_jsonl.scan_log_file(path, *bounds)
        assert got_bytes == ref_bytes and got.size == ref.size
        assert got.tombstones == ref.tombstones
        assert [got.cols.record_dict(i) for i in range(len(got.cols))] == \
            [ref.cols.record_dict(i) for i in range(len(ref.cols))]


@pytest.mark.parametrize("point", ["compact.write", "compact.rename",
                                   "compact.manifest"])
def test_compaction_failure_at_each_point_converges(tmp_path, monkeypatch,
                                                    point):
    s = Storage(_env("jsonl", tmp_path))
    _populate(port_storage, s, _compactor(tmp_path))
    path = _log_path(tmp_path)
    before = json.loads(Path(path + ".manifest").read_text())
    want = s.get_p_events().scan_columnar(1)
    monkeypatch.setenv("PIO_FAULT_SPEC", f"{point}:fail:1")
    faultinject.reset()
    with pytest.raises(faultinject.InjectedFault):
        event_log.compact_log(path)
    # the previous chain still serves, unchanged
    assert json.loads(Path(path + ".manifest").read_text()) == before
    monkeypatch.delenv("PIO_FAULT_SPEC")
    faultinject.reset()
    m = event_log.compact_log(path)
    assert m["generation"] == 3 and len(m["generations"]) == 3
    assert not [n for n in os.listdir(os.path.dirname(path))
                if n.endswith(".tmp")]
    cols, covered = event_log.load_snapshot(path)
    assert covered == os.path.getsize(path)
    wcols, wrows = want
    fresh = Storage(_env("jsonl", tmp_path))
    got_cols, got_rows = fresh.get_p_events().scan_columnar(1)
    assert [got_cols.record_dict(i) for i in got_rows] == \
        [wcols.record_dict(i) for i in wrows]
    assert cols.raw == Path(path).read_bytes()
    s.close()
    fresh.close()


def _two_copies(tmp_path):
    src = tmp_path / "src"
    s = Storage(_env("jsonl", src))
    _populate(port_storage, s, _compactor(src))
    s.close()
    event_log.compact_log(_log_path(src))
    for key in ("port", "ref"):
        shutil.copytree(src, tmp_path / key)
    return {k: _log_path(tmp_path / k) for k in ("port", "ref")}


def _tree(path):
    d = Path(path).parent
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_retire_equals_the_reference(tmp_path, monkeypatch):
    paths = _two_copies(tmp_path)
    now = int(T0.replace(month=6).timestamp() * 1e6)
    ttl = 60 * 86_400 * 1_000_000  # everything before early April expires
    got = event_log.retire_expired(paths["port"], ttl_us=ttl, now_us=now)
    want = ref_log.retire_expired(paths["ref"], ttl_us=ttl, now_us=now)
    assert got == want and got["retired"] == 2
    strip = [{k: v for k, v in g.items() if k != "retiredAt"}
             for g in _manifest(paths["port"])["generations"]]
    assert strip == [{k: v for k, v in g.items() if k != "retiredAt"}
                     for g in _manifest(paths["ref"])["generations"]]
    assert _tree(paths["port"]) == _tree(paths["ref"])
    assert event_log.parse_floor(paths["port"]) == got["floor"] > 0
    # a crash at the commit leaves the prior state, the next pass converges
    monkeypatch.setenv("PIO_FAULT_SPEC", "retire.rename:fail:1")
    faultinject.reset()
    with pytest.raises(faultinject.InjectedFault):
        event_log.retire_expired(paths["port"], ttl_us=1, now_us=now * 2)
    assert event_log.parse_floor(paths["port"]) == got["floor"]
    monkeypatch.delenv("PIO_FAULT_SPEC")
    faultinject.reset()
    assert event_log.retire_expired(paths["port"], ttl_us=1,
                                    now_us=now * 2)["retired"] == 1


def test_scrub_equals_the_reference(tmp_path):
    paths = _two_copies(tmp_path)
    for p in paths.values():
        snap = Path(f"{p}.g2.colseg")
        blob = bytearray(snap.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        snap.write_bytes(bytes(blob))
    got = event_log.scrub_log_dir(os.path.dirname(paths["port"]))
    assert got == ref_log.scrub_log_dir(os.path.dirname(paths["ref"]))
    assert got["quarantined"] == 1
    assert _manifest(paths["port"]) == _manifest(paths["ref"])
    assert _tree(paths["port"]) == _tree(paths["ref"])
    health = event_log.partition_health(os.path.dirname(paths["port"]))
    assert health["quarantinedFiles"] == 1
    assert [g["generation"] for g in health["logs"][0]["generations"]] == [1]


def test_tail_cursors_equal_the_reference(tmp_path):
    paths = _two_copies(tmp_path)
    d = os.path.dirname(paths["port"])
    port, ref = log_tail.LogTailer(d, 1), ref_tail.LogTailer(d, 1)
    got, want = port.read_since(None), ref.read_since(None)
    assert got.events == want.events and got.snapshot_seeded
    assert got.cursor.to_json() == want.cursor.to_json()
    with open(paths["port"], "ab") as f:
        f.write(b'{"event": "rate", "entityType": "user", "entityId": "x", '
                b'"eventTime": "2024-07-01T00:00:00.000Z"}\n{"partial": ')
    cursor = log_tail.LogCursor.from_json(got.cursor.to_json())
    more = port.read_since(cursor)
    assert more.events == ref.read_since(
        ref_tail.LogCursor.from_json(want.cursor.to_json())).events
    assert [e["entityId"] for e in more.events] == ["x"]
    assert port.end_cursor().to_json() == ref.end_cursor().to_json()
    assert port.lag_bytes(cursor) == ref.lag_bytes(
        ref_tail.LogCursor.from_json(want.cursor.to_json()))
    paged = port.read_since(None, max_bytes=4096)
    assert paged.cursor.to_json() == ref.read_since(
        None, max_bytes=4096).cursor.to_json()


def _engine_json(factory, app="logapp"):
    return {"id": "default", "engineFactory": factory,
            "datasource": {"params": {"appName": app}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": 5, "lambda": 0.05,
                "lambdaScaling": "nratings", "seed": 7}}]}


def test_run_train_on_a_log_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    env = _env("jsonl", tmp_path)
    ref = ref_storage.Storage(env)
    _populate(ref_storage, ref,
              lambda: ref_log.compact_log(_log_path(tmp_path)))
    port = Storage(env)
    ej = _engine_json(PORT_FACTORY)
    iid = core_workflow.run_train(
        port_rec.RecommendationEngine()(), EngineParams.from_json(ej),
        WorkflowContext(app_name="logapp", storage=port, device="cpu"),
        engine_factory_name=PORT_FACTORY)
    ref_ej = _engine_json(REF_FACTORY)
    ref_core.run_train(
        ref_rec.RecommendationEngine()(), RefEngineParams.from_json(ref_ej),
        RefContext(app_name="logapp", storage=ref),
        RefWorkflowParams(device="cpu"), engine_factory_name=REF_FACTORY)
    dep, instance, _ = core_workflow.load_deployment(
        port_rec.RecommendationEngine()(), None,
        WorkflowContext(storage=port, device="cpu"),
        engine_factory_name=PORT_FACTORY)
    ref_dep, _, _ = ref_core.load_deployment(
        ref_rec.RecommendationEngine()(), None, RefContext(storage=ref),
        engine_factory_name=REF_FACTORY)
    assert instance.id == iid
    m, rm = dep.models[0], ref_dep.models[0]
    np.testing.assert_allclose(m.factors.user_factors,
                               rm.factors.user_factors, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m.factors.item_factors,
                               rm.factors.item_factors, rtol=TOL, atol=TOL)
    assert list(m.users.to_dict().items()) == list(rm.users.to_dict().items())
    # the fold-in cursor row: the reference's key rule and document
    rows = {}
    for factory in (PORT_FACTORY, REF_FACTORY):
        group = ref_artifact.fleet_group(factory, "default")
        row_id = ref_artifact.foldin_row_id(group, 1)
        assert row_id == model_artifact.foldin_row_id(
            model_artifact.fleet_group(factory, "default"), 1)
        rows[factory] = model_artifact.read_fleet_doc(port, row_id)
    got, want = rows[PORT_FACTORY], rows[REF_FACTORY]
    assert got["cursor"] == want["cursor"]
    assert got["cursor"]["shards"] == {
        "events_1.jsonl": os.path.getsize(_log_path(tmp_path))}
    ignore = {"group", "updatedAt"}
    assert {k: v for k, v in got.items() if k not in ignore} == \
        {k: v for k, v in want.items() if k not in ignore}
    port.close()
    ref.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_import_compact_train_window_deploy(tmp_path):
    """The user's path on a JSONL event store, each verb in its own
    process on the CPU: the windowed train reads exactly the events at
    or after the resolved bound, the deploy serves the newest train."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env |= _env("jsonl", tmp_path / "base") | {
        "PYTHONPATH": str(ROOT), "PIO_FS_BASEDIR": str(tmp_path / "base")}
    con = [sys.executable, "-m", "incubator_predictionio_torch.tools.console"]

    def run(*args):
        out = subprocess.run(con + list(args), capture_output=True,
                             text=True, env=env, cwd=tmp_path, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    run("app", "new", "cliapp")
    now = dt.datetime.now(dt.timezone.utc)
    wire = [{"event": "rate", "entityType": "user", "entityId": f"u{k % 9}",
             "targetEntityType": "item", "targetEntityId": f"i{k % 7}",
             "properties": {"rating": float(1 + k % 5)},
             "eventTime": (now - dt.timedelta(days=60 - k)).isoformat()}
            for k in range(60)]
    (tmp_path / "ev.jsonl").write_text(
        "\n".join(json.dumps(e) for e in wire) + "\n")
    assert "Imported 60 events" in run("import", "--app-name", "cliapp",
                                       "--input", str(tmp_path / "ev.jsonl"))
    assert "generation 1, 60 event(s)" in run("eventlog", "compact")
    (tmp_path / "engine.json").write_text(json.dumps(
        _engine_json(PORT_FACTORY, "cliapp")))
    out = subprocess.run(con + ["train", "--device", "cpu", "--window", "2x"],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 1 and "--window '2x'" in out.stderr
    trained = json.loads(run("train", "--device", "cpu", "--window",
                             "30d").strip().splitlines()[-1])
    start = trained["window"]["startUs"]
    expect = sum(1 for e in wire if dt.datetime.fromisoformat(
        e["eventTime"]).timestamp() * 1e6 >= start)
    assert 25 <= trained["timings"]["ratings_read"] == expect <= 35
    assert "g1: [" in run("eventlog", "status")

    port = _free_port()
    proc = subprocess.Popen(con + ["deploy", "--device", "cpu", "--port",
                                   str(port)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=tmp_path)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/")
                info = json.loads(conn.getresponse().read())
                break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.2)
        assert info["engineInstanceId"] == trained["engineInstanceId"]
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": "u1", "num": 3}))
        answer = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert len(answer["itemScores"]) == 3
