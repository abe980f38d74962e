"""Archive and restore of event-log generations (``incubator_predictionio_
torch/data/api/event_log.py`` ``archive_generation`` /
``restore_generation``, ``load_chain(storage=)``, ``pio eventlog
archive|restore``) held against the JAX package's: a generation archived
by either package to a localfs cold source restores in the other
(byte-identical snapshot, the same manifest tiers); a windowed load that
needs an archived generation raises ``ArchivedGenerationError`` under
``on_archived="raise"``, restores it on demand under
``PIO_EVENT_RESTORE_ON_DEMAND=1`` and then equals the reference's load
and the read before the archive; the verbs round-trip and count into the
telemetry.
"""

import datetime as dt
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api import event_log as ref_log  # noqa: E402
from incubator_predictionio_tpu.data.store import (  # noqa: E402
    PEventStore as RefPEventStore,
)
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api import event_log  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
KW = {"event_names": ["rate"]}


def _env(root):
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(root / "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "JSONL",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(root / "events"),
            "PIO_STORAGE_SOURCES_COLD_TYPE": "LOCALFS",
            "PIO_STORAGE_SOURCES_COLD_PATH": str(root / "cold")}


def _log_path(root):
    return str(root / "events" / "pio_eventdata" / "events_1.jsonl")


def _build(root):
    """One app's log with three sealed generations (January, March, May)
    of seeded rate events, written and compacted by the port."""
    root.mkdir(parents=True, exist_ok=True)
    storage = port_pkg.Storage(_env(root))
    app_id = storage.get_meta_data_apps().insert(port_pkg.App(0, "arch"))
    le = storage.get_l_events()
    le.init(app_id)
    rng = np.random.default_rng(5)
    k = 0
    for month in (1, 3, 5):
        evs = []
        for _ in range(50):
            evs.append(port_pkg.Event.from_json({
                "event": "rate", "entityType": "user",
                "entityId": f"u{rng.integers(10)}",
                "targetEntityType": "item",
                "targetEntityId": f"i{rng.integers(12)}",
                "properties": {"rating": float(rng.integers(1, 6))},
                "eventId": f"ev{k}",
                "eventTime": (T0.replace(month=month) + dt.timedelta(
                    hours=int(rng.integers(48)))).isoformat(),
                "creationTime": "2026-01-01T00:00:00+00:00"}))
            k += 1
        le.insert_batch(evs, app_id)
        event_log.compact_log(_log_path(root))
    storage.close()
    return app_id


def _manifest(root):
    with open(_log_path(root) + ".manifest") as f:
        return json.load(f)


def _tiers(root):
    return [(g["generation"], g.get("tier", "hot"))
            for g in _manifest(root)["generations"]]


def _same(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(got[3].to_dict().items()) == list(want[3].to_dict().items())
    assert list(got[4].to_dict().items()) == list(want[4].to_dict().items())


@pytest.mark.parametrize("archiver,restorer", [("port", "ref"),
                                               ("ref", "port")])
def test_archive_in_one_package_restores_in_the_other(tmp_path, monkeypatch,
                                                      archiver, restorer):
    monkeypatch.setenv("PIO_EVENT_ARCHIVE_SOURCE", "COLD")
    _build(tmp_path)
    path = _log_path(tmp_path)
    first = _manifest(tmp_path)["generations"][0]
    snap = os.path.join(os.path.dirname(path), first["file"])
    with open(snap, "rb") as f:
        original = f.read()
    mods = {"port": (event_log, port_pkg), "ref": (ref_log, ref_storage)}
    log_mod, pkg = mods[archiver]
    storage = pkg.Storage(_env(tmp_path))
    entry = log_mod.archive_generation(path, first["generation"],
                                       storage=storage)
    storage.close()
    assert entry["tier"] == "archived"
    assert entry["archive"]["source"] == "COLD"
    assert entry["archive"]["id"] == f"events_1.jsonl.g{first['generation']}"
    assert not os.path.exists(snap)
    assert _tiers(tmp_path)[0][1] == "archived"
    log_mod, pkg = mods[restorer]
    storage = pkg.Storage(_env(tmp_path))
    back = log_mod.restore_generation(path, first["generation"],
                                      storage=storage)
    storage.close()
    assert back["tier"] == "hot" and "archive" not in back
    with open(snap, "rb") as f:
        assert f.read() == original
    assert [t for _, t in _tiers(tmp_path)] == ["hot"] * 3


def test_windowed_load_raises_restores_and_equals_reference(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("PIO_EVENT_ARCHIVE_SOURCE", "COLD")
    app_id = _build(tmp_path)
    path = _log_path(tmp_path)
    until = T0.replace(month=4)
    until_us = int(until.timestamp() * 1e6)
    storage = port_pkg.Storage(_env(tmp_path))
    before = PEventStore.find_ratings("arch", storage=storage,
                                      until_time=until, **KW)
    storage.close()
    storage = port_pkg.Storage(_env(tmp_path))
    before_restored = event_log._M_RESTORED.value()
    event_log.archive_generation(path, 1, storage=storage)
    # a read that does not need generation 1 still skips it
    may = int(T0.replace(month=5).timestamp() * 1e6)
    assert event_log.load_chain(path, may, None)["skipped"] == 2
    # serving reads re-parse the archived bytes
    assert event_log.load_chain(path, on_archived="parse")["pieces"][0][0] \
        == "gap"
    with pytest.raises(event_log.ArchivedGenerationError) as e:
        event_log.load_chain(path, None, until_us)
    assert e.value.generations == [1]
    assert "PIO_EVENT_RESTORE_ON_DEMAND" in str(e.value)
    assert "does not restore" not in str(e.value)
    # the windowed train read raises too: it never trains on fewer rows
    with pytest.raises(event_log.ArchivedGenerationError):
        PEventStore.find_ratings("arch", storage=port_pkg.Storage(
            _env(tmp_path)), until_time=until, **KW)
    # the reference reads the port's archived manifest the same way
    with pytest.raises(ref_log.ArchivedGenerationError):
        ref_log.load_chain(path, None, until_us)
    ref_copy = tmp_path / "refcopy"
    shutil.copytree(tmp_path, ref_copy,
                    ignore=shutil.ignore_patterns("refcopy"))
    monkeypatch.setenv("PIO_EVENT_RESTORE_ON_DEMAND", "1")
    chain = event_log.load_chain(path, None, until_us, storage=storage)
    assert [p[0] for p in chain["pieces"]] == ["cols", "cols", "skip"]
    assert event_log._M_RESTORED.value() == before_restored + 1
    assert [t for _, t in _tiers(tmp_path)] == ["hot"] * 3
    storage.close()
    # restored on demand in the train read of the reference's copy too
    ref = ref_storage.Storage(_env(ref_copy))
    want = RefPEventStore.find_ratings("arch", storage=ref,
                                       until_time=until, **KW)
    ref.close()
    fresh = port_pkg.Storage(_env(tmp_path))
    got = PEventStore.find_ratings("arch", storage=fresh, until_time=until,
                                   **KW)
    fresh.close()
    _same(got, want)
    _same(got, before)
    assert len(got[0]) == 100 and app_id == 1


def test_archive_refusals(tmp_path, monkeypatch):
    _build(tmp_path)
    path = _log_path(tmp_path)
    with pytest.raises(RuntimeError, match="PIO_EVENT_ARCHIVE_SOURCE"):
        event_log.archive_generation(path, 1,
                                     storage=port_pkg.Storage(_env(tmp_path)))
    monkeypatch.setenv("PIO_EVENT_ARCHIVE_SOURCE", "COLD")
    with pytest.raises(ValueError, match="no generation 9"):
        event_log.archive_generation(path, 9,
                                     storage=port_pkg.Storage(_env(tmp_path)))
    snap = os.path.join(os.path.dirname(path),
                        _manifest(tmp_path)["generations"][1]["file"])
    with open(snap, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff")
    with pytest.raises(RuntimeError, match="fails CRC"):
        event_log.archive_generation(path, 2,
                                     storage=port_pkg.Storage(_env(tmp_path)))
    assert [t for _, t in _tiers(tmp_path)] == ["hot"] * 3


def test_eventlog_archive_restore_verbs(tmp_path):
    _build(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_EVENT"))}
    env.update(_env(tmp_path), PIO_FS_BASEDIR=str(tmp_path / "base"),
               PIO_EVENT_ARCHIVE_SOURCE="COLD",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    con = [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
           "eventlog"]

    def run(*args):
        return subprocess.run(con + list(args), env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=120)

    out = run("archive", "--log", "events_1.jsonl", "--generation", "2")
    assert out.returncode == 0, out.stderr
    assert ("events_1.jsonl generation 2: tier archived (source COLD, "
            "blob events_1.jsonl.g2)") in out.stdout
    assert _tiers(tmp_path)[1] == (2, "archived")
    status = run("status")
    assert status.returncode == 0 and "archived" in status.stdout
    out = run("restore", "--log", "events_1.jsonl", "--generation", "2")
    assert out.returncode == 0, out.stderr
    assert "generation 2: tier hot" in out.stdout
    out = run("restore", "--log", "events_1.jsonl", "--generation", "7")
    assert out.returncode == 1 and "restore failed" in out.stderr
