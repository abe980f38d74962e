"""The port's write-ahead log (``incubator_predictionio_torch/data/api/
ingest_wal.py``) held against the JAX package's on the same bytes: frames
byte-identical for the same (kind, lsn, payload); segments written by
either package replay in the other into a JSONL store with equal
multisets of canonical lines; a tail torn at every byte offset of the last
frame decodes alike in both (with and without resync); ``inspect`` rows
are equal; and the ENOSPC fault (``oserr:1:28``) sheds with 503 +
Retry-After, counts ``pio_ingest_append_errors_total{kind="enospc"}``,
keeps the log tail intact and recovers after the window, as the
reference's own test says — on the event log's append and on the WAL's.
"""

import collections
import errno
import json
import os
import shutil
import struct
import time

import pytest
import requests

pytest.importorskip("torch")

from incubator_predictionio_tpu.common import faultinject as ref_faults  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.data.api import ingest_wal as ref_wal  # noqa: E402
from incubator_predictionio_tpu.data.api.event_server import (  # noqa: E402
    EventServer as RefEventServer,
)
from incubator_predictionio_torch.common import faultinject  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api import ingest_wal  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import (  # noqa: E402
    EventServer,
)
from incubator_predictionio_torch.data.api.ingest_buffer import (  # noqa: E402
    _M_APPEND_ERRORS,
)

from server_utils import ServerThread  # noqa: E402

T = "2026-01-01T00:00:00.000Z"
KEY = "walkey"


def _ev(i, **kw):
    d = {"event": "view", "entityType": "user", "entityId": f"u{i}",
         "eventTime": T}
    d.update(kw)
    return d


def _line(i, eid=None):
    return json.dumps(dict(_ev(i), eventId=eid or f"{i:032x}",
                           creationTime=T)).encode() + b"\n"


def _env(tmp_path, name):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
            for r in ("METADATA", "MODELDATA")} | {
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_SOURCES_M_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_M_PATH": str(tmp_path / f"{name}.sqlite"),
        "PIO_STORAGE_SOURCES_EV_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / f"{name}-events")}


def _store(pkg, tmp_path, name):
    storage = pkg.Storage(_env(tmp_path, name))
    app_id = storage.get_meta_data_apps().insert(pkg.App(0, "walapp"))
    storage.get_meta_data_access_keys().insert(pkg.AccessKey(KEY, app_id, ()))
    storage.get_l_events().init(app_id)
    return storage, app_id


def _lines(storage, app_id) -> collections.Counter:
    """The canonical lines the store holds (its JSONL files' bytes)."""
    d = storage.get_l_events()
    d = getattr(d, "events_dir", None) or d._dir
    out = collections.Counter()
    for name in os.listdir(d):
        if name.startswith(f"events_{app_id}") and name.endswith(".jsonl"):
            with open(os.path.join(d, name), "rb") as f:
                out.update(x for x in f.read().splitlines() if x)
    return out


# ---------------------------------------------------------------------------
# frames and segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["E", "C", "X"])
def test_frames_byte_identical(kind):
    k = {"E": ingest_wal.K_EVENTS, "C": ingest_wal.K_COMMIT,
         "X": ingest_wal.K_ABORT}[kind]
    assert (k, ingest_wal._KINDS) == (
        {"E": ref_wal.K_EVENTS, "C": ref_wal.K_COMMIT,
         "X": ref_wal.K_ABORT}[kind], ref_wal._KINDS)
    for lsn in (0, 1, 2 ** 32 + 7, 2 ** 64 - 1):
        for payload in (b"", _line(3), _line(1) + _line(2),
                        struct.pack("<3Q", 1, 5, 9)):
            if kind != "E" and len(payload) % 8:
                continue
            assert ingest_wal._frame(k, lsn, payload) == ref_wal._frame(
                k, lsn, payload)
            assert ingest_wal._frame_crc(k, len(payload), lsn, payload) == \
                ref_wal._frame_crc(k, len(payload), lsn, payload)


def _write_wal(mods, wal_dir, app_id):
    """A WAL of one key as a crashed server leaves it: committed,
    aborted and uncommitted records over two rotated segments, with one
    uncommitted event that already landed in the store (replay dedups
    it)."""
    wal = mods.IngestWal(mods.WalConfig(enabled=True, fsync="group",
                                        dir=str(wal_dir),
                                        segment_bytes=4096))
    key = (app_id, None)
    lsns = []
    for i in range(40):
        lsns.append(wal.append_events(key, _line(i), 1))
    lsns.append(wal.append_events(key, _line(100) + _line(101), 2))
    wal.commit(key, lsns[:10])
    wal.abort(key, lsns[10:15])
    wal.sync(key)
    wal.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_segments_replay_in_both_packages(tmp_path, writer):
    """A WAL written by either package replays in both into a JSONL store:
    the same canonical lines land (as multisets), the same summary, the
    same dedup of an event that landed before the crash, and the
    segments are gone after."""
    mods = ingest_wal if writer == "port" else ref_wal
    stores = {"port": _store(port_pkg, tmp_path, "port"),
              "ref": _store(ref_storage, tmp_path, "ref")}
    app_id = stores["port"][1]
    assert stores["ref"][1] == app_id
    src = tmp_path / "wal-src"
    _write_wal(mods, src, app_id)
    assert sorted(os.listdir(src / str(app_id))) != []
    got = {}
    for name, recover in (("port", ingest_wal.recover),
                          ("ref", ref_wal.recover)):
        storage, _ = stores[name]
        # one event landed before the crash: replay must skip it
        storage.get_l_events().insert_canonical_lines(
            _line(20), app_id, None)
        wal_dir = tmp_path / f"wal-{name}"
        shutil.copytree(src, wal_dir)
        mod = ingest_wal if name == "port" else ref_wal
        summary = recover(storage, mod.WalConfig(
            enabled=True, dir=str(wal_dir)))
        got[name] = (summary, _lines(storage, app_id))
        assert not [n for n in os.listdir(wal_dir) if n != ".lock"]
    assert got["port"] == got["ref"]
    summary, lines = got["port"]
    assert summary["replayed"] == 26 and summary["deduped"] == 1
    assert len(lines) == 27 and all(n == 1 for n in lines.values())
    assert sorted(json.loads(x)["entityId"] for x in lines) == sorted(
        f"u{i}" for i in [*range(15, 40), 100, 101])
    for storage, _ in stores.values():
        storage.close()


def _frames():
    return (ingest_wal._frame(ingest_wal.K_EVENTS, 1, _line(1))
            + ingest_wal._frame(ingest_wal.K_COMMIT, 0, struct.pack("<Q", 1))
            + ingest_wal._frame(ingest_wal.K_EVENTS, 2, _line(2) + _line(3)))


def _decoded(d):
    return (d.events, sorted(d.committed), sorted(d.aborted), d.discarded,
            d.resynced)


@pytest.mark.parametrize("resync", [False, True])
def test_torn_tail_at_every_offset_decodes_alike(resync):
    buf = _frames() + ingest_wal._frame(
        ingest_wal.K_ABORT, 0, struct.pack("<2Q", 2, 3))
    last = len(buf) - len(ingest_wal._frame(
        ingest_wal.K_ABORT, 0, struct.pack("<2Q", 2, 3)))
    for cut in range(last, len(buf) + 1):
        torn = buf[:cut]
        got = _decoded(ingest_wal.decode_buffer(torn, resync=resync))
        assert got == _decoded(ref_wal.decode_buffer(torn, resync=resync)), cut
        if cut < len(buf):
            assert got[3] == cut - last and got[2] == []
    # a flipped byte inside the last frame, and garbage after it
    for off in range(last, len(buf)):
        bad = bytearray(buf)
        bad[off] ^= 0x5A
        bad = bytes(bad) + b"\x00garbage" + _frames()
        assert _decoded(ingest_wal.decode_buffer(bad, resync=resync)) == \
            _decoded(ref_wal.decode_buffer(bad, resync=resync)), off


def test_legacy_payload_crc_segment_decodes_alike():
    legacy = b"".join(
        struct.pack("<BIQI", ingest_wal.K_EVENTS, len(p), lsn,
                    __import__("zlib").crc32(p)) + p
        for lsn, p in ((1, _line(1)), (2, _line(2))))
    assert _decoded(ingest_wal.decode_buffer(legacy)) == \
        _decoded(ref_wal.decode_buffer(legacy))
    assert len(ingest_wal.decode_buffer(legacy).events) == 2


def test_inspect_rows_equal(tmp_path):
    """The same WAL root — a key dir at the root and a partition subdir
    with a torn tail and a corrupt segment — inspects alike."""
    root = tmp_path / "wal"
    _write_wal(ingest_wal, root, 1)
    _write_wal(ref_wal, root / "p1", 1)
    seg = sorted((root / "p1" / "1").glob("*.wal"))[-1]
    with open(seg, "ab") as f:
        f.write(ingest_wal._frame(ingest_wal.K_EVENTS, 99, _line(9))[:-3])
    cfg = ingest_wal.WalConfig(enabled=True, dir=str(root))
    rows = ingest_wal.inspect(cfg)
    assert rows == ref_wal.inspect(ref_wal.WalConfig(enabled=True,
                                                     dir=str(root)))
    assert [r["partition"] for r in rows] == [1, None]
    assert rows[0]["tornTailBytes"] > 0
    assert rows[1]["uncommittedEvents"] == 27
    assert not ingest_wal.dir_is_live(cfg)
    live = ingest_wal.IngestWal(ingest_wal.WalConfig(
        enabled=True, dir=str(root / "p1")))
    try:
        assert ingest_wal.dir_is_live(cfg)
        assert ref_wal.dir_is_live(ref_wal.WalConfig(enabled=True,
                                                     dir=str(root)))
        with pytest.raises(ingest_wal.WalLockedError):
            ingest_wal.recover(None, ingest_wal.WalConfig(
                enabled=True, dir=str(root / "p1")))
    finally:
        live.close()


def test_bootstrap_continues_lsns_after_leftover_segments(tmp_path):
    """Leftover segments (either package's) are frozen and the new
    writer's LSNs start past every LSN a record or a marker used."""
    _write_wal(ref_wal, tmp_path / "wal", 1)
    wal = ingest_wal.IngestWal(ingest_wal.WalConfig(
        enabled=True, dir=str(tmp_path / "wal")))
    try:
        assert wal.append_events((1, None), _line(7), 1) == 42
        assert wal.snapshot()["segments"] >= 2
    finally:
        wal.close()


# ---------------------------------------------------------------------------
# ENOSPC (oserr:1:28), as tests/test_event_log.py's reference test says
# ---------------------------------------------------------------------------

def _enospc_scenario(base, log_path, faults, monkeypatch, point, post):
    """The reference's ENOSPC sequence: a good write, a disk-full append
    (503 + Retry-After), a shed write refused without touching the disk,
    the tail intact, and the partition back after the window."""
    out = []
    r = post(base, 1)
    out.append(r.status_code)
    deadline = time.monotonic() + 30
    while b'"u1"' not in open(log_path, "rb").read():  # an enqueue ack
        assert time.monotonic() < deadline, "the first event never landed"
        time.sleep(0.01)
    tail_before = open(log_path, "rb").read()
    monkeypatch.setenv("PIO_FAULT_SPEC", f"{point}:oserr:1:{errno.ENOSPC}")
    faults.reset()
    r = post(base, 2)
    out.append(r.status_code)
    retry = int(r.headers.get("Retry-After", "0"))
    monkeypatch.delenv("PIO_FAULT_SPEC")
    faults.reset()
    r = post(base, 3)
    out.append(r.status_code)
    intact = open(log_path, "rb").read() == tail_before
    time.sleep(1.6)
    r = post(base, 4)
    out.append(r.status_code)
    return out, retry, intact


def _post(base, i):
    return requests.post(f"{base}/events.json?accessKey={KEY}",
                         json=_ev(i), timeout=30)


def _post_enqueue(base, i):
    return requests.post(f"{base}/events.json?accessKey={KEY}",
                         json=_ev(i), headers={"X-Pio-Ack": "enqueue"},
                         timeout=30)


@pytest.mark.parametrize("point", ["jsonl.append", "wal.append"])
def test_enospc_append_sheds_503_and_recovers(tmp_path, monkeypatch, point):
    monkeypatch.setenv("PIO_INGEST_SHED_MS", "1500")
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    post = _post
    if point == "wal.append":
        # the pre-ack WAL append of an enqueue-acked write
        monkeypatch.setenv("PIO_WAL", "1")
        post = _post_enqueue
    results = {}
    for name in ("port", "ref"):
        pkg = port_pkg if name == "port" else ref_storage
        monkeypatch.setenv("PIO_WAL_DIR", str(tmp_path / f"wal-{name}"))
        storage, app_id = _store(pkg, tmp_path, name)
        le = storage.get_l_events()
        log_path = os.path.join(getattr(le, "events_dir", None) or le._dir,
                                f"events_{app_id}.jsonl")
        if name == "port":
            before = _M_APPEND_ERRORS.labels("enospc").value()
            server = EventServer(storage, "127.0.0.1", 0)
            host, port = server.start()
            try:
                got = _enospc_scenario(f"http://{host}:{port}", log_path,
                                       faultinject, monkeypatch, point, post)
            finally:
                server.stop()
            assert _M_APPEND_ERRORS.labels("enospc").value() == before + 1
        else:
            with ServerThread(RefEventServer(storage).app) as st:
                got = _enospc_scenario(st.base, log_path, ref_faults,
                                       monkeypatch, point, post)
        names = sorted(e.entity_id for e in le.find(app_id))
        results[name] = (got, names)
        storage.close()
    (statuses, retry, intact), names = results["port"]
    assert statuses == [201, 503, 503, 201]
    assert retry >= 1 and intact
    assert names == ["u1", "u4"]
    assert results["port"][0][0] == results["ref"][0][0]
    assert results["port"][1] == results["ref"][1]
