"""The port's event codec (``incubator_predictionio_torch/native``) on the
CPU, held against its plain parser and the JAX package's bindings.

The codec is built here with g++ from ``native/src/event_codec.cc`` (the
source both packages share) into the port's build directory. The port's
codec, the port's plain parser (``parse_events_jsonl_py``) and the
reference's ``parse_events_jsonl`` give equal columns and tables on the
reference's oracle cases and on a seeded fuzz, and raise the same parse
errors. A build pointed at a missing compiler, a source that does not
compile and a library exporting the wrong ABI version each raise
``NativeUnavailable``: nothing falls back to the Python parser. The batch
ingest path gives the reference's lines for the same event ids.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu import native as ref_native  # noqa: E402
from incubator_predictionio_torch import native  # noqa: E402
from incubator_predictionio_torch.data.storage import (  # noqa: E402
    AccessKey, App, Storage,
)

EVENTS = [
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 4.5, "note": 'café "q" \\ slash'},
     "eventTime": "2014-09-09T16:17:42.937-08:00", "eventId": "e1"},
    {"event": "$set", "entityType": "user", "entityId": "u2",
     "properties": {"age": 3, "tags": ["a", "b"], "nested": {"x": 1}},
     "eventTime": "2024-01-01T00:00:00Z", "eventId": "e2"},
    {"event": "view", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i2",
     "eventTime": "2024-02-29T12:00:00.5+05:30", "eventId": "e3"},
    {"__tombstone__": "e1"},
    {"event": "buy", "entityType": "user", "entityId": "emoji \U0001f600",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 2}, "eventTime": "1999-12-31T23:59:59.999999Z",
     "eventId": "e4"},
]
BUF = ("\n".join(json.dumps(e) for e in EVENTS) + "\n").encode()

FIELDS = ("event", "etype", "eid", "tetype", "teid", "event_id", "time_us",
          "props", "span", "tombstone_pos")


def assert_same_columns(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.rating.dtype == b.rating.dtype == np.float32
    assert np.array_equal(a.rating, b.rating, equal_nan=True)
    assert a.tables == b.tables
    assert a.tombstones == b.tombstones
    assert a.raw == b.raw


def _fuzz_buffer(seed: int, n: int = 400) -> bytes:
    rng = np.random.default_rng(seed)
    ratings = [1, 2.5, -3, 1e10, 0.1, "3.5", " 2 ", "n/a", "1_0", "1",
               "0x10", "inf", "1e999", 1e999, True, False, None, ["4"],
               {"v": 4}]
    rows = []
    for k in range(n):
        e = {
            "event": ["rate", "buy", "$set", "über-event"][rng.integers(4)],
            "entityType": "user",
            "entityId": f"u{rng.integers(50)}",
            "eventTime": "20%02d-%02d-%02dT%02d:%02d:%02d.%03dZ" % (
                rng.integers(100), rng.integers(1, 13), rng.integers(1, 28),
                rng.integers(24), rng.integers(60), rng.integers(60),
                rng.integers(1000)),
            "eventId": f"id{k}",
        }
        if rng.random() < 0.7:
            e["targetEntityType"] = "item"
            e["targetEntityId"] = f"i{rng.integers(30)}"
        if rng.random() < 0.6:
            e["properties"] = {
                "rating": ratings[rng.integers(len(ratings))],
                "s": ["plain", 'esc"\\', "unié€"][rng.integers(3)]}
        if rng.random() < 0.05:
            e = {"__tombstone__": f"id{rng.integers(max(k, 1))}"}
        rows.append(json.dumps(e, ensure_ascii=bool(rng.random() < 0.5)))
    return ("\n".join(rows) + "\n").encode()


def test_plain_parser_semantics():
    c = native.parse_events_jsonl_py(BUF)
    assert len(c) == 4
    assert c.tombstones == ["e1"] and c.tombstone_pos.tolist() == [3]
    assert c.properties_dict(0)["note"] == 'café "q" \\ slash'
    assert c.record_dict(3)["entityId"] == "emoji \U0001f600"
    assert np.isnan(c.rating[1]) and c.rating[3] == 2.0
    assert c.properties_dict(2) == {}  # no properties key


@pytest.mark.parametrize("buf", [BUF, b"", _fuzz_buffer(42), _fuzz_buffer(7)],
                         ids=["oracle", "empty", "fuzz42", "fuzz7"])
def test_codec_equals_plain_parser_and_reference(buf):
    got = native.parse_events_jsonl(buf)
    assert_same_columns(got, native.parse_events_jsonl_py(buf))
    assert_same_columns(got, ref_native.parse_events_jsonl(buf))
    assert native.parse_events(buf).tables == got.tables


@pytest.mark.parametrize("bad", [
    b'{"event": "x", \n', b'[1, 2]\n', b'{"event": "x"} trailing\n',
    b'{"event": "\\q"}\n', b'{"event": tru}\n',
], ids=["truncated", "array", "trailing", "bad-escape", "bad-literal"])
def test_parse_errors_equal_the_reference(bad):
    with pytest.raises(native.EventParseError) as got:
        native.parse_events_jsonl(bad)
    with pytest.raises(ref_native.EventParseError) as want:
        ref_native.parse_events_jsonl(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(native.EventParseError):
        native.parse_events_jsonl_py(bad)


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)


def test_missing_compiler_raises_with_no_fallback(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(native.NativeUnavailable, match="no-such-g"):
        native.parse_events(BUF)
    with pytest.raises(native.NativeUnavailable):
        native.ingest_batch(b"[]", 50, "2026-01-01T00:00:00.000Z")
    assert native._lib is None


def test_compile_error_raises_with_the_compiler_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    bad = tmp_path / "event_codec.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "source_path", lambda: bad)
    with pytest.raises(native.NativeUnavailable, match="error"):
        native.parse_events(BUF)


def test_wrong_abi_version_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    src = native.source_path().read_text()
    stale = tmp_path / "event_codec.cc"
    stale.write_text(src.replace("int32_t pio_codec_version() { return 18; }",
                                 "int32_t pio_codec_version() { return 17; }"))
    monkeypatch.setattr(native, "source_path", lambda: stale)
    with pytest.raises(native.NativeUnavailable, match="ABI version 17"):
        native.parse_events(BUF)


def test_library_lands_in_the_build_dir_keyed_by_source(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    native.parse_events(BUF)
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == [native.library_path().name]
    assert built[0].startswith(f"libpioevent.v{native._EXPECTED_VERSION}-")
    assert "v18 loaded from" in native.status()


BATCH = [
    {"event": "view", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": 42,
     "properties": {"rating": 4.5, "nested": {"a": [1, "ü\"x"]}},
     "eventTime": "2024-03-05T06:07:08.123456+05:30",
     "tags": ["a", "b\"q"], "prId": "p1"},
    {"event": "$set", "entityType": "item", "entityId": "i1",
     "properties": {"categories": ["x"]}},
    {"event": "buy", "entityType": "user", "entityId": 7},
]


@pytest.mark.parametrize("body", [
    BATCH, BATCH[:1], [],
    BATCH + [{"event": "", "entityType": "u", "entityId": "x"}],
    [dict(BATCH[0], eventId="client")],
    [BATCH[2]] * 51,
    "{not json",
], ids=["valid", "one", "empty", "mixed-validity", "client-id", "over-cap",
        "syntax"])
def test_ingest_batch_equals_the_reference(body, monkeypatch):
    raw = (body if isinstance(body, str) else json.dumps(body)).encode()
    ids = bytes(range(256)) * 4
    monkeypatch.setattr("os.urandom", lambda n: ids[:n])
    assert ref_native.available()  # the reference's path needs it resident
    created = "2026-01-02T03:04:05.678Z"
    got = native.ingest_batch(raw, 50, created)
    assert got == ref_native.ingest_batch(raw, 50, created)
    if body is BATCH:
        event_ids, lines = got
        assert len(event_ids) == 3
        assert [json.loads(x)["eventId"] for x in lines.splitlines()] == event_ids


def test_event_server_on_a_log_needs_the_codec(monkeypatch, tmp_path):
    from incubator_predictionio_torch.data.api.event_server import EventServer

    s = Storage({"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
                 "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
                 "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
                 "PIO_STORAGE_SOURCES_M_TYPE": "MEMORY",
                 "PIO_STORAGE_SOURCES_EV_TYPE": "JSONL",
                 "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / "events")})
    s.get_meta_data_apps().insert(App(0, "napp"))
    s.get_meta_data_access_keys().insert(AccessKey("nk", 1, ()))
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(native.NativeUnavailable):
        EventServer(s, "127.0.0.1", 0)
    s.close()
