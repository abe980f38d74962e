"""The event-log codec: ctypes bindings over ``native/src/event_codec.cc``.

The port's own copy of the event-log and tokenizer parts of
``incubator_predictionio_tpu/native/__init__.py`` (:271-392, :453-523,
:525-737). The C++ library is the scan path of the JSONL event store:
:func:`parse_events_jsonl` decodes a JSONL buffer into
:class:`ColumnarEvents` (interned id codes, timestamps and ratings as numpy
arrays) without a Python object per event, and :func:`ingest_batch`
validates and canonicalizes a ``/batch/events.json`` body in one pass. It
is also the Text-Classification template's tokenizer: :func:`tfidf_tf` and
:func:`tfidf_tf_coo` hash a batch of documents into term counts in one
pass, bit for bit as ``ops/tfidf.py``'s Python loop; and the CCO layout of
the Universal Recommender and Complementary Purchase templates
(``ops/llr.py``): :func:`pair_dedupe` and :func:`cco_partition` (:740-828
of the reference module).

Build: the library is compiled from the checkout's own source
(``native/src/event_codec.cc``, which both packages share) with
``g++ -O3 -std=c++17 -fPIC -Wall -shared`` at first use, into the port's
build directory (``build/torch_kernels/``, or ``PIO_TORCH_BUILD_DIR``).
The file name carries the ABI version and a hash of the source and flags;
concurrent builds write a per-process temporary file and rename it into
place. The exported ABI version is checked at load.

There is no fallback: a failed build or load raises
:class:`NativeUnavailable` with the compiler's output, and nothing carries
on with the Python parser. :func:`parse_events_jsonl_py` is the plain
version of the parser, kept to hold the codec against (tests and
``chip_smoke.py``); no read path calls it. The reference's
``PIO_DISABLE_NATIVE`` switch is not carried over.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import build_dir

_EXPECTED_VERSION = 18

#: the compiler and flags of ``native/Makefile``
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """The codec library could not be built or loaded."""


class EventParseError(ValueError):
    pass


def source_path() -> Path:
    return Path(__file__).resolve().parents[2] / "native" / "src" / "event_codec.cc"


def library_path() -> Path:
    """Where the build of the codec source (as it is now) lives. The ABI
    version is in the name because dlopen dedups by path: a rebuild under
    the same path inside a live process would resolve to the stale
    mapping."""
    text = source_path().read_bytes()
    digest = hashlib.sha256(
        text + " ".join((CXX,) + CXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"libpioevent.v{_EXPECTED_VERSION}-{digest}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pio_codec_version.restype = ctypes.c_int32
    lib.pio_parse_events_jsonl.restype = ctypes.c_void_p
    lib.pio_parse_events_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.pio_col_count.restype = ctypes.c_int64
    lib.pio_col_count.argtypes = [ctypes.c_void_p]
    for name in ("pio_col_event", "pio_col_etype", "pio_col_eid",
                 "pio_col_tetype", "pio_col_teid", "pio_col_event_id"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.c_void_p]
    for name in ("pio_col_time_us", "pio_col_props", "pio_col_span"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int64)
        fn.argtypes = [ctypes.c_void_p]
    lib.pio_col_rating.restype = ctypes.POINTER(ctypes.c_float)
    lib.pio_col_rating.argtypes = [ctypes.c_void_p]
    lib.pio_table_size.restype = ctypes.c_int32
    lib.pio_table_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pio_table_blob.restype = ctypes.POINTER(ctypes.c_char)
    lib.pio_table_blob.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pio_table_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.pio_table_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pio_tombstone_count.restype = ctypes.c_int64
    lib.pio_tombstone_count.argtypes = [ctypes.c_void_p]
    lib.pio_tombstone_pos.restype = ctypes.POINTER(ctypes.c_int64)
    lib.pio_tombstone_pos.argtypes = [ctypes.c_void_p]
    lib.pio_tombstone_get.restype = ctypes.POINTER(ctypes.c_char)
    lib.pio_tombstone_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pio_free.restype = None
    lib.pio_free.argtypes = [ctypes.c_void_p]
    lib.pio_ingest_batch.restype = ctypes.c_void_p
    lib.pio_ingest_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.pio_ingest_count.restype = ctypes.c_int64
    lib.pio_ingest_count.argtypes = [ctypes.c_void_p]
    lib.pio_ingest_all_ok.restype = ctypes.c_int32
    lib.pio_ingest_all_ok.argtypes = [ctypes.c_void_p]
    lib.pio_ingest_lines.restype = ctypes.POINTER(ctypes.c_char)
    lib.pio_ingest_lines.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.pio_ingest_free.restype = None
    lib.pio_ingest_free.argtypes = [ctypes.c_void_p]
    lib.pio_tfidf_tf.restype = ctypes.c_int32
    lib.pio_tfidf_tf.argtypes = [
        ctypes.c_char_p,                  # concatenated utf-8 docs
        ctypes.POINTER(ctypes.c_int64),   # offsets [n_docs + 1]
        ctypes.c_int64,                   # n_docs
        ctypes.c_int32,                   # n_features
        ctypes.c_int32,                   # ngram
        ctypes.POINTER(ctypes.c_float),   # out [n_docs, n_features]
        ctypes.POINTER(ctypes.c_int64),   # df [n_features] or NULL
    ]
    lib.pio_cco_partition.restype = ctypes.c_void_p
    lib.pio_cco_partition.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64,
    ]
    lib.pio_ccop_dim.restype = ctypes.c_int64
    lib.pio_ccop_dim.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pio_ccop_slab.restype = ctypes.POINTER(ctypes.c_uint16)
    lib.pio_ccop_slab.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pio_ccop_item_counts.restype = ctypes.POINTER(ctypes.c_int64)
    lib.pio_ccop_item_counts.argtypes = [ctypes.c_void_p]
    lib.pio_ccop_free.restype = None
    lib.pio_ccop_free.argtypes = [ctypes.c_void_p]
    lib.pio_pair_dedupe.restype = ctypes.c_void_p
    lib.pio_pair_dedupe.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.pio_pdd_count.restype = ctypes.c_int64
    lib.pio_pdd_count.argtypes = [ctypes.c_void_p]
    for name in ("pio_pdd_users", "pio_pdd_items"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.c_void_p]
    lib.pio_pdd_per_user.restype = ctypes.POINTER(ctypes.c_int64)
    lib.pio_pdd_per_user.argtypes = [ctypes.c_void_p]
    lib.pio_pdd_free.restype = None
    lib.pio_pdd_free.argtypes = [ctypes.c_void_p]
    lib.pio_tfidf_tf_coo.restype = ctypes.c_int64
    lib.pio_tfidf_tf_coo.argtypes = [
        ctypes.c_char_p,                  # concatenated utf-8 docs
        ctypes.POINTER(ctypes.c_int64),   # offsets [n_docs + 1]
        ctypes.c_int64,                   # n_docs
        ctypes.c_int32,                   # n_features
        ctypes.c_int32,                   # ngram
        ctypes.c_int64,                   # cap
        ctypes.POINTER(ctypes.c_int64),   # doc_ptr [n_docs + 1]
        ctypes.POINTER(ctypes.c_int32),   # feat_out [cap]
        ctypes.POINTER(ctypes.c_float),   # cnt_out [cap]
        ctypes.POINTER(ctypes.c_int64),   # df [n_features] or NULL
    ]
    return lib


#: seconds the last build took in this process (0.0 when it was cached)
build_seconds: Optional[float] = None


def _build(out: Path) -> None:
    global build_seconds
    import time

    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(source_path())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(
            f"could not run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise NativeUnavailable(
            f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded codec, built first when the build directory lacks it.
    Raises NativeUnavailable on any build or load failure."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if path.is_file():
            build_seconds = 0.0
        else:
            _build(path)
        try:
            lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError) as e:
            raise NativeUnavailable(f"could not load {path}: {e}") from e
        version = lib.pio_codec_version()
        if version != _EXPECTED_VERSION:
            raise NativeUnavailable(
                f"{path} exports ABI version {version}, the bindings expect "
                f"{_EXPECTED_VERSION}: the source and the bindings disagree")
        _lib = lib
        return _lib


def status() -> str:
    """One line for ``pio status``: the codec's build, loading it (and
    building it first when needed)."""
    lib = load()
    how = ("built in {:.1f}s".format(build_seconds) if build_seconds
           else "cached")
    return (f"v{lib.pio_codec_version()} loaded from {library_path()} "
            f"({how}: {CXX} {' '.join(CXX_FLAGS)} native/src/"
            f"{source_path().name})")


@dataclass
class ColumnarEvents:
    """Interned columnar view of an event log scan.

    Code -1 in ``tetype``/``teid``/``event_id`` = field absent;
    ``time_us`` INT64_MIN = absent; ``rating`` NaN = key absent, -inf =
    key present but not coercible to a finite number (the two fill
    differently in find_ratings). ``props`` and ``span`` are [start, end)
    byte offsets into ``raw`` (-1 = absent) for lazy per-event reparse of
    the full JSON. ``tombstone_pos[i]`` = how many event records precede
    tombstone i (deletes are positional: later re-inserts are live).

    String tables are materialized lazily per table via ``table(which)`` —
    the eventId table of a big scan is as large as the scan itself, and the
    training read never touches it.
    """

    raw: bytes
    event: np.ndarray
    etype: np.ndarray
    eid: np.ndarray
    tetype: np.ndarray
    teid: np.ndarray
    event_id: np.ndarray
    time_us: np.ndarray
    rating: np.ndarray
    props: np.ndarray  # (n, 2) int64
    span: np.ndarray  # (n, 2) int64
    # per table: (concatenated utf-8 blob, size+1 end-offsets) or the
    # already-built list
    _tables: list
    tombstones: list[str]
    tombstone_pos: np.ndarray  # int64, record count before each tombstone

    def __len__(self) -> int:
        return int(self.event.shape[0])

    TABLE_EVENT, TABLE_ETYPE, TABLE_EID = 0, 1, 2
    TABLE_TETYPE, TABLE_TEID, TABLE_EVENT_ID = 3, 4, 5

    def table(self, which: int) -> list[str]:
        t = self._tables[which]
        if isinstance(t, list):
            return t
        blob, offs = t
        size = len(offs) - 1
        text = blob.decode("utf-8")
        if len(text) == len(blob):  # pure ASCII: str slicing == byte slicing
            out = [text[offs[k]:offs[k + 1]] for k in range(size)]
        else:
            out = [blob[offs[k]:offs[k + 1]].decode("utf-8") for k in range(size)]
        self._tables[which] = out
        return out

    @property
    def tables(self) -> list[list[str]]:
        return [self.table(w) for w in range(6)]

    def properties_dict(self, i: int) -> dict:
        s, e = self.props[i]
        if s < 0:
            return {}
        return json.loads(self.raw[s:e])

    def record_dict(self, i: int) -> dict:
        s, e = self.span[i]
        return json.loads(self.raw[s:e])


def _np_copy(ptr, n, dtype):
    if n == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_events_jsonl(buf: bytes) -> ColumnarEvents:
    """Parse a JSONL buffer of event objects with the codec.

    Raises NativeUnavailable when the codec cannot be built or loaded,
    EventParseError on malformed input. Plain version:
    :func:`parse_events_jsonl_py`.
    """
    lib = load()
    err = ctypes.create_string_buffer(512)
    handle = lib.pio_parse_events_jsonl(buf, len(buf), err, len(err))
    if not handle:
        raise EventParseError(err.value.decode(errors="replace") or "parse failed")
    try:
        n = lib.pio_col_count(handle)
        tables = []
        for which in range(6):
            size = lib.pio_table_size(handle, which)
            if size == 0:
                tables.append([])
                continue
            blob_len = ctypes.c_int64(0)
            blob_ptr = lib.pio_table_blob(handle, which, ctypes.byref(blob_len))
            blob = ctypes.string_at(blob_ptr, blob_len.value)
            offs = _np_copy(lib.pio_table_offsets(handle, which), size + 1, np.int64)
            tables.append((blob, offs))
        tombstones = []
        ln = ctypes.c_int32(0)
        n_tomb = lib.pio_tombstone_count(handle)
        for idx in range(n_tomb):
            ptr = lib.pio_tombstone_get(handle, idx, ctypes.byref(ln))
            tombstones.append(ctypes.string_at(ptr, ln.value).decode("utf-8"))
        tombstone_pos = _np_copy(lib.pio_tombstone_pos(handle), n_tomb, np.int64)
        return ColumnarEvents(
            raw=buf,
            event=_np_copy(lib.pio_col_event(handle), n, np.int32),
            etype=_np_copy(lib.pio_col_etype(handle), n, np.int32),
            eid=_np_copy(lib.pio_col_eid(handle), n, np.int32),
            tetype=_np_copy(lib.pio_col_tetype(handle), n, np.int32),
            teid=_np_copy(lib.pio_col_teid(handle), n, np.int32),
            event_id=_np_copy(lib.pio_col_event_id(handle), n, np.int32),
            time_us=_np_copy(lib.pio_col_time_us(handle), n, np.int64),
            rating=_np_copy(lib.pio_col_rating(handle), n, np.float32),
            props=_np_copy(lib.pio_col_props(handle), 2 * n, np.int64).reshape(n, 2),
            span=_np_copy(lib.pio_col_span(handle), 2 * n, np.int64).reshape(n, 2),
            _tables=tables,
            tombstones=tombstones,
            tombstone_pos=tombstone_pos,
        )
    finally:
        lib.pio_free(handle)


def _scan_object_bytes(rec: bytes, start: int) -> int:
    """End index (exclusive) of the JSON object opening at rec[start] == '{'.
    Structural bytes are ASCII, so scanning raw UTF-8 is safe."""
    depth, j = 0, start
    in_str = esc = False
    while j < len(rec):
        ch = rec[j:j + 1]
        if in_str:
            if esc:
                esc = False
            elif ch == b"\\":
                esc = True
            elif ch == b'"':
                in_str = False
        elif ch == b'"':
            in_str = True
        elif ch == b"{":
            depth += 1
        elif ch == b"}":
            depth -= 1
            if depth == 0:
                return j + 1
        j += 1
    raise EventParseError("unterminated properties object")


def parse_events_jsonl_py(buf: bytes) -> ColumnarEvents:
    """The plain version of :func:`parse_events_jsonl` (the equality
    oracle; no read path calls it).

    Line-delimited only (one JSON object per line) — the format the JSONL
    backend writes. The codec additionally accepts arbitrary inter-object
    whitespace.
    """
    import datetime as _dt

    from ..data.storage.event import parse_event_time

    tables: list[list[str]] = [[] for _ in range(6)]
    interns: list[dict[str, int]] = [{} for _ in range(6)]

    def intern(which: int, s: str) -> int:
        m = interns[which]
        code = m.get(s)
        if code is None:
            code = len(m)
            m[s] = code
            tables[which].append(s)
        return code

    cols = {k: [] for k in ("event", "etype", "eid", "tetype", "teid",
                            "event_id", "time_us", "rating")}
    props, span, tombstones, tombstone_pos = [], [], [], []
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

    offset = 0
    for raw_line in buf.split(b"\n"):
        line = raw_line.strip()
        if not line:
            offset += len(raw_line) + 1
            continue
        lead = len(raw_line) - len(raw_line.lstrip())
        start = offset + lead
        stop = start + len(line)
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise EventParseError(f"{e} at byte {start}") from e
        offset += len(raw_line) + 1
        if not isinstance(obj, dict):
            raise EventParseError(f"expected event object at byte {start}")
        if "__tombstone__" in obj:
            tombstones.append(obj["__tombstone__"])
            tombstone_pos.append(len(cols["event"]))
            continue
        cols["event"].append(intern(0, obj["event"]) if "event" in obj else -1)
        cols["etype"].append(intern(1, obj["entityType"]) if "entityType" in obj else -1)
        cols["eid"].append(intern(2, obj["entityId"]) if "entityId" in obj else -1)
        tet, tei = obj.get("targetEntityType"), obj.get("targetEntityId")
        cols["tetype"].append(intern(3, tet) if tet is not None else -1)
        cols["teid"].append(intern(4, tei) if tei is not None else -1)
        eid = obj.get("eventId")
        cols["event_id"].append(intern(5, eid) if eid is not None else -1)
        t = obj.get("eventTime")
        if t is None:
            cols["time_us"].append(np.iinfo(np.int64).min)
        else:
            try:
                dt = parse_event_time(t)
                cols["time_us"].append(
                    int(round((dt - epoch).total_seconds() * 1e6))
                )
            except Exception:
                cols["time_us"].append(np.iinfo(np.int64).min)
        p = obj.get("properties")
        has_rating = isinstance(p, dict) and "rating" in p
        r = p.get("rating") if has_rating else None
        if isinstance(r, (int, float)) and not isinstance(r, bool):
            try:
                f = np.float32(r)  # float32-range finiteness (codec parity)
            except OverflowError:
                f = np.float32(np.inf)
            cols["rating"].append(float(f) if np.isfinite(f) else -np.inf)
        elif isinstance(r, str) and not set(r) - set("0123456789.+-eE \t\r\n"):
            # string-typed numeric rating; charset limited to what both
            # float() and strtod parse identically (no hex/inf/nan/_)
            try:
                f = np.float32(float(r))
                cols["rating"].append(float(f) if np.isfinite(f) else -np.inf)
            except (ValueError, OverflowError):
                cols["rating"].append(-np.inf)
        elif has_rating:
            # bool / null / list / dict / "1_0": present but unusable
            cols["rating"].append(-np.inf)
        else:
            cols["rating"].append(np.nan)
        if isinstance(p, dict):
            # locate the top-level "properties" key: preceding non-ws byte
            # must be '{' or ',' (an occurrence inside a string value is
            # always preceded by a backslash-escaped quote instead)
            rel = -1
            search = 0
            while True:
                cand = line.find(b'"properties"', search)
                if cand < 0:
                    break
                k = cand - 1
                while k >= 0 and line[k:k + 1] in b" \t":
                    k -= 1
                if k >= 0 and line[k:k + 1] in b"{,":
                    rel = cand
                    break
                search = cand + 1
            brace = line.index(b"{", rel) if rel >= 0 else -1
            if brace >= 0:
                pend = _scan_object_bytes(line, brace)
                props.append((start + brace, start + pend))
            else:
                props.append((-1, -1))
        else:
            props.append((-1, -1))
        span.append((start, stop))

    count = len(cols["event"])
    return ColumnarEvents(
        raw=buf,
        event=np.asarray(cols["event"], np.int32),
        etype=np.asarray(cols["etype"], np.int32),
        eid=np.asarray(cols["eid"], np.int32),
        tetype=np.asarray(cols["tetype"], np.int32),
        teid=np.asarray(cols["teid"], np.int32),
        event_id=np.asarray(cols["event_id"], np.int32),
        time_us=np.asarray(cols["time_us"], np.int64),
        rating=np.asarray(cols["rating"], np.float32),
        props=np.asarray(props, np.int64).reshape(count, 2),
        span=np.asarray(span, np.int64).reshape(count, 2),
        _tables=tables,
        tombstones=tombstones,
        tombstone_pos=np.asarray(tombstone_pos, np.int64),
    )


def parse_events(buf: bytes) -> ColumnarEvents:
    """The read paths' parser: always the codec (it raises when it cannot
    be built or loaded)."""
    return parse_events_jsonl(buf)


def ingest_batch(raw: bytes, max_items: int, creation_iso: str):
    """Validate and canonicalize a /batch/events.json body in one codec
    pass. Returns (event_ids, jsonl_bytes) on the uniform happy case, or
    None when any item needs the Python path (a validation failure, a
    client-supplied eventId, an over-cap count, a syntax error, invalid
    UTF-8): the caller then re-parses in Python, which owns every error
    message. Raises NativeUnavailable when the codec cannot be built or
    loaded."""
    lib = load()
    try:
        # Python json.loads decodes the body as strict UTF-8 before any
        # grammar check; the C scanner is byte-oriented, so invalid UTF-8
        # must bounce to the Python path here or it would be persisted.
        raw.decode("utf-8", "strict")
    except UnicodeDecodeError:
        return None
    ids_hex = os.urandom(16 * max_items).hex().encode()
    err = ctypes.create_string_buffer(256)
    h = lib.pio_ingest_batch(raw, len(raw), ids_hex, max_items,
                             creation_iso.encode(), err, len(err))
    if not h:
        return None
    try:
        if not lib.pio_ingest_all_ok(h):
            return None
        n = lib.pio_ingest_count(h)
        nbytes = ctypes.c_int64()
        ptr = lib.pio_ingest_lines(h, ctypes.byref(nbytes))
        lines = ctypes.string_at(ptr, nbytes.value)
        ids = [ids_hex[32 * j:32 * (j + 1)].decode() for j in range(n)]
        return ids, lines
    finally:
        lib.pio_ingest_free(h)


def _doc_buffer(docs) -> tuple:
    """The documents as one UTF-8 buffer and its [N + 1] offsets.
    ``errors="replace"``: a lone surrogate (legal in a Python str) becomes
    '?', which is no token byte, as the surrogate is none under the Python
    tokenizer's ASCII class, so token boundaries are kept."""
    enc = [d.encode(errors="replace") for d in docs]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    return b"".join(enc), offs


def _ptr(a: Optional[np.ndarray], ct):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ct))


def tfidf_tf_coo(docs, n_features: int, ngram: int,
                 want_df: bool = False):
    """Per-document (feature, count) pairs in one codec pass:
    ``(doc_ptr [N+1] int64, feat [nnz] int32, counts [nnz] float32)``
    (+ ``df`` [D] int64 when asked), each document's entries in ascending
    bucket id. The dense [N, D] matrix never exists. Raises
    :class:`NativeUnavailable` when the codec cannot be built or loaded."""
    lib = load()
    buf, offs = _doc_buffer(docs)
    n = len(offs) - 1
    # nnz is bounded by the token occurrences: a token is at least one
    # byte, and each extra n-gram order adds at most one per position
    cap = (len(buf) // 2 + n + 1) * ngram + 1
    doc_ptr = np.zeros(n + 1, np.int64)
    feat = np.empty(cap, np.int32)
    cnt = np.empty(cap, np.float32)
    df = np.zeros(n_features, np.int64) if want_df else None
    nnz = lib.pio_tfidf_tf_coo(
        buf, _ptr(offs, ctypes.c_int64), n, n_features, ngram, cap,
        _ptr(doc_ptr, ctypes.c_int64), _ptr(feat, ctypes.c_int32),
        _ptr(cnt, ctypes.c_float), _ptr(df, ctypes.c_int64))
    if nnz < 0:
        raise ValueError(f"tfidf_tf_coo: native tokenizer error {nnz}")
    out = (doc_ptr, feat[:nnz].copy(), cnt[:nnz].copy())
    return out + (df,) if want_df else out


def tfidf_tf(docs, n_features: int, ngram: int, want_df: bool = False):
    """Dense term-frequency rows [N, D] float32 in one codec pass (with
    ``want_df``: ``(tf, df)``, the per-bucket document frequency counted
    in the same pass). Raises :class:`NativeUnavailable` when the codec
    cannot be built or loaded."""
    lib = load()
    buf, offs = _doc_buffer(docs)
    n = len(offs) - 1
    out = np.zeros((n, n_features), np.float32)
    df = np.zeros(n_features, np.int64) if want_df else None
    rc = lib.pio_tfidf_tf(buf, _ptr(offs, ctypes.c_int64), n, n_features,
                          ngram, _ptr(out, ctypes.c_float),
                          _ptr(df, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"tfidf_tf: native tokenizer error {rc}")
    return (out, df) if want_df else out


def cco_partition(u: np.ndarray, i: np.ndarray, rank, n_users: int,
                  u_chunk: int, n_ranges: int, n_items: int,
                  h_chunk: int, h_ranges: int):
    """One-pass partition of deduped, user-sorted (u, i) pairs into the CCO
    slab layout of ``ops/llr.py``: ((light_eu, light_ei), (heavy_eu,
    heavy_ei) or None, item_counts), the light layout [n_ranges, E] and the
    heavy one [h_ranges, E'] as uint16. ``rank``: each user's heavy rank
    (-1 for light users), or None. The layout is uint16 only: the caller
    passes u_chunk, h_chunk < 0xFFFF and n_items <= 0xFFFF (ValueError
    otherwise; the wider layout is ``llr._partition_by_user``'s int32 one).
    Raises :class:`NativeUnavailable` when the codec cannot be built or
    loaded."""
    if u_chunk >= 0xFFFF or n_items > 0xFFFF or h_chunk >= 0xFFFF:
        raise ValueError("cco_partition: ids exceed the uint16 layout")
    lib = load()
    u = np.ascontiguousarray(u, np.int32)
    i = np.ascontiguousarray(i, np.int32)
    if u.shape != i.shape or u.ndim != 1:
        raise ValueError(f"cco_partition: users {u.shape}, items {i.shape}")
    rank_ptr = None
    if rank is not None:
        rank = np.ascontiguousarray(rank, np.int32)
        if rank.shape != (n_users,):
            raise ValueError(f"cco_partition: rank {rank.shape} for "
                             f"{n_users} users")
        rank_ptr = _ptr(rank, ctypes.c_int32)
    h = lib.pio_cco_partition(
        _ptr(u, ctypes.c_int32), _ptr(i, ctypes.c_int32), u.size, rank_ptr,
        n_users, u_chunk, n_ranges, n_items, h_chunk,
        h_ranges if rank is not None else 0)
    if not h:
        raise NativeUnavailable("cco_partition failed")
    try:
        le = lib.pio_ccop_dim(h, 0)
        light = tuple(
            np.ctypeslib.as_array(lib.pio_ccop_slab(h, w),
                                  shape=(n_ranges, le)).copy()
            for w in (0, 1))
        heavy = None
        if rank is not None:
            he = lib.pio_ccop_dim(h, 1)
            heavy = tuple(
                np.ctypeslib.as_array(lib.pio_ccop_slab(h, w),
                                      shape=(h_ranges, he)).copy()
                for w in (2, 3))
        counts = np.ctypeslib.as_array(
            lib.pio_ccop_item_counts(h), shape=(n_items,)).copy()
        return light, heavy, counts
    finally:
        lib.pio_ccop_free(h)


def pair_dedupe(u: np.ndarray, i: np.ndarray, n_users: int, n_items: int):
    """Distinct (user, item) pairs sorted by (user, item), and the distinct
    count per user: a counting sort by user and small per-user sorts (two
    linear passes), in the order of a packed-key ``np.unique``. Ids outside
    [0, n_users) × [0, n_items) are dropped. Raises
    :class:`NativeUnavailable` when the codec cannot be built or loaded."""
    lib = load()
    u = np.asarray(u)
    i = np.asarray(i)
    if u.shape != i.shape or u.ndim != 1:
        raise ValueError(f"pair_dedupe: users {u.shape}, items {i.shape}")
    if u.dtype != np.int32 or i.dtype != np.int32:
        # range-check in the wide dtype: a cast to int32 would wrap an
        # out-of-range id into the valid range
        u64 = u.astype(np.int64)
        i64 = i.astype(np.int64)
        valid = ((u64 >= 0) & (u64 < n_users)
                 & (i64 >= 0) & (i64 < n_items))
        u = u64[valid].astype(np.int32)
        i = i64[valid].astype(np.int32)
    u = np.ascontiguousarray(u, np.int32)
    i = np.ascontiguousarray(i, np.int32)
    h = lib.pio_pair_dedupe(_ptr(u, ctypes.c_int32), _ptr(i, ctypes.c_int32),
                            u.size, n_users, n_items)
    if not h:
        raise NativeUnavailable("pair_dedupe failed")
    try:
        n = lib.pio_pdd_count(h)
        if n:  # empty vectors hand back NULL data pointers
            du = np.ctypeslib.as_array(lib.pio_pdd_users(h), shape=(n,)).copy()
            di = np.ctypeslib.as_array(lib.pio_pdd_items(h), shape=(n,)).copy()
        else:
            du = np.zeros(0, np.int32)
            di = np.zeros(0, np.int32)
        per_user = (np.ctypeslib.as_array(
            lib.pio_pdd_per_user(h), shape=(n_users,)).copy()
            if n_users else np.zeros(0, np.int64))
        return du, di, per_user
    finally:
        lib.pio_pdd_free(h)
