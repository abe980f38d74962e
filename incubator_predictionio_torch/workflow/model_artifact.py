"""Verified model artifacts — the one path between workflow code and the
Models DAO.

The port's own copy of ``incubator_predictionio_tpu/workflow/
model_artifact.py`` (:94-260, :270-399: the envelope, the inspection
helpers ``get_model_row`` and ``model_exists`` of ``pio models``, the
refresh poll's ``newer_completed_instance``, and the fleet and fold-in
records ``fleet_group``, ``fleet_row_id``, ``fleet_fresh_s``,
``foldin_row_id``, ``read_fleet_doc`` and ``write_fleet_doc``). Every model blob written by ``run_train`` is
wrapped in a self-describing envelope (magic, header length, a sorted-key
JSON header carrying sha256, payload size and format version) and every
read re-verifies it, so a truncated, bit-flipped or half-written artifact is
detected at load time. The envelope is byte-identical to the reference's:
``describe`` and ``unwrap_verified`` give the same verdicts on either
package's blobs.

The port's payload is the ``.npz`` bytes of ``workflow/persist.py``, never a
pickle. A legacy blob (a bare pickle, first byte ``0x80``) gets the
reference's verdict ("legacy", accepted by ``unwrap_verified``), and the
port's deserializer then refuses it (``deserialize``), so a pickle is never
loaded.

Failure kinds (counted per kind in :func:`integrity_failure_counts` and
``pio_model_integrity_failures_total{kind}``; a legacy blob passed on counts
into ``pio_model_legacy_loads_total``):
``missing`` (COMPLETED row without a model), ``header`` (envelope damaged),
``version`` (written by a newer format), ``size`` (payload length mismatch —
truncation), ``checksum`` (sha256 mismatch — corruption) and ``deserialize``
(payload verified but not loadable; counted by the caller via
:func:`count_integrity_failure`). A blob that fails verification is never
deleted: callers walk back to an older COMPLETED instance instead.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import struct
import threading
from typing import Optional

from ..common import faultinject, telemetry
from ..data.storage.base import Model

log = logging.getLogger("pio.torch.model_artifact")

#: Envelope magic. Pickled payloads (protocol 2+) always start with
#: b"\x80", so a stored blob is unambiguously an envelope, a legacy
#: pickle, or damaged.
MAGIC = b"PIOM"
FORMAT_VERSION = 1
_LEN = struct.Struct(">I")

_counts_lock = threading.Lock()
_INTEGRITY_FAILURES: collections.Counter = collections.Counter()
_M_INTEGRITY_FAILURES = telemetry.registry().counter(
    "pio_model_integrity_failures_total",
    "Model blobs refused by the verifying loader, by failure kind "
    "(missing/header/version/size/checksum/deserialize)",
    ("kind",))
_M_LEGACY_LOADS = telemetry.registry().counter(
    "pio_model_legacy_loads_total",
    "Pre-checksum model blobs accepted without verification (written "
    "before the envelope format; re-train to upgrade)")


class ModelIntegrityError(RuntimeError):
    """This instance's stored model is not deployable (and why)."""

    def __init__(self, instance_id: str, kind: str, detail: str):
        super().__init__(
            f"model for engine instance {instance_id} is not deployable "
            f"({kind}): {detail}")
        self.instance_id = instance_id
        self.kind = kind


def count_integrity_failure(kind: str) -> None:
    with _counts_lock:
        _INTEGRITY_FAILURES[kind] += 1
    _M_INTEGRITY_FAILURES.labels(kind).inc()


def integrity_failure_counts() -> dict[str, int]:
    """Process-wide loader refusals by kind."""
    with _counts_lock:
        return dict(_INTEGRITY_FAILURES)


def _fail(instance_id: str, kind: str, detail: str) -> ModelIntegrityError:
    count_integrity_failure(kind)
    return ModelIntegrityError(instance_id, kind, detail)


def compute_sha256(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def wrap(payload: bytes, sha256: Optional[str] = None) -> bytes:
    """Serialized-models payload → checksummed envelope bytes.
    ``sha256`` may be passed when the caller already computed it."""
    header = json.dumps({
        "v": FORMAT_VERSION,
        "sha256": sha256 or compute_sha256(payload),
        "size": len(payload),
    }, sort_keys=True).encode()
    return MAGIC + _LEN.pack(len(header)) + header + payload


def describe(blob: Optional[bytes]) -> dict:
    """Non-raising inspection: classify a stored blob without loading it.
    Returns ``format`` ("v<N>" / "legacy" / "invalid" / "missing"),
    declared + actual metadata, ``ok`` and the failure ``kind`` (None
    when verified or legacy)."""
    if blob is None:
        return {"format": "missing", "ok": False, "kind": "missing",
                "size": 0, "sha256": None}
    blob = bytes(blob)
    if not blob.startswith(MAGIC):
        if blob[:1] == b"\x80":
            return {"format": "legacy", "ok": True, "kind": None,
                    "size": len(blob), "sha256": None}
        return {"format": "invalid", "ok": False, "kind": "header",
                "size": len(blob), "sha256": None}
    try:
        header, payload = _split(blob)
    except ValueError as e:
        return {"format": "invalid", "ok": False, "kind": "header",
                "size": len(blob), "sha256": None, "detail": str(e)}
    v = header.get("v")
    out = {"format": f"v{v}", "size": header.get("size"),
           "sha256": header.get("sha256"), "ok": True, "kind": None}
    # same classification as unwrap_verified: one kind per blob
    if not isinstance(v, int) or v < 1:
        out.update(ok=False, kind="header")
    elif v > FORMAT_VERSION:
        out.update(ok=False, kind="version")
    elif len(payload) != header.get("size"):
        out.update(ok=False, kind="size", actual_size=len(payload))
    elif compute_sha256(payload) != header.get("sha256"):
        out.update(ok=False, kind="checksum")
    return out


def _split(blob: bytes) -> tuple[dict, bytes]:
    """Envelope bytes → (header dict, payload). Raises ValueError on any
    structural damage."""
    if len(blob) < len(MAGIC) + _LEN.size:
        raise ValueError("envelope shorter than its fixed header")
    (hlen,) = _LEN.unpack_from(blob, len(MAGIC))
    start = len(MAGIC) + _LEN.size
    if hlen <= 0 or start + hlen > len(blob):
        raise ValueError(f"envelope header length {hlen} out of range")
    try:
        header = json.loads(blob[start:start + hlen])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"envelope header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError("envelope header is not an object")
    return header, blob[start + hlen:]


def unwrap_verified(blob: bytes, instance_id: str) -> bytes:
    """Envelope bytes → verified payload. A legacy (pre-envelope) pickle
    is passed through with a warning, as the reference does; everything
    else must verify. Raises :class:`ModelIntegrityError` (and counts the
    kind) on any mismatch. Never mutates or deletes the stored blob."""
    blob = bytes(blob)
    if not blob.startswith(MAGIC):
        if blob[:1] == b"\x80":
            _M_LEGACY_LOADS.labels().inc()
            log.warning(
                "model for engine instance %s predates checksummed "
                "artifacts; passing it on unverified", instance_id)
            return blob
        raise _fail(instance_id, "header",
                    f"blob is neither an envelope nor a pickle "
                    f"(first bytes {blob[:8]!r})")
    try:
        header, payload = _split(blob)
    except ValueError as e:
        raise _fail(instance_id, "header", str(e)) from None
    v = header.get("v")
    if not isinstance(v, int) or v < 1:
        raise _fail(instance_id, "header", f"bad format version {v!r}")
    if v > FORMAT_VERSION:
        raise _fail(instance_id, "version",
                    f"written by format v{v}, this build reads up to "
                    f"v{FORMAT_VERSION}")
    if len(payload) != header.get("size"):
        raise _fail(instance_id, "size",
                    f"payload is {len(payload)} bytes, header declares "
                    f"{header.get('size')} (truncated or overwritten)")
    actual = compute_sha256(payload)
    if actual != header.get("sha256"):
        raise _fail(instance_id, "checksum",
                    f"sha256 {actual[:12]}… does not match declared "
                    f"{str(header.get('sha256'))[:12]}… (corruption)")
    return payload


# ---------------------------------------------------------------------------
# The DAO chokepoints: the only Models access of the workflow
# ---------------------------------------------------------------------------


def write_model(storage, instance_id: str, payload: bytes) -> str:
    """Persist a trained payload as a checksummed artifact; returns the
    payload's sha256 hex (computed exactly once)."""
    sha = compute_sha256(payload)
    storage.get_model_data_models().insert(
        Model(instance_id, wrap(payload, sha)))
    return sha


def read_model(storage, instance_id: str) -> bytes:
    """Fetch + verify the stored model payload for an instance. Raises
    :class:`ModelIntegrityError` (kind="missing") when the row does not
    exist — a COMPLETED instance without a model is the crash-mid-persist
    state the loader must skip, not serve."""
    row = storage.get_model_data_models().get(instance_id)
    if row is None:
        raise _fail(instance_id, "missing",
                    "no model row (crash between train and persistence, "
                    "or deleted)")
    return unwrap_verified(row.models, instance_id)


def get_model_row(storage, instance_id: str) -> Optional[Model]:
    """Raw row fetch for inspection tooling (``pio models``): no
    verification, no counters."""
    return storage.get_model_data_models().get(instance_id)


def model_exists(storage, instance_id: str) -> bool:
    """Row-existence probe — ``pio models gc`` ranks with this instead of
    reading every artifact."""
    return storage.get_model_data_models().exists(instance_id)


def delete_model(storage, instance_id: str) -> None:
    """The GC chokepoint (``pio models gc``). Deliberately called by no
    failure path — corrupt blobs are kept for forensics."""
    storage.get_model_data_models().delete(instance_id)


def instance_app_name(instance) -> str:
    """The app an engine-instance row is bound to, or "":
    ``env["appName"]`` (stamped by ``run_train``) wins; the data-source
    params' ``appName``/``app_name`` is the fallback."""
    try:
        name = (instance.env or {}).get("appName")
        if name:
            return str(name)
        doc = json.loads(instance.data_source_params or "{}")
        if isinstance(doc, dict):
            return str(doc.get("appName") or doc.get("app_name") or "")
    except Exception:  # noqa: BLE001 — unparseable row binds nowhere
        pass
    return ""


def folded_through(instance, ids) -> bool:
    """Whether ``instance`` is a fold-in increment folded through one of
    ``ids`` (its marker's ``bases``). Such an increment carries whatever
    got those instances pinned, so a walk that skips them skips it too."""
    if not ids:
        return False
    try:
        raw = (instance.runtime_conf or {}).get("foldin")
        if not raw:
            return False
        doc = json.loads(raw) if isinstance(raw, str) else raw
        bases = doc.get("bases")
        return isinstance(bases, list) and any(b in ids for b in bases)
    except Exception:  # noqa: BLE001 — an unreadable marker proves nothing
        return False


def newer_completed_instance(instances, engine_factory_name: str,
                             engine_variant: str, current,
                             exclude=(), app_name: Optional[str] = None):
    """Newest COMPLETED instance not in ``exclude`` (nor folded through
    one) and strictly newer than ``current`` (an instance row, an
    instance id, or None), else None: the one definition of "a newer
    deployable candidate" of the engine server's refresh poll. With
    ``app_name`` the walk is confined to that app's instances."""
    done = instances.get_completed(
        engine_factory_name or "engine", "1", engine_variant)
    cur_row = (instances.get(current) if isinstance(current, str)
               else current)
    for c in done:
        if app_name is not None and instance_app_name(c) != app_name:
            continue
        if c.id in exclude or folded_through(c, exclude):
            continue
        if cur_row is not None and (
                c.id == cur_row.id
                or c.start_time <= cur_row.start_time):
            return None
        return c
    return None


# ---------------------------------------------------------------------------
# Fleet and fold-in records: plain JSON rows beside the model artifacts
# ---------------------------------------------------------------------------

#: Reserved id prefix of the fleet records. Engine-instance ids are
#: event-id hex strings, so a dunder prefix cannot collide.
FLEET_ROW_PREFIX = "__pio_fleet__"

#: Reserved id prefix of the streaming fold-in cursor records: one row per
#: (fleet group, app), single writer (the fold-in producer).
FOLDIN_ROW_PREFIX = "__pio_foldin__"


def foldin_row_id(group: str, app_id: int) -> str:
    """Storage row id of one fold-in cursor record: the durable byte
    cursor (plus freshness bookkeeping) the online-learning tailer resumes
    from after a restart."""
    return f"{FOLDIN_ROW_PREFIX}{group}__a{int(app_id)}"


def fleet_fresh_s(sync_ms: float) -> float:
    """Staleness horizon for a replica status row: rows older than this
    are a dead or wedged replica's. The one definition the coordinator's
    promote and adoption votes and `pio status`'s STALE marker share (5
    sync ticks, floored at 10 s)."""
    return max(10.0, float(sync_ms) / 1000.0 * 5)


def fleet_group(engine_factory_name: str, engine_variant: str,
                app_name: Optional[str] = None) -> str:
    """Canonical fleet group id — the one definition every writer and
    reader of the fleet and fold-in rows derives its keys from (the
    reference's, so both packages address the same rows). An app-scoped
    group appends its app dimension."""
    group = f"{engine_factory_name or 'engine'}::{engine_variant}"
    return group if not app_name else f"{group}::app={app_name}"


def fleet_row_id(group: str, replica: Optional[int] = None) -> str:
    """Storage row id of a fleet record: the group's directive record
    (``replica=None``, written only by the coordinator) or one replica's
    status row (written only by that replica)."""
    base = f"{FLEET_ROW_PREFIX}{group}"
    return base if replica is None else f"{base}__r{int(replica)}"


def read_fleet_doc(storage, row_id: str) -> Optional[dict]:
    """Fetch one fleet or fold-in record. Any damage (unreadable row,
    non-JSON bytes) degrades to None — the next write heals it."""
    try:
        row = storage.get_model_data_models().get(row_id)
        if row is None:
            return None
        doc = json.loads(bytes(row.models).decode("utf-8"))
        return doc if isinstance(doc, dict) else None
    except Exception:  # noqa: BLE001 — degraded read, next write heals
        log.warning("fleet record %s unreadable; treating as absent",
                    row_id, exc_info=True)
        return None


def write_fleet_doc(storage, row_id: str, doc: dict,
                    fault: bool = False) -> None:
    """Persist one fleet or fold-in record (plain sorted-key JSON bytes —
    coordination state, not a model artifact, so no envelope).
    ``fault=True`` (the coordinator's directive writes) arms the
    ``fleet.record`` fault point; replica status writes skip it."""
    if fault:
        faultinject.fault_point("fleet.record")
    storage.get_model_data_models().insert(
        Model(row_id, json.dumps(doc, sort_keys=True).encode("utf-8")))
