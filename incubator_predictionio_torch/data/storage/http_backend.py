"""Network (client-server) storage backend over HTTP.

The port's own copy of ``incubator_predictionio_tpu/data/storage/http_backend.py``; the wire
bytes and the tables are the reference's, so either package reads a store
the other wrote.

The reference's production deployments put events/metadata/models in a
separate storage SERVICE — HBase (data/.../storage/hbase/HBEventsUtil),
PostgreSQL/MySQL (storage/jdbc/JDBCUtils) or Elasticsearch
(storage/elasticsearch/ESLEvents) — so many hosts share one store. This
is this package's counterpart: a `pio storageserver` process
(data/api/storage_server.py) hosts the full DAO surface over HTTP on top
of any embedded backend (SQLite/JSONL/LocalFS), and this client speaks
the protocol from any number of training/serving/event-server hosts.

Configuration (reference env-var shape, e.g. the ES/JDBC sources):

    PIO_STORAGE_SOURCES_<N>_TYPE=HTTP
    PIO_STORAGE_SOURCES_<N>_HOSTS=stores1      (first host used; the
    PIO_STORAGE_SOURCES_<N>_PORTS=7072          list mirrors upstream)

Wire protocol (JSON; one POST per DAO call):

    POST /rpc/<dao>/<method>   {"namespace": ..., "args": {...}}
      → 200 {"result": ...} | 4xx/5xx {"error": ...}
    POST /rpc/l_events/find → NDJSON event stream (chunked)
    PUT/GET/DELETE /models/<namespace>/<id> → raw model blob bytes
    GET /health → {"status": "ok"}

Records cross the wire as JSON via the codecs below; events reuse
Event.to_json/from_json (the event-server wire format), so an HTTP
storage round-trip is bit-identical to an export/import round-trip.
"""

from __future__ import annotations

import datetime as _dt
import http.client as _http_client
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterable, Iterator, Optional, Sequence

from ...common import faultinject, resilience
from . import base
from .event import Event


# ---------------------------------------------------------------------------
# Record ↔ JSON codecs
# ---------------------------------------------------------------------------


def _dt_to_json(t: Optional[_dt.datetime]) -> Optional[str]:
    return None if t is None else t.isoformat()


def _dt_from_json(s: Optional[str]) -> Optional[_dt.datetime]:
    return None if s is None else _dt.datetime.fromisoformat(s)


def property_map_to_json(pm) -> dict:
    return {
        "properties": pm.to_dict(),
        "firstUpdated": _dt_to_json(pm.first_updated),
        "lastUpdated": _dt_to_json(pm.last_updated),
    }


def property_map_from_json(o: dict):
    from .datamap import PropertyMap

    return PropertyMap(o["properties"], _dt_from_json(o["firstUpdated"]),
                       _dt_from_json(o["lastUpdated"]))


def app_to_json(a: base.App) -> dict:
    return {"id": a.id, "name": a.name, "description": a.description}


def app_from_json(o: dict) -> base.App:
    return base.App(id=o["id"], name=o["name"], description=o.get("description"))


def access_key_to_json(k: base.AccessKey) -> dict:
    return {"key": k.key, "appid": k.appid, "events": list(k.events)}


def access_key_from_json(o: dict) -> base.AccessKey:
    return base.AccessKey(key=o["key"], appid=o["appid"],
                          events=tuple(o.get("events") or ()))


def channel_to_json(c: base.Channel) -> dict:
    return {"id": c.id, "name": c.name, "appid": c.appid}


def channel_from_json(o: dict) -> base.Channel:
    return base.Channel(id=o["id"], name=o["name"], appid=o["appid"])


def engine_instance_to_json(i: base.EngineInstance) -> dict:
    return {
        "id": i.id, "status": i.status,
        "startTime": _dt_to_json(i.start_time),
        "endTime": _dt_to_json(i.end_time),
        "engineId": i.engine_id, "engineVersion": i.engine_version,
        "engineVariant": i.engine_variant, "engineFactory": i.engine_factory,
        "batch": i.batch, "env": dict(i.env),
        "runtimeConf": dict(i.runtime_conf),
        "dataSourceParams": i.data_source_params,
        "preparatorParams": i.preparator_params,
        "algorithmsParams": i.algorithms_params,
        "servingParams": i.serving_params,
    }


def engine_instance_from_json(o: dict) -> base.EngineInstance:
    return base.EngineInstance(
        id=o["id"], status=o["status"],
        start_time=_dt_from_json(o["startTime"]),
        end_time=_dt_from_json(o.get("endTime")),
        engine_id=o["engineId"], engine_version=o["engineVersion"],
        engine_variant=o["engineVariant"], engine_factory=o["engineFactory"],
        batch=o.get("batch", ""), env=o.get("env") or {},
        runtime_conf=o.get("runtimeConf") or {},
        data_source_params=o.get("dataSourceParams", "{}"),
        preparator_params=o.get("preparatorParams", "{}"),
        algorithms_params=o.get("algorithmsParams", "[]"),
        serving_params=o.get("servingParams", "{}"),
    )


def evaluation_instance_to_json(i: base.EvaluationInstance) -> dict:
    return {
        "id": i.id, "status": i.status,
        "startTime": _dt_to_json(i.start_time),
        "endTime": _dt_to_json(i.end_time),
        "evaluationClass": i.evaluation_class,
        "engineParamsGeneratorClass": i.engine_params_generator_class,
        "batch": i.batch, "env": dict(i.env),
        "evaluatorResults": i.evaluator_results,
        "evaluatorResultsHTML": i.evaluator_results_html,
        "evaluatorResultsJSON": i.evaluator_results_json,
    }


def evaluation_instance_from_json(o: dict) -> base.EvaluationInstance:
    return base.EvaluationInstance(
        id=o["id"], status=o["status"],
        start_time=_dt_from_json(o["startTime"]),
        end_time=_dt_from_json(o.get("endTime")),
        evaluation_class=o["evaluationClass"],
        engine_params_generator_class=o["engineParamsGeneratorClass"],
        batch=o.get("batch", ""), env=o.get("env") or {},
        evaluator_results=o.get("evaluatorResults", ""),
        evaluator_results_html=o.get("evaluatorResultsHTML", ""),
        evaluator_results_json=o.get("evaluatorResultsJSON", ""),
    )


def find_args_to_json(kwargs: dict) -> dict:
    """LEvents/PEvents.find kwargs → wire JSON (datetimes ISO)."""
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, _dt.datetime):
            v = v.isoformat()
        elif isinstance(v, (list, tuple)):
            v = list(v)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# HTTP client
# ---------------------------------------------------------------------------


class StorageServerError(Exception):
    """Transport or server-side failure of a storage RPC."""


# Per-line cap for NDJSON scan streams. Events with multi-MB properties
# fit comfortably; an unterminated line from a buggy server trips it.
_MAX_STREAM_LINE = 64 * 1024 * 1024


class _Transport:
    """Resilient HTTP transport: every wire operation runs through the
    shared :mod:`common.resilience` policy/breaker pair and declares a
    fault point (``http.ping`` / ``http.call`` / ``http.stream`` /
    ``http.blob``) for deterministic chaos testing.

    Retry semantics: all operations retry on retryable failures
    (connection refused/reset, timeouts, 429/502/503/504). RPC POSTs are
    retried too — DAO reads are idempotent, and write retries are
    at-least-once (a response lost AFTER the server committed may
    duplicate an insert; the alternative, dying on the first transient
    socket error, loses the write outright). Repeated failures trip the
    per-endpoint circuit breaker; while it is open every operation fails
    fast with :class:`~...common.resilience.CircuitOpenError` (surfaced
    by the event server as 503 + Retry-After).
    """

    def __init__(self, url: str, timeout: float = 30.0,
                 stream_timeout: float = 600.0,
                 secret: Optional[str] = None,
                 policy: Optional[resilience.RetryPolicy] = None,
                 breaker: Optional[resilience.CircuitBreaker] = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.stream_timeout = stream_timeout
        self.secret = secret
        self.policy = policy or resilience.RetryPolicy()
        self.breaker = breaker or resilience.CircuitBreaker(self.url)

    def _headers(self, base: Optional[dict] = None) -> dict:
        h = dict(base or {})
        if self.secret:
            h["Authorization"] = f"Bearer {self.secret}"
        return h

    def ping(self, policy: Optional[resilience.RetryPolicy] = None,
             use_breaker: bool = True) -> None:
        """Health check, retried under ``policy`` (default: the
        transport policy). The constructor passes a short bounded policy
        and ``use_breaker=False`` so `pio deploy` no longer loses the
        race against a storage server still binding its port — the
        pre-service connect refusals must neither trip the breaker open
        mid-retry (which would abort the startup grace window early)
        nor leave failure counts behind on a breaker that should start
        clean once the server answers."""
        try:
            with resilience.resilient_urlopen(
                self.url + "/health", timeout=self.timeout,
                policy=policy or self.policy,
                breaker=self.breaker if use_breaker else None,
                point="http.ping",
            ) as r:
                if json.loads(r.read()).get("status") != "ok":
                    raise StorageServerError("storage server unhealthy")
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            raise StorageServerError(
                f"storage server unreachable at {self.url}: {e}"
            ) from e

    def call(self, dao: str, method: str, namespace: str, args: dict):
        body = json.dumps({"namespace": namespace, "args": args}).encode()
        req = urllib.request.Request(
            f"{self.url}/rpc/{dao}/{method}", data=body,
            headers=self._headers({"Content-Type": "application/json"}),
        )
        try:
            with resilience.resilient_urlopen(
                req, timeout=self.timeout, policy=self.policy,
                breaker=self.breaker, point="http.call",
                retry_non_idempotent=True,
            ) as r:
                return json.loads(r.read()).get("result")
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                detail = ""
            raise StorageServerError(
                f"{dao}.{method} failed ({e.code}): {detail}"
            ) from e
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            raise StorageServerError(
                f"{dao}.{method}: storage server unreachable: {e}"
            ) from e

    def stream(self, dao: str, method: str, namespace: str,
               args: dict) -> Iterator[dict]:
        """NDJSON scan stream with mid-stream RESUME: when the
        connection drops partway, the request is re-issued and the
        rows already delivered are skipped, so the consumer sees every
        row exactly once instead of the whole scan restarting (the
        server's scan order is deterministic for identical args)."""
        produced = 0
        state = {
            "produced_at_window": 0,
            "window_start": time.monotonic(),
            "attempt": 0,
        }

        def pace_or_raise(e: BaseException, desc: str) -> None:
            """Shared retry bookkeeping: sleep a jittered backoff, or
            raise StorageServerError when out of budget. The budget
            bounds time WITHOUT PROGRESS, not scan lifetime: a drop
            after 20 minutes of healthy streaming still deserves its
            full resume budget."""
            if produced > state["produced_at_window"]:
                state["attempt"] = 0
                state["window_start"] = time.monotonic()
                state["produced_at_window"] = produced
            state["attempt"] += 1
            delay = self.policy.backoff(state["attempt"] - 1)
            if (state["attempt"] >= self.policy.max_attempts
                    or not resilience.is_retryable(e)
                    or (time.monotonic() - state["window_start"] + delay
                        > self.policy.deadline)):
                raise StorageServerError(
                    f"{dao}.{method}: {desc} (after {produced} row(s), "
                    f"attempt {state['attempt']}): {e}") from e
            if delay > 0:
                time.sleep(delay)

        own_probe = False
        in_flight = False
        try:
            while True:
                own_probe = self.breaker.check()
                in_flight = True
                try:
                    for i, obj in enumerate(
                            self._stream_once(dao, method, namespace, args)):
                        if i < produced:
                            continue        # resume: already delivered
                        produced += 1
                        yield obj
                    self.breaker.record_success()
                    in_flight = False
                    return
                except urllib.error.HTTPError as e:
                    # the endpoint ANSWERED: application-level statuses
                    # are breaker successes and fatal; transient infra
                    # statuses (429/502/503/504) count against the
                    # breaker and retry like a dropped connection
                    retryable = resilience.is_retryable(e)
                    if retryable:
                        self.breaker.record_failure()
                    else:
                        self.breaker.record_success()
                    in_flight = False
                    if not retryable:
                        try:
                            detail = json.loads(e.read()).get("error", "")
                        except Exception:
                            detail = ""
                        raise StorageServerError(
                            f"{dao}.{method} failed ({e.code}): {detail}"
                        ) from e
                    try:
                        e.close()  # drop the 429/5xx socket before retrying
                    except Exception:
                        pass
                    pace_or_raise(e, f"storage server answered {e.code}")
                except (OSError, _http_client.HTTPException) as e:
                    self.breaker.record_failure()
                    in_flight = False
                    pace_or_raise(e, "storage server stream failed")
        finally:
            if in_flight and own_probe:
                # our half-open probe ended with no verdict (consumer
                # dropped the generator mid-scan, or an unexpected
                # error): free the slot we hold, bias nothing
                self.breaker.release_probe()

    def _stream_once(self, dao: str, method: str, namespace: str,
                     args: dict) -> Iterator[dict]:
        faultinject.fault_point("http.stream")
        drop = faultinject.stream_fault("http.stream")
        body = json.dumps({"namespace": namespace, "args": args}).encode()
        req = urllib.request.Request(
            f"{self.url}/rpc/{dao}/{method}", data=body,
            headers=self._headers({"Content-Type": "application/json",
                                   "Accept": "application/x-ndjson"}),
        )
        # Streaming scans use their own (much longer) timeout: a
        # selective filter over a big store can be silent on the wire
        # for a while between slabs without being dead.
        with urllib.request.urlopen(
            req, timeout=self.stream_timeout
        ) as r:
            while True:
                # Bounded readline: a server-side bug emitting an
                # unterminated line must not buffer unboundedly here.
                line = r.readline(_MAX_STREAM_LINE + 1)
                if not line:
                    break
                if len(line) > _MAX_STREAM_LINE and not line.endswith(b"\n"):
                    raise StorageServerError(
                        f"{dao}.{method}: stream line exceeds "
                        f"{_MAX_STREAM_LINE} bytes (malformed NDJSON "
                        "from server)")
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if isinstance(obj, dict) and "__error__" in obj:
                    # Server hit an error mid-stream (headers were
                    # already sent) and reported it in-band.
                    raise StorageServerError(
                        f"{dao}.{method} failed mid-scan: "
                        f"{obj['__error__']}")
                if drop is not None:
                    drop.on_item()
                yield obj

    def blob(self, method: str, path: str, data: Optional[bytes] = None):
        req = urllib.request.Request(
            f"{self.url}{path}", data=data, method=method,
            headers=self._headers(
                {"Content-Type": "application/octet-stream"}
                if data is not None else {}),
        )
        try:
            with resilience.resilient_urlopen(
                req, timeout=self.timeout, policy=self.policy,
                breaker=self.breaker, point="http.blob",
            ) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            # 404 is an expected answer only for reads/deletes of a
            # missing blob. A PUT that 404s (wrong path prefix, proxy
            # misroute) means the model was NOT stored — silent None here
            # would surface much later as a failed deploy.
            if e.code == 404 and method in ("GET", "DELETE"):
                return None
            raise StorageServerError(f"{method} {path} failed ({e.code})") from e
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            raise StorageServerError(
                f"{method} {path}: storage server unreachable: {e}") from e


class _HTTPApps(base.Apps):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _call(self, method, **args):
        return self._t.call("apps", method, self._ns, args)

    def insert(self, app):
        return self._call("insert", record=app_to_json(app))

    def get(self, app_id):
        o = self._call("get", app_id=app_id)
        return None if o is None else app_from_json(o)

    def get_by_name(self, name):
        o = self._call("get_by_name", name=name)
        return None if o is None else app_from_json(o)

    def get_all(self):
        return [app_from_json(o) for o in self._call("get_all")]

    def update(self, app):
        self._call("update", record=app_to_json(app))

    def delete(self, app_id):
        self._call("delete", app_id=app_id)


class _HTTPAccessKeys(base.AccessKeys):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _call(self, method, **args):
        return self._t.call("access_keys", method, self._ns, args)

    def insert(self, k):
        return self._call("insert", record=access_key_to_json(k))

    def get(self, key):
        o = self._call("get", key=key)
        return None if o is None else access_key_from_json(o)

    def get_all(self):
        return [access_key_from_json(o) for o in self._call("get_all")]

    def get_by_appid(self, appid):
        return [access_key_from_json(o)
                for o in self._call("get_by_appid", appid=appid)]

    def update(self, k):
        self._call("update", record=access_key_to_json(k))

    def delete(self, key):
        self._call("delete", key=key)


class _HTTPChannels(base.Channels):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _call(self, method, **args):
        return self._t.call("channels", method, self._ns, args)

    def insert(self, channel):
        return self._call("insert", record=channel_to_json(channel))

    def get(self, channel_id):
        o = self._call("get", channel_id=channel_id)
        return None if o is None else channel_from_json(o)

    def get_by_appid(self, appid):
        return [channel_from_json(o)
                for o in self._call("get_by_appid", appid=appid)]

    def delete(self, channel_id):
        self._call("delete", channel_id=channel_id)


class _HTTPEngineInstances(base.EngineInstances):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _call(self, method, **args):
        return self._t.call("engine_instances", method, self._ns, args)

    def insert(self, i):
        return self._call("insert", record=engine_instance_to_json(i))

    def get(self, instance_id):
        o = self._call("get", instance_id=instance_id)
        return None if o is None else engine_instance_from_json(o)

    def get_all(self):
        return [engine_instance_from_json(o) for o in self._call("get_all")]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        o = self._call("get_latest_completed", engine_id=engine_id,
                       engine_version=engine_version,
                       engine_variant=engine_variant)
        return None if o is None else engine_instance_from_json(o)

    def get_completed(self, engine_id, engine_version, engine_variant):
        return [engine_instance_from_json(o)
                for o in self._call("get_completed", engine_id=engine_id,
                                    engine_version=engine_version,
                                    engine_variant=engine_variant)]

    def update(self, i):
        self._call("update", record=engine_instance_to_json(i))

    def delete(self, instance_id):
        self._call("delete", instance_id=instance_id)


class _HTTPEvaluationInstances(base.EvaluationInstances):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _call(self, method, **args):
        return self._t.call("evaluation_instances", method, self._ns, args)

    def insert(self, i):
        return self._call("insert", record=evaluation_instance_to_json(i))

    def get(self, instance_id):
        o = self._call("get", instance_id=instance_id)
        return None if o is None else evaluation_instance_from_json(o)

    def get_all(self):
        return [evaluation_instance_from_json(o)
                for o in self._call("get_all")]

    def get_completed(self):
        return [evaluation_instance_from_json(o)
                for o in self._call("get_completed")]

    def update(self, i):
        self._call("update", record=evaluation_instance_to_json(i))

    def delete(self, instance_id):
        self._call("delete", instance_id=instance_id)


class _HTTPModels(base.Models):
    """Model blobs ride raw HTTP bodies — no base64 tax on multi-GB
    factor matrices (HDFS/S3-role store, SURVEY.md §2.1 last row)."""

    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _path(self, model_id: str) -> str:
        return (f"/models/{urllib.parse.quote(self._ns, safe='')}"
                f"/{urllib.parse.quote(model_id, safe='')}")

    def insert(self, model):
        self._t.blob("PUT", self._path(model.id), data=model.models)

    def get(self, model_id):
        data = self._t.blob("GET", self._path(model_id))
        return None if data is None else base.Model(id=model_id, models=data)

    def delete(self, model_id):
        self._t.blob("DELETE", self._path(model_id))


class _HTTPLEvents(base.LEvents):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def _call(self, method, **args):
        return self._t.call("l_events", method, self._ns, args)

    def init(self, app_id, channel_id=None):
        return self._call("init", app_id=app_id, channel_id=channel_id)

    def remove(self, app_id, channel_id=None):
        return self._call("remove", app_id=app_id, channel_id=channel_id)

    def insert(self, event, app_id, channel_id=None):
        return self._call("insert", event=event.to_json(), app_id=app_id,
                          channel_id=channel_id)

    def insert_batch(self, events, app_id, channel_id=None):
        return self._call("insert_batch",
                          events=[e.to_json() for e in events],
                          app_id=app_id, channel_id=channel_id)

    def get(self, event_id, app_id, channel_id=None):
        o = self._call("get", event_id=event_id, app_id=app_id,
                       channel_id=channel_id)
        return None if o is None else Event.from_json(o)

    def delete(self, event_id, app_id, channel_id=None):
        return self._call("delete", event_id=event_id, app_id=app_id,
                          channel_id=channel_id)

    def delete_batch(self, event_ids, app_id, channel_id=None):
        return self._call("delete_batch", event_ids=list(event_ids),
                          app_id=app_id, channel_id=channel_id)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        # Server-side replay (see _HTTPPEvents.aggregate_properties).
        out = self._call(
            "aggregate_properties", app_id=app_id, entity_type=entity_type,
            channel_id=channel_id, start_time=_dt_to_json(start_time),
            until_time=_dt_to_json(until_time),
            required=list(required) if required else None)
        return {eid: property_map_from_json(o)
                for eid, o in (out or {}).items()}

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None, limit=None,
             reversed_order=False) -> Iterator[Event]:
        args = find_args_to_json(dict(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed_order=reversed_order,
        ))
        for o in self._t.stream("l_events", "find", self._ns, args):
            yield Event.from_json(o)


class _HTTPPEvents(base.PEvents):
    def __init__(self, t: _Transport, ns: str):
        self._t, self._ns = t, ns

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        args = find_args_to_json(dict(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        ))
        for o in self._t.stream("p_events", "find", self._ns, args):
            yield Event.from_json(o)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        # Server-side replay: one result dict per entity crosses the
        # wire instead of the whole $set/$unset/$delete event stream,
        # and the server's backend may aggregate columnar (JSONL).
        out = self._t.call("p_events", "aggregate_properties", self._ns, {
            "app_id": app_id, "entity_type": entity_type,
            "channel_id": channel_id,
            "start_time": _dt_to_json(start_time),
            "until_time": _dt_to_json(until_time),
            "required": list(required) if required else None,
        })
        return {eid: property_map_from_json(o)
                for eid, o in (out or {}).items()}

    def write(self, events: Iterable[Event], app_id, channel_id=None):
        # Chunked so arbitrarily large bulk writes stream in bounded
        # memory on both sides.
        batch: list[dict] = []
        for e in events:
            batch.append(e.to_json())
            if len(batch) >= 1000:
                self._t.call("p_events", "write", self._ns,
                             {"events": batch, "app_id": app_id,
                              "channel_id": channel_id})
                batch = []
        if batch:
            self._t.call("p_events", "write", self._ns,
                         {"events": batch, "app_id": app_id,
                          "channel_id": channel_id})

    def delete(self, event_ids: Iterable[str], app_id, channel_id=None):
        self._t.call("p_events", "delete", self._ns,
                     {"event_ids": list(event_ids), "app_id": app_id,
                      "channel_id": channel_id})


class HTTPStorageClient(base.BaseStorageClient):
    """TYPE=HTTP — all three repositories served by a pio storageserver.

    Pings /health on construction (reference: per-backend StorageClient
    constructors fail fast on unreachable stores, surfacing in
    `pio status` via verify_all_data_objects).
    """

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        props = config.properties
        host = (props.get("HOSTS") or "127.0.0.1").split(",")[0].strip()
        port = (props.get("PORTS") or "7072").split(",")[0].strip()
        scheme = props.get("SCHEME", "http")
        timeout = resilience.prop_float(props, "TIMEOUT", 30.0)
        stream_timeout = resilience.prop_float(props, "STREAM_TIMEOUT", 600.0)
        # Shared-secret auth: PIO_STORAGE_SOURCES_<N>_SECRET, falling back
        # to the server-side var so one-box setups configure it once.
        from ...common import envknobs

        secret = (props.get("SECRET")
                  or envknobs.env_str("PIO_STORAGESERVER_SECRET", "",
                                      lower=False)
                  or None)
        url = f"{scheme}://{host}:{port}"
        self._t = _Transport(
            url, timeout=timeout, stream_timeout=stream_timeout,
            secret=secret,
            policy=resilience.policy_from_props(props),
            breaker=resilience.breaker_from_props(props, f"http:{url}"))
        # Bounded startup retry: `pio deploy` / workers racing a storage
        # server that is still binding its port keep probing until the
        # CONNECT_DEADLINE budget is spent (CONNECT_ATTEMPTS is a
        # generous backstop — the deadline is the real bound) instead of
        # dying on the first refused connect.
        self._t.ping(policy=resilience.RetryPolicy(
            max_attempts=int(resilience.prop_float(
                props, "CONNECT_ATTEMPTS", 20)),
            base_delay=0.1, max_delay=0.5,
            deadline=resilience.prop_float(props, "CONNECT_DEADLINE", 5.0)),
            use_breaker=False)

    def breaker_states(self) -> list[dict]:
        return [self._t.breaker.snapshot()]

    def apps(self, namespace="pio_metadata"):
        return _HTTPApps(self._t, namespace)

    def access_keys(self, namespace="pio_metadata"):
        return _HTTPAccessKeys(self._t, namespace)

    def channels(self, namespace="pio_metadata"):
        return _HTTPChannels(self._t, namespace)

    def engine_instances(self, namespace="pio_metadata"):
        return _HTTPEngineInstances(self._t, namespace)

    def evaluation_instances(self, namespace="pio_metadata"):
        return _HTTPEvaluationInstances(self._t, namespace)

    def models(self, namespace="pio_modeldata"):
        return _HTTPModels(self._t, namespace)

    def l_events(self, namespace="pio_eventdata"):
        return _HTTPLEvents(self._t, namespace)

    def p_events(self, namespace="pio_eventdata"):
        return _HTTPPEvents(self._t, namespace)
