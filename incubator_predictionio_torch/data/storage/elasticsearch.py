"""Elasticsearch-compatible backend — the `ELASTICSEARCH` source type.

The port's own copy of
``incubator_predictionio_tpu/data/storage/elasticsearch.py``; the index
names and the documents are the reference's, so either package reads an
index the other wrote.

Reference: storage/elasticsearch/.../{ESApps,ESAccessKeys,ESChannels,
ESEngineInstances,ESEvaluationInstances,ESLEvents,ESPEvents,ESSequences}
(SURVEY.md §2.1): metadata + event data on an Elasticsearch 5+ cluster
over its REST API. Like the reference's ES assembly, this backend serves
METADATA and EVENTDATA (model blobs belong on LOCALFS/S3/HTTP).

Speaks the real ES REST protocol with no SDK — JSON over HTTP(S):
index/doc CRUD (`PUT/GET/DELETE /{index}/_doc/{id}`), `_bulk` NDJSON,
`_search` with bool/term/terms/range query DSL + `search_after`
pagination, and the reference's ESSequences id-generation trick (indexing
the same doc id returns a monotonically increasing `_version`). Works
against Elasticsearch 7/8 or OpenSearch:

    PIO_STORAGE_SOURCES_ES_TYPE=ELASTICSEARCH
    PIO_STORAGE_SOURCES_ES_HOSTS=es-host         (or full http(s)://...)
    PIO_STORAGE_SOURCES_ES_PORTS=9200
    PIO_STORAGE_SOURCES_ES_USERNAME=...          (optional, basic auth)
    PIO_STORAGE_SOURCES_ES_PASSWORD=...

Event ordering parity (the cross-backend tie-order contract,
tests/test_storage_contract.py): events sort by `eventTimeUs` with
`_seq_no` as the tiebreaker — a re-insert (upsert) re-indexes the doc,
bumping `_seq_no`, which moves it to the END of its equal-timestamp tie
group exactly like the MEMORY/SQLITE/JSONL backends."""

from __future__ import annotations

import base64
import datetime as _dt
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterable, Iterator, Optional, Sequence

from ...common import resilience
from . import base
from .event import Event, event_time_us as _time_us, new_event_id

_PAGE = 1000  # _search page size (search_after pagination)


class ESStorageError(RuntimeError):
    pass


class _ESTransport:
    def __init__(self, endpoint: str, username: str = "", password: str = "",
                 timeout: float = 30.0,
                 policy: Optional[resilience.RetryPolicy] = None,
                 breaker: Optional[resilience.CircuitBreaker] = None):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self._auth = None
        if username:
            token = base64.b64encode(
                f"{username}:{password}".encode()).decode()
            self._auth = f"Basic {token}"
        self.policy = policy or resilience.RetryPolicy()
        self.breaker = breaker or resilience.CircuitBreaker(
            f"es:{self.endpoint}")

    def request(self, method: str, path: str, body=None,
                ndjson: Optional[str] = None) -> tuple[int, dict]:
        url = self.endpoint + path
        if ndjson is not None:
            data = ndjson.encode()
            ctype = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
            ctype = "application/json"
        else:
            data, ctype = None, "application/json"
        headers = {"Content-Type": ctype}
        if self._auth:
            headers["Authorization"] = self._auth
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            with resilience.resilient_urlopen(
                req, timeout=self.timeout, policy=self.policy,
                breaker=self.breaker, point="es.request",
            ) as resp:
                raw = resp.read()
                return resp.status, (json.loads(raw) if raw else {})
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                return e.code, json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                return e.code, {"error": raw.decode(errors="replace")}
        except resilience.CircuitOpenError:
            raise
        except (OSError, resilience.RetryBudgetExceeded) as e:
            reason = getattr(e, "reason", e)
            raise ESStorageError(
                f"Elasticsearch unreachable: {self.endpoint} ({reason})"
            ) from e

    # -- helpers ----------------------------------------------------------

    #: Strings map to keyword (exact-match term filters — dynamic mapping
    #: would analyze them into lowercased tokens that term queries never
    #: match on a real cluster).
    _KEYWORD_STRINGS = {"dynamic_templates": [
        {"strings_as_keywords": {
            "match_mapping_type": "string",
            "mapping": {"type": "keyword"},
        }},
    ]}

    def ensure_index(self, index: str, event_index: bool = False) -> None:
        mappings = dict(self._KEYWORD_STRINGS)
        if event_index:
            # event properties are arbitrary JSON: store, don't index
            # (unbounded user-defined fields would blow the field limit)
            mappings["properties"] = {
                "properties": {"type": "object", "enabled": False}}
        status, body = self.request("PUT", f"/{index}",
                                    body={"mappings": mappings})
        if status == 200:
            return
        err = json.dumps(body)
        if status == 400 and ("resource_already_exists" in err
                              or "already exists" in err):
            return
        raise ESStorageError(f"create index {index}: HTTP {status} {body}")

    def drop_index(self, index: str) -> bool:
        status, _ = self.request("DELETE", f"/{index}")
        return status in (200, 404)

    def put_doc(self, index: str, doc_id: str, source: dict) -> dict:
        status, body = self.request(
            "PUT", f"/{index}/_doc/{urllib.parse.quote(doc_id, safe='')}"
            "?refresh=true", body=source)
        if status not in (200, 201):
            raise ESStorageError(f"index {index}/{doc_id}: HTTP {status} {body}")
        return body

    def get_doc(self, index: str, doc_id: str) -> Optional[dict]:
        status, body = self.request(
            "GET", f"/{index}/_doc/{urllib.parse.quote(doc_id, safe='')}")
        if status == 404:
            return None
        if status != 200:
            raise ESStorageError(f"get {index}/{doc_id}: HTTP {status} {body}")
        return body.get("_source")

    def delete_doc(self, index: str, doc_id: str) -> bool:
        status, body = self.request(
            "DELETE", f"/{index}/_doc/{urllib.parse.quote(doc_id, safe='')}"
            "?refresh=true")
        if status == 404:
            return False
        if status != 200:
            raise ESStorageError(
                f"delete {index}/{doc_id}: HTTP {status} {body}")
        return True

    def search(self, index: str, query: dict, sort=None, size=_PAGE,
               search_after=None) -> list[dict]:
        body = {"query": query, "size": size}
        if sort is not None:
            body["sort"] = sort
        if search_after is not None:
            body["search_after"] = search_after
        status, out = self.request("POST", f"/{index}/_search", body=body)
        if status == 404:
            return []
        if status != 200:
            raise ESStorageError(f"search {index}: HTTP {status} {out}")
        # A 200 can still carry PARTIAL results: failed shards or a
        # server-side timeout silently drop hits — for an event store
        # that's data loss, so fail loudly instead.
        shards = out.get("_shards") or {}
        if shards.get("failed"):
            raise ESStorageError(
                f"search {index}: {shards['failed']}/{shards.get('total')} "
                f"shards failed — partial results refused "
                f"(failures: {str(shards.get('failures'))[:300]})")
        if out.get("timed_out"):
            raise ESStorageError(
                f"search {index}: server-side timeout returned partial "
                "results — refused")
        return out.get("hits", {}).get("hits", [])

    def search_all(self, index: str, query: dict, sort,
                   limit: Optional[int] = None) -> Iterator[dict]:
        """search_after pagination — unbounded scans without ES's 10k
        from+size window limit."""
        after = None
        seen = 0
        while True:
            page = _PAGE if limit is None else min(_PAGE, limit - seen)
            if page <= 0:
                return
            hits = self.search(index, query, sort=sort, size=page,
                               search_after=after)
            if not hits:
                return
            for h in hits:
                yield h
                seen += 1
                if limit is not None and seen >= limit:
                    return
            after = hits[-1].get("sort")
            if after is None or len(hits) < page:
                return

    # -- sliced parallel scan (PIT) -----------------------------------------
    def open_pit(self, index: str, keep_alive: str = "2m") -> Optional[str]:
        """Point-in-time handle for sliced scans; None when the server
        doesn't support PIT (older ES) — callers fall back to the
        serial search_after scan. Speaks both flavors: Elasticsearch's
        ``POST /{index}/_pit`` and OpenSearch's
        ``POST /{index}/_search/point_in_time`` (the search-body usage
        is identical; only open/close differ)."""
        status, out = self.request(
            "POST", f"/{index}/_pit?keep_alive={keep_alive}")
        if status == 200 and isinstance(out, dict) and "id" in out:
            self._pit_flavor = getattr(self, "_pit_flavor", {})
            self._pit_flavor[out["id"]] = "es"
            return out["id"]
        status, out = self.request(
            "POST",
            f"/{index}/_search/point_in_time?keep_alive={keep_alive}")
        if status == 200 and isinstance(out, dict) and "pit_id" in out:
            self._pit_flavor = getattr(self, "_pit_flavor", {})
            self._pit_flavor[out["pit_id"]] = "opensearch"
            return out["pit_id"]
        return None

    def close_pit(self, pit_id: str) -> None:
        flavor = getattr(self, "_pit_flavor", {}).pop(pit_id, "es")
        if flavor == "opensearch":
            self.request("DELETE", "/_search/point_in_time",
                         body={"pit_id": [pit_id]})
        else:
            self.request("DELETE", "/_pit", body={"id": pit_id})

    def _search_pit(self, pit_id: str, query: dict, sort, size: int,
                    search_after, slice_id: int, slice_max: int) -> list[dict]:
        body = {"query": query, "size": size, "sort": sort,
                "pit": {"id": pit_id, "keep_alive": "2m"},
                "slice": {"id": slice_id, "max": slice_max}}
        if search_after is not None:
            body["search_after"] = search_after
        status, out = self.request("POST", "/_search", body=body)
        if status != 200:
            raise ESStorageError(f"sliced search: HTTP {status} {out}")
        shards = out.get("_shards") or {}
        if shards.get("failed") or out.get("timed_out"):
            raise ESStorageError(
                f"sliced search: partial results refused ({shards})")
        return out.get("hits", {}).get("hits", [])

    def search_all_sliced(self, index: str, query: dict, sort,
                          slices: int) -> Iterator[dict]:
        """Concurrent sliced scan merged back into global sort order.

        N slices page independently (each slice's NEXT page prefetches
        in a worker thread while the current one drains, overlapping
        the per-page round trips that serialize a plain search_after
        scan — the bottleneck feeding training from a 20M-event
        index); heapq.merge restores the total (sort-key) order, so
        the stream is indistinguishable from the serial scan. Falls
        back to search_all when the server has no PIT support."""
        import heapq
        from concurrent.futures import ThreadPoolExecutor

        if slices < 2:
            yield from self.search_all(index, query, sort)
            return
        pit = self.open_pit(index)
        if pit is None:
            yield from self.search_all(index, query, sort)
            return
        pool = ThreadPoolExecutor(max_workers=slices)
        try:
            def fetch(sid, after):
                return self._search_pit(pit, query, sort, _PAGE, after,
                                        sid, slices)

            # Eager first wave: every slice's first page is in flight
            # before anything is consumed (heapq.merge pulls the heads
            # sequentially during heapify — lazy submission would
            # serialize the first round trips).
            firsts = [pool.submit(fetch, s, None) for s in range(slices)]
            try:
                first_pages = [f.result() for f in firsts]
            except ESStorageError:
                # PIT opened but the sliced search body is rejected
                # (e.g. ES 7.10/7.11: PIT exists, PIT slicing doesn't).
                # Nothing has been yielded yet — degrade to serial.
                yield from self.search_all(index, query, sort)
                return

            def slice_iter(sid, hits):
                while True:
                    if not hits:
                        return
                    after = hits[-1].get("sort")
                    fut = (pool.submit(fetch, sid, after)
                           if after is not None and len(hits) >= _PAGE
                           else None)
                    yield from hits
                    if fut is None:
                        return
                    hits = fut.result()

            yield from heapq.merge(
                *(slice_iter(s, p) for s, p in enumerate(first_pages)),
                key=lambda h: tuple(h.get("sort") or ()))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            try:
                self.close_pit(pit)
            except ESStorageError:
                pass

    def next_sequence(self, index: str, name: str) -> int:
        """The reference's ESSequences: re-indexing the same doc id
        returns a strictly increasing _version."""
        body = self.put_doc(index, name, {"n": 1})
        return int(body["_version"])


# -- event data -------------------------------------------------------------


def _event_index(namespace: str, app_id: int,
                 channel_id: Optional[int]) -> str:
    idx = f"{namespace}_{int(app_id)}"
    if channel_id is not None:
        idx += f"_{int(channel_id)}"
    return idx.lower()


class ESLEvents(base.LEvents):
    def __init__(self, transport: _ESTransport, namespace: str):
        self._t = transport
        self._ns = namespace
        self._ensured: set[str] = set()

    def _idx(self, app_id, channel_id):
        return _event_index(self._ns, app_id, channel_id)

    def _ensured_idx(self, app_id, channel_id) -> str:
        """Index name, created with the RIGHT mappings if needed: relying
        on ES dynamic auto-creation would map entity ids as analyzed
        text and term filters would silently miss events on a real
        cluster (the keyword dynamic_template must be present)."""
        index = self._idx(app_id, channel_id)
        if index not in self._ensured:
            self._t.ensure_index(index, event_index=True)
            self._ensured.add(index)
        return index

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._ensured_idx(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._ensured.discard(self._idx(app_id, channel_id))
        return self._t.drop_index(self._idx(app_id, channel_id))

    @staticmethod
    def _source(event: Event) -> dict:
        doc = event.to_json()
        doc["eventTimeUs"] = _time_us(event.event_time)
        return doc

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        eid = event.event_id or new_event_id()
        stored = event.with_event_id(eid)
        self._t.put_doc(self._ensured_idx(app_id, channel_id), eid,
                        self._source(stored))
        return eid

    #: _bulk page size — real clusters cap request bodies
    #: (http.max_content_length defaults to 100 MB), so large imports
    #: must page rather than ship one unbounded request.
    _BULK_PAGE = 1000

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        if not events:
            return []
        index = self._ensured_idx(app_id, channel_id)
        ids: list[str] = []
        for lo in range(0, len(events), self._BULK_PAGE):
            lines = []
            for e in events[lo:lo + self._BULK_PAGE]:
                eid = e.event_id or new_event_id()
                ids.append(eid)
                lines.append(json.dumps(
                    {"index": {"_index": index, "_id": eid}}))
                lines.append(json.dumps(self._source(e.with_event_id(eid))))
            status, body = self._t.request(
                "POST", "/_bulk?refresh=true", ndjson="\n".join(lines) + "\n")
            if status != 200 or body.get("errors"):
                raise ESStorageError(f"bulk insert: HTTP {status} {body}")
        return ids

    def delete_batch(self, event_ids: Sequence[str], app_id: int,
                     channel_id: Optional[int] = None) -> list[bool]:
        """Paged _bulk delete — one request per page instead of one HTTP
        round trip (with refresh) per event."""
        if not event_ids:
            return []
        index = self._idx(app_id, channel_id)
        out: list[bool] = []
        for lo in range(0, len(event_ids), self._BULK_PAGE):
            page = event_ids[lo:lo + self._BULK_PAGE]
            lines = [json.dumps({"delete": {"_index": index, "_id": eid}})
                     for eid in page]
            status, body = self._t.request(
                "POST", "/_bulk?refresh=true", ndjson="\n".join(lines) + "\n")
            if status != 200:
                raise ESStorageError(f"bulk delete: HTTP {status} {body}")
            for item in body.get("items", []):
                res = item.get("delete", {})
                out.append(res.get("status") == 200
                           and res.get("result") != "not_found")
        return out

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        src = self._t.get_doc(self._idx(app_id, channel_id), event_id)
        return Event.from_json(src) if src is not None else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        return self._t.delete_doc(self._idx(app_id, channel_id), event_id)

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        query, sort = self._build_query(
            start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id, reversed_order)
        if limit is not None and limit < 0:
            limit = None
        for h in self._t.search_all(self._idx(app_id, channel_id), query,
                                    sort, limit=limit):
            yield Event.from_json(h["_source"])

    @staticmethod
    def _build_query(start_time, until_time, entity_type, entity_id,
                     event_names, target_entity_type, target_entity_id,
                     reversed_order) -> tuple[dict, list]:
        filters: list[dict] = []
        if event_names is not None:
            filters.append({"terms": {"event": list(event_names)}})
        for field, value in (
            ("entityType", entity_type),
            ("entityId", entity_id),
            ("targetEntityType", target_entity_type),
            ("targetEntityId", target_entity_id),
        ):
            if value is not None:
                filters.append({"term": {field: value}})
        time_range = {}
        if start_time is not None:
            time_range["gte"] = _time_us(start_time)
        if until_time is not None:
            time_range["lt"] = _time_us(until_time)
        if time_range:
            filters.append({"range": {"eventTimeUs": time_range}})
        query = {"bool": {"filter": filters}} if filters else {"match_all": {}}
        order = "desc" if reversed_order else "asc"
        # tie order is ALWAYS ascending _seq_no (insertion/upsert order),
        # matching the stable sorts of the embedded backends
        sort = [{"eventTimeUs": {"order": order}},
                {"_seq_no": {"order": "asc"}}]
        return query, sort

    def find_sliced(self, app_id, channel_id, start_time, until_time,
                    entity_type, entity_id, event_names,
                    target_entity_type, target_entity_id,
                    slices: int) -> Iterator[Event]:
        """Bulk scan via the PIT sliced-parallel path (global order
        preserved by the merge) — the training feed."""
        query, sort = self._build_query(
            start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id, reversed_order=False)
        for h in self._t.search_all_sliced(
                self._idx(app_id, channel_id), query, sort, slices):
            yield Event.from_json(h["_source"])

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        """$set/$unset/$delete replay on raw hit sources (same pattern
        as the SQLite/PG backends): the transport already JSON-parsed
        each `_source`, so the replay needs no per-row Event validation
        or eventTime re-parse (the stored eventTimeUs is the sort key
        AND the PropertyMap time)."""
        from .datamap import PropertyMap

        filters: list[dict] = [
            {"terms": {"event": ["$set", "$unset", "$delete"]}},
            {"term": {"entityType": entity_type}},
        ]
        time_range = {}
        if start_time is not None:
            time_range["gte"] = _time_us(start_time)
        if until_time is not None:
            time_range["lt"] = _time_us(until_time)
        if time_range:
            filters.append({"range": {"eventTimeUs": time_range}})
        sort = [{"eventTimeUs": {"order": "asc"}},
                {"_seq_no": {"order": "asc"}}]
        state: dict[str, tuple[dict, int, int]] = {}
        for h in self._t.search_all(self._idx(app_id, channel_id),
                                    {"bool": {"filter": filters}}, sort):
            src = h["_source"]
            eid = src["entityId"]
            ev = src["event"]
            t_us = int(src["eventTimeUs"])
            if ev == "$set":
                got = state.get(eid)
                if got is not None:
                    props, first, _ = got
                    props.update(src.get("properties") or {})
                    state[eid] = (props, first, t_us)
                else:
                    state[eid] = (dict(src.get("properties") or {}),
                                  t_us, t_us)
            elif ev == "$unset":
                got = state.get(eid)
                if got is not None:
                    props, first, _ = got
                    for k in src.get("properties") or {}:
                        props.pop(k, None)
                    state[eid] = (props, first, t_us)
            else:  # $delete
                state.pop(eid, None)
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        out = {
            eid: PropertyMap(props,
                             epoch + _dt.timedelta(microseconds=first),
                             epoch + _dt.timedelta(microseconds=last))
            for eid, (props, first, last) in state.items()
        }
        if required:
            req = set(required)
            out = {k: v for k, v in out.items() if req.issubset(v.keyset())}
        return out


class ESPEvents(base.PEvents):
    def __init__(self, l_events: ESLEvents):
        self._l = l_events

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        # bulk read feeding training: sliced-parallel PIT scan overlaps
        # the page round trips that serialize search_after at
        # store-of-record scale (PIO_ES_SLICES=1 restores serial)
        from ...common import envknobs

        slices = envknobs.env_int("PIO_ES_SLICES", 4, lo=1)
        if event_names is not None:
            event_names = list(event_names)  # materialize once: the
            # guard below + _build_query both consume it
            if not event_names:
                return iter(())
        if slices > 1:
            return self._l.find_sliced(
                app_id, channel_id, start_time, until_time, entity_type,
                entity_id, event_names, target_entity_type,
                target_entity_id, slices)
        return self._l.find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> None:
        self._l.insert_batch(list(events), app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int,
               channel_id: Optional[int] = None) -> None:
        self._l.delete_batch(list(event_ids), app_id, channel_id)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        return self._l.aggregate_properties(
            app_id, entity_type, channel_id, start_time, until_time,
            required)


# -- metadata ---------------------------------------------------------------


def _iso(t: Optional[_dt.datetime]) -> Optional[str]:
    return t.isoformat() if t else None


def _from_iso(s: Optional[str]) -> Optional[_dt.datetime]:
    return _dt.datetime.fromisoformat(s) if s else None


class ESApps(base.Apps):
    def __init__(self, t: _ESTransport, ns: str):
        self._t, self._idx, self._seq = t, f"{ns}_apps".lower(), f"{ns}_sequences".lower()
        t.ensure_index(self._idx)

    def insert(self, app: base.App) -> Optional[int]:
        if self.get_by_name(app.name) is not None:
            return None
        app_id = app.id if app.id > 0 else self._t.next_sequence(
            self._seq, "apps")
        if app.id > 0 and self.get(app_id) is not None:
            return None
        self._t.put_doc(self._idx, str(app_id), {
            "id": app_id, "name": app.name, "description": app.description,
        })
        return app_id

    def _decode(self, src) -> base.App:
        return base.App(src["id"], src["name"], src.get("description"))

    def get(self, app_id: int) -> Optional[base.App]:
        src = self._t.get_doc(self._idx, str(app_id))
        return self._decode(src) if src else None

    def get_by_name(self, name: str) -> Optional[base.App]:
        hits = self._t.search(
            self._idx, {"bool": {"filter": [{"term": {"name": name}}]}})
        return self._decode(hits[0]["_source"]) if hits else None

    def get_all(self) -> list[base.App]:
        hits = self._t.search(self._idx, {"match_all": {}}, size=10000)
        return sorted((self._decode(h["_source"]) for h in hits),
                      key=lambda a: a.id)

    def update(self, app: base.App) -> None:
        self._t.put_doc(self._idx, str(app.id), {
            "id": app.id, "name": app.name, "description": app.description,
        })

    def delete(self, app_id: int) -> None:
        self._t.delete_doc(self._idx, str(app_id))


class ESAccessKeys(base.AccessKeys):
    def __init__(self, t: _ESTransport, ns: str):
        self._t, self._idx = t, f"{ns}_accesskeys".lower()
        t.ensure_index(self._idx)

    def insert(self, k: base.AccessKey) -> Optional[str]:
        key = k.key or base.new_access_key()
        if self.get(key) is not None:
            return None
        self._t.put_doc(self._idx, key, {
            "key": key, "appid": k.appid, "events": list(k.events)})
        return key

    def _decode(self, src) -> base.AccessKey:
        return base.AccessKey(src["key"], src["appid"],
                              tuple(src.get("events") or ()))

    def get(self, key: str) -> Optional[base.AccessKey]:
        src = self._t.get_doc(self._idx, key)
        return self._decode(src) if src else None

    def get_all(self) -> list[base.AccessKey]:
        hits = self._t.search(self._idx, {"match_all": {}}, size=10000)
        return [self._decode(h["_source"]) for h in hits]

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        hits = self._t.search(
            self._idx, {"bool": {"filter": [{"term": {"appid": appid}}]}},
            size=10000)
        return [self._decode(h["_source"]) for h in hits]

    def update(self, k: base.AccessKey) -> None:
        self._t.put_doc(self._idx, k.key, {
            "key": k.key, "appid": k.appid, "events": list(k.events)})

    def delete(self, key: str) -> None:
        self._t.delete_doc(self._idx, key)


class ESChannels(base.Channels):
    def __init__(self, t: _ESTransport, ns: str):
        self._t, self._idx = t, f"{ns}_channels".lower()
        self._seq = f"{ns}_sequences".lower()
        t.ensure_index(self._idx)

    def insert(self, channel: base.Channel) -> Optional[int]:
        if not base.Channel.is_valid_name(channel.name):
            return None
        cid = channel.id if channel.id > 0 else self._t.next_sequence(
            self._seq, "channels")
        if channel.id > 0 and self.get(cid) is not None:
            return None
        self._t.put_doc(self._idx, str(cid), {
            "id": cid, "name": channel.name, "appid": channel.appid})
        return cid

    def get(self, channel_id: int) -> Optional[base.Channel]:
        src = self._t.get_doc(self._idx, str(channel_id))
        return base.Channel(src["id"], src["name"], src["appid"]) if src else None

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        hits = self._t.search(
            self._idx, {"bool": {"filter": [{"term": {"appid": appid}}]}},
            size=10000)
        return [base.Channel(h["_source"]["id"], h["_source"]["name"],
                             h["_source"]["appid"]) for h in hits]

    def delete(self, channel_id: int) -> None:
        self._t.delete_doc(self._idx, str(channel_id))


class ESEngineInstances(base.EngineInstances):
    def __init__(self, t: _ESTransport, ns: str):
        self._t, self._idx = t, f"{ns}_engineinstances".lower()
        self._seq = f"{ns}_sequences".lower()
        t.ensure_index(self._idx)

    def _encode(self, i: base.EngineInstance) -> dict:
        return {
            "id": i.id, "status": i.status,
            "startTime": _iso(i.start_time), "endTime": _iso(i.end_time),
            "engineId": i.engine_id, "engineVersion": i.engine_version,
            "engineVariant": i.engine_variant,
            "engineFactory": i.engine_factory, "batch": i.batch,
            "env": dict(i.env), "runtimeConf": dict(i.runtime_conf),
            "dataSourceParams": i.data_source_params,
            "preparatorParams": i.preparator_params,
            "algorithmsParams": i.algorithms_params,
            "servingParams": i.serving_params,
        }

    def _decode(self, s: dict) -> base.EngineInstance:
        return base.EngineInstance(
            id=s["id"], status=s["status"],
            start_time=_from_iso(s.get("startTime")),
            end_time=_from_iso(s.get("endTime")),
            engine_id=s.get("engineId", ""),
            engine_version=s.get("engineVersion", ""),
            engine_variant=s.get("engineVariant", ""),
            engine_factory=s.get("engineFactory", ""),
            batch=s.get("batch", ""), env=s.get("env") or {},
            runtime_conf=s.get("runtimeConf") or {},
            data_source_params=s.get("dataSourceParams", ""),
            preparator_params=s.get("preparatorParams", ""),
            algorithms_params=s.get("algorithmsParams", ""),
            serving_params=s.get("servingParams", ""),
        )

    def insert(self, i: base.EngineInstance) -> str:
        iid = i.id or f"EI-{self._t.next_sequence(self._seq, 'engine_instances'):08d}"
        stored = self._encode(i)
        stored["id"] = iid
        self._t.put_doc(self._idx, iid, stored)
        return iid

    def get(self, instance_id: str) -> Optional[base.EngineInstance]:
        src = self._t.get_doc(self._idx, instance_id)
        return self._decode(src) if src else None

    def get_all(self) -> list[base.EngineInstance]:
        hits = self._t.search(self._idx, {"match_all": {}}, size=10000)
        return [self._decode(h["_source"]) for h in hits]

    def get_completed(self, engine_id, engine_version, engine_variant):
        hits = self._t.search(self._idx, {"bool": {"filter": [
            {"term": {"status": "COMPLETED"}},
            {"term": {"engineId": engine_id}},
            {"term": {"engineVersion": engine_version}},
            {"term": {"engineVariant": engine_variant}},
        ]}}, size=10000)
        out = [self._decode(h["_source"]) for h in hits]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: base.EngineInstance) -> None:
        self._t.put_doc(self._idx, i.id, self._encode(i))

    def delete(self, instance_id: str) -> None:
        self._t.delete_doc(self._idx, instance_id)


class ESEvaluationInstances(base.EvaluationInstances):
    def __init__(self, t: _ESTransport, ns: str):
        self._t, self._idx = t, f"{ns}_evaluationinstances".lower()
        self._seq = f"{ns}_sequences".lower()
        t.ensure_index(self._idx)

    def _encode(self, i: base.EvaluationInstance) -> dict:
        return {
            "id": i.id, "status": i.status,
            "startTime": _iso(i.start_time), "endTime": _iso(i.end_time),
            "evaluationClass": i.evaluation_class,
            "engineParamsGeneratorClass": i.engine_params_generator_class,
            "batch": i.batch, "env": dict(i.env),
            "evaluatorResults": i.evaluator_results,
            "evaluatorResultsHTML": i.evaluator_results_html,
            "evaluatorResultsJSON": i.evaluator_results_json,
        }

    def _decode(self, s: dict) -> base.EvaluationInstance:
        return base.EvaluationInstance(
            id=s["id"], status=s["status"],
            start_time=_from_iso(s.get("startTime")),
            end_time=_from_iso(s.get("endTime")),
            evaluation_class=s.get("evaluationClass", ""),
            engine_params_generator_class=s.get(
                "engineParamsGeneratorClass", ""),
            batch=s.get("batch", ""), env=s.get("env") or {},
            evaluator_results=s.get("evaluatorResults", ""),
            evaluator_results_html=s.get("evaluatorResultsHTML", ""),
            evaluator_results_json=s.get("evaluatorResultsJSON", ""),
        )

    def insert(self, i: base.EvaluationInstance) -> str:
        iid = i.id or f"EVI-{self._t.next_sequence(self._seq, 'eval_instances'):08d}"
        stored = self._encode(i)
        stored["id"] = iid
        self._t.put_doc(self._idx, iid, stored)
        return iid

    def get(self, instance_id: str) -> Optional[base.EvaluationInstance]:
        src = self._t.get_doc(self._idx, instance_id)
        return self._decode(src) if src else None

    def get_all(self) -> list[base.EvaluationInstance]:
        hits = self._t.search(self._idx, {"match_all": {}}, size=10000)
        return [self._decode(h["_source"]) for h in hits]

    def get_completed(self) -> list[base.EvaluationInstance]:
        hits = self._t.search(self._idx, {"bool": {"filter": [
            {"term": {"status": "EVALCOMPLETED"}}]}}, size=10000)
        out = [self._decode(h["_source"]) for h in hits]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def update(self, i: base.EvaluationInstance) -> None:
        self._t.put_doc(self._idx, i.id, self._encode(i))

    def delete(self, instance_id: str) -> None:
        self._t.delete_doc(self._idx, instance_id)


class ESClient(base.BaseStorageClient):
    """`TYPE=ELASTICSEARCH`; properties HOSTS (host or full URL), PORTS
    (default 9200), USERNAME/PASSWORD (optional basic auth). Serves
    metadata + eventdata, mirroring the reference's ES assembly scope."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        p = config.properties
        host = (p.get("HOSTS") or "").split(",")[0].strip()
        if not host:
            raise ValueError(
                "ELASTICSEARCH source needs PIO_STORAGE_SOURCES_<NAME>_HOSTS")
        port = (p.get("PORTS") or "9200").split(",")[0].strip()
        endpoint = host if "://" in host else f"http://{host}:{port}"
        self._transport = _ESTransport(
            endpoint, username=p.get("USERNAME", ""),
            password=p.get("PASSWORD", ""),
            policy=resilience.policy_from_props(p),
            breaker=resilience.breaker_from_props(p, f"es:{endpoint}"))
        base.check_reachable(endpoint, "Elasticsearch")
        self._daos: dict = {}

    def breaker_states(self) -> list[dict]:
        return [self._transport.breaker.snapshot()]

    def _dao(self, cls, namespace: str):
        # metadata DAO constructors ensure their index (a network round
        # trip); cache per (class, ns) so per-request registry accessors
        # don't repeat it
        key = (cls, namespace)
        dao = self._daos.get(key)
        if dao is None:
            dao = self._daos[key] = cls(self._transport, namespace)
        return dao

    def apps(self, namespace: str = "pio_metadata"):
        return self._dao(ESApps, namespace)

    def access_keys(self, namespace: str = "pio_metadata"):
        return self._dao(ESAccessKeys, namespace)

    def channels(self, namespace: str = "pio_metadata"):
        return self._dao(ESChannels, namespace)

    def engine_instances(self, namespace: str = "pio_metadata"):
        return self._dao(ESEngineInstances, namespace)

    def evaluation_instances(self, namespace: str = "pio_metadata"):
        return self._dao(ESEvaluationInstances, namespace)

    def l_events(self, namespace: str = "pio_eventdata"):
        return self._dao(ESLEvents, namespace)

    def p_events(self, namespace: str = "pio_eventdata"):
        return ESPEvents(self.l_events(namespace))
