"""PostgreSQL backend — the `PGSQL` source type (all three repositories).

The port's own copy of ``incubator_predictionio_tpu/data/storage/postgres.py``; the wire
bytes and the tables are the reference's, so either package reads a store
the other wrote.

Reference: storage/jdbc/.../{JDBCLEvents,JDBCPEvents,JDBCModels,JDBCApps,
JDBCAccessKeys,JDBCChannels,JDBCEngineInstances,JDBCEvaluationInstances,
JDBCUtils} (SURVEY.md §2.1): a full alternative backend on a network SQL
database. No SQL driver ships in this distribution, so the connection is
data/storage/pgwire.py — the Postgres wire protocol spoken directly
(extended query protocol: parameters never interpolate into SQL text).

    PIO_STORAGE_SOURCES_PG_TYPE=PGSQL
    PIO_STORAGE_SOURCES_PG_HOST=db-host      PORT=5432
    PIO_STORAGE_SOURCES_PG_USERNAME=pio      PASSWORD=...
    PIO_STORAGE_SOURCES_PG_DATABASE=pio

Schema notes: event/metadata times are stored as BIGINT epoch
microseconds (UTC), events keep their full wire JSON alongside the
filterable columns, and the cross-backend event tie-order contract rides
a monotone ``seq`` column (client-side counter, event.MonotoneNs) — an
upsert is one atomic INSERT ... ON CONFLICT DO UPDATE that assigns a
fresh seq, moving the event to the END of its equal-timestamp group like
every other backend; bulk ingest rides multi-row INSERTs. Generated
METADATA ids use MAX(id)+1 inside the insert statement; metadata writes
are low-rate and the storage layer serializes per-process access (the
reference's JDBCUtils generated keys carry the same caveat).
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import warnings
from typing import Iterable, Iterator, Optional, Sequence

from . import base
from .event import (Event, MonotoneNs,
                    event_time_us as _time_us, new_event_id)
from .pgwire import PGConnection, PGError
from .sqlite import _safe_ident


def _stream_fetch_size() -> int:
    """PIO_PG_FETCH_SIZE (rows per portal chunk of the streaming
    training feed), parsed once; malformed values warn and fall back."""
    from ...common import envknobs

    return envknobs.env_int("PIO_PG_FETCH_SIZE", 5000, lo=1, warn=True)


def _from_us(us) -> Optional[_dt.datetime]:
    if us is None:
        return None
    return _dt.datetime.fromtimestamp(int(us) / 1_000_000, _dt.timezone.utc)


class PGLEvents(base.LEvents):
    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_events".lower()
        # client-side monotone seq (tie order): a MAX(seq)+1 subquery per
        # insert would full-scan without a dedicated index and still race
        # across writers; the client counter costs zero queries per
        # insert and is PRIMED from the store's committed maximum below,
        # so a wall clock stepped backwards between restarts cannot
        # order an upsert below its existing tie group
        self._seq = MonotoneNs()
        self._ensure()
        _, rows = self._c.query(
            f"SELECT COALESCE(MAX(seq),0) FROM {self._t}")
        self._seq.prime(int(rows[0][0]))

    def _ensure(self):
        self._c.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "  appid BIGINT NOT NULL,"
            "  channelid BIGINT NOT NULL,"
            "  eventid TEXT NOT NULL,"
            "  seq BIGINT NOT NULL,"
            "  event TEXT NOT NULL,"
            "  entitytype TEXT NOT NULL,"
            "  entityid TEXT NOT NULL,"
            "  targetentitytype TEXT,"
            "  targetentityid TEXT,"
            "  eventtimeus BIGINT NOT NULL,"
            "  eventjson TEXT NOT NULL,"
            "  PRIMARY KEY (appid, channelid, eventid))")
        self._c.query(
            f"CREATE INDEX IF NOT EXISTS {self._t}_time "
            f"ON {self._t} (appid, channelid, eventtimeus, seq)")
        # serves the one-time MAX(seq) startup seed of the client-side
        # sequence counter (an unindexed MAX would full-scan)
        self._c.query(
            f"CREATE INDEX IF NOT EXISTS {self._t}_seq ON {self._t} (seq)")

    @staticmethod
    def _chan(channel_id: Optional[int]) -> int:
        return int(channel_id) if channel_id is not None else 0

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._ensure()
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._c.query(
            f"DELETE FROM {self._t} WHERE appid=$1 AND channelid=$2",
            (app_id, self._chan(channel_id)))
        return True

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        eid = event.event_id or new_event_id()
        stored = event.with_event_id(eid)
        chan = self._chan(channel_id)
        # Atomic upsert: the fresh seq moves the event to the END of its
        # equal-timestamp tie group (cross-backend contract). One
        # statement, so a crash never loses the event and a concurrent
        # duplicate id upserts instead of erroring.
        self._c.query(
            self._INSERT_SQL + " ON CONFLICT (appid, channelid, eventid)"
            " DO UPDATE SET"
            " seq=excluded.seq, event=excluded.event,"
            " entitytype=excluded.entitytype, entityid=excluded.entityid,"
            " targetentitytype=excluded.targetentitytype,"
            " targetentityid=excluded.targetentityid,"
            " eventtimeus=excluded.eventtimeus, eventjson=excluded.eventjson",
            (app_id, chan, eid, self._seq.next()) + self._row_tail(stored))
        return eid

    @property
    def _INSERT_SQL(self) -> str:
        return (f"INSERT INTO {self._t} (appid, channelid, eventid, seq,"
                " event, entitytype, entityid, targetentitytype,"
                " targetentityid, eventtimeus, eventjson)"
                " VALUES ($1,$2,$3,$4,$5,$6,$7,$8,$9,$10,$11)")

    @staticmethod
    def _row_tail(stored: Event) -> tuple:
        return (stored.event, stored.entity_type, stored.entity_id,
                stored.target_entity_type, stored.target_entity_id,
                _time_us(stored.event_time), json.dumps(stored.to_json()))

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> list[str]:
        """Bulk ingest: fresh-uuid events (no possible conflict) ride
        multi-row INSERTs in chunks; client-supplied ids take the
        per-event upsert path."""
        chan = self._chan(channel_id)
        ids: list[str] = []
        CHUNK = 200  # 11 params/row, well under the 65535 bind limit
        fresh: list[Event] = []

        def flush():
            if not fresh:
                return
            cols = ("(appid, channelid, eventid, seq, event, entitytype,"
                    " entityid, targetentitytype, targetentityid,"
                    " eventtimeus, eventjson)")
            rows_sql, params = [], []
            for e in fresh:
                b = len(params)
                rows_sql.append(
                    "(" + ",".join(f"${b + j}" for j in range(1, 12)) + ")")
                params.extend((app_id, chan, e.event_id, self._seq.next())
                              + self._row_tail(e))
            self._c.query(
                f"INSERT INTO {self._t} {cols} VALUES "
                + ",".join(rows_sql), params)
            fresh.clear()

        for e in events:
            if e.event_id:
                flush()
                ids.append(self.insert(e, app_id, channel_id))
            else:
                eid = new_event_id()
                fresh.append(e.with_event_id(eid))
                ids.append(eid)
                if len(fresh) >= CHUNK:
                    flush()
        flush()
        return ids

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        _, rows = self._c.query(
            f"SELECT eventjson FROM {self._t} "
            "WHERE appid=$1 AND channelid=$2 AND eventid=$3",
            (app_id, self._chan(channel_id), event_id))
        if not rows:
            return None
        return Event.from_json(json.loads(rows[0][0]))

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        _, rows = self._c.query(
            f"DELETE FROM {self._t} "
            "WHERE appid=$1 AND channelid=$2 AND eventid=$3 "
            "RETURNING eventid",
            (app_id, self._chan(channel_id), event_id))
        return bool(rows)

    def _delete_chunk(self, chunk: Sequence[str], app_id: int,
                      chan: int) -> set[str]:
        """Delete one IN-list chunk, returning the ids actually removed.
        MySQL overrides this (no DELETE..RETURNING in its dialect)."""
        ph = ",".join(f"${j}" for j in range(3, 3 + len(chunk)))
        _, rows = self._c.query(
            f"DELETE FROM {self._t} WHERE appid=$1 AND channelid=$2 "
            f"AND eventid IN ({ph}) RETURNING eventid",
            (app_id, chan, *chunk))
        return {r[0] for r in rows}

    def delete_batch(self, event_ids: Sequence[str], app_id: int,
                     channel_id: Optional[int] = None) -> list[bool]:
        """Chunked IN-list deletes: one round trip per ~500 ids instead
        of one per id (self-cleaning compaction deletes thousands at a
        time; the per-event default made the wire RTT the whole cost)."""
        chan = self._chan(channel_id)
        found: set[str] = set()
        CHUNK = 500
        ids = list(event_ids)
        for lo in range(0, len(ids), CHUNK):
            found.update(self._delete_chunk(ids[lo:lo + CHUNK], app_id, chan))
        # Repeated ids in the request: only the first occurrence reports
        # True (matches the per-event loop's delete-then-miss behavior).
        out = []
        for eid in ids:
            hit = eid in found
            if hit:
                found.discard(eid)
            out.append(hit)
        return out

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
        stream: bool = False,
    ) -> Iterator[Event]:
        """``stream=True`` pages rows through a suspended portal
        (pgwire.query_stream) instead of materializing the result —
        the event-store-of-record training feed at 20M events. The
        lock is held per chunk, NOT across the iteration: an
        interleaved query on this client proceeds, destroys the
        suspended portal, and the stream's next chunk raises PGError
        34000 — finish or close() the iterator before other queries.
        PEvents.find is the intended streaming caller."""
        where = ["appid=$1", "channelid=$2"]
        params: list = [app_id, self._chan(channel_id)]

        def arg(v):
            params.append(v)
            return f"${len(params)}"

        if start_time is not None:
            where.append(f"eventtimeus >= {arg(_time_us(start_time))}")
        if until_time is not None:
            where.append(f"eventtimeus < {arg(_time_us(until_time))}")
        if entity_type is not None:
            where.append(f"entitytype = {arg(entity_type)}")
        if entity_id is not None:
            where.append(f"entityid = {arg(entity_id)}")
        if target_entity_type is not None:
            where.append(f"targetentitytype = {arg(target_entity_type)}")
        if target_entity_id is not None:
            where.append(f"targetentityid = {arg(target_entity_id)}")
        if event_names is not None:
            if not list(event_names):
                return iter(())
            slots = ",".join(arg(n) for n in event_names)
            where.append(f"event IN ({slots})")
        order = "DESC" if reversed_order else "ASC"
        sql = (f"SELECT eventjson FROM {self._t} WHERE "
               + " AND ".join(where)
               + f" ORDER BY eventtimeus {order}, seq ASC")
        if limit is not None and limit >= 0:
            sql += f" LIMIT {arg(int(limit))}"
        if stream and hasattr(self._c, "query_stream"):
            return (Event.from_json(json.loads(r[0]))
                    for r in self._c.query_stream(
                        sql, params, fetch_size=_stream_fetch_size()))
        _, rows = self._c.query(sql, params)
        return (Event.from_json(json.loads(r[0])) for r in rows)


    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        """$set/$unset/$delete replay from raw rows (same pattern as the
        SQLite backend): only each row's eventjson is parsed for its
        properties — no per-row Event validation — and the ordering is
        the same (eventtimeus, seq) the generic find() replay sorts by.
        """
        from .datamap import PropertyMap

        where = ["appid=$1", "channelid=$2",
                 "event IN ('$set','$unset','$delete')"]
        params: list = [app_id, self._chan(channel_id)]

        def arg(v):
            params.append(v)
            return f"${len(params)}"

        if entity_type is not None:
            where.append(f"entitytype = {arg(entity_type)}")
        if start_time is not None:
            where.append(f"eventtimeus >= {arg(_time_us(start_time))}")
        if until_time is not None:
            where.append(f"eventtimeus < {arg(_time_us(until_time))}")
        sql = (f"SELECT entityid, event, eventjson, eventtimeus FROM "
               f"{self._t} WHERE " + " AND ".join(where)
               + " ORDER BY eventtimeus ASC, seq ASC")
        _, rows = self._c.query(sql, params)

        state: dict[str, tuple[dict, int, int]] = {}
        for eid, ev, ej, t_us in rows:
            t_us = int(t_us)
            if ev == "$set":
                d = json.loads(ej).get("properties") or {}
                got = state.get(eid)
                if got is not None:
                    props, first, _ = got
                    props.update(d)
                    state[eid] = (props, first, t_us)
                else:
                    state[eid] = (d, t_us, t_us)
            elif ev == "$unset":
                got = state.get(eid)
                if got is not None:
                    props, first, _ = got
                    for k in json.loads(ej).get("properties") or {}:
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


class PGPEvents(base.PEvents):
    def __init__(self, l_events: PGLEvents):
        self._l = l_events

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        # bulk read API feeding training: stream through a suspended
        # portal — 20M events must not materialize as one Python list
        return self._l.find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
            stream=True,
        )

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> None:
        self._l.insert_batch(list(events), app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int,
               channel_id: Optional[int] = None) -> None:
        for eid in event_ids:
            self._l.delete(eid, app_id, channel_id)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        return self._l.aggregate_properties(
            app_id, entity_type, channel_id, start_time, until_time,
            required)


class PGApps(base.Apps):
    #: Wire exception type; MySQL subclasses swap in MySQLError so the
    #: inherited DAO bodies catch their own transport's errors.
    _WIRE_ERROR = PGError

    @staticmethod
    def _is_duplicate(e) -> bool:
        """Exactly a unique/duplicate-key violation — NOT the broader
        integrity class (not-null/FK/check must surface, not read as
        "already exists"). PG: sqlstate 23505; MySQL override: errno
        1062."""
        return e.sqlstate == "23505"

    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_apps".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id BIGINT PRIMARY KEY, name TEXT NOT NULL UNIQUE,"
            " description TEXT)")

    def insert(self, app: base.App) -> Optional[int]:
        if self.get_by_name(app.name) is not None:
            return None
        try:
            if app.id > 0:
                _, rows = self._c.query(
                    f"INSERT INTO {self._t} (id, name, description) "
                    "VALUES ($1,$2,$3) RETURNING id",
                    (app.id, app.name, app.description))
            else:
                _, rows = self._c.query(
                    f"INSERT INTO {self._t} (id, name, description) VALUES "
                    f"((SELECT COALESCE(MAX(id),0)+1 FROM {self._t}),"
                    "$1,$2) RETURNING id",
                    (app.name, app.description))
        except self._WIRE_ERROR as e:
            if self._is_duplicate(e):
                return None
            raise
        return int(rows[0][0])

    def _row(self, r) -> base.App:
        return base.App(int(r[0]), r[1], r[2])

    def get(self, app_id: int) -> Optional[base.App]:
        _, rows = self._c.query(
            f"SELECT id, name, description FROM {self._t} WHERE id=$1",
            (app_id,))
        return self._row(rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[base.App]:
        _, rows = self._c.query(
            f"SELECT id, name, description FROM {self._t} WHERE name=$1",
            (name,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[base.App]:
        _, rows = self._c.query(
            f"SELECT id, name, description FROM {self._t} ORDER BY id")
        return [self._row(r) for r in rows]

    def update(self, app: base.App) -> None:
        self._c.query(
            f"UPDATE {self._t} SET name=$1, description=$2 WHERE id=$3",
            (app.name, app.description, app.id))

    def delete(self, app_id: int) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (app_id,))


class PGAccessKeys(base.AccessKeys):
    _WIRE_ERROR = PGError
    _is_duplicate = PGApps.__dict__["_is_duplicate"]

    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_accesskeys".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "accesskey TEXT PRIMARY KEY, appid BIGINT NOT NULL, events TEXT)")

    def insert(self, k: base.AccessKey) -> Optional[str]:
        key = k.key or base.new_access_key()
        try:
            self._c.query(
                f"INSERT INTO {self._t} (accesskey, appid, events) "
                "VALUES ($1,$2,$3)",
                (key, k.appid, json.dumps(list(k.events))))
        except self._WIRE_ERROR as e:
            if self._is_duplicate(e):
                return None
            raise
        return key

    def _row(self, r) -> base.AccessKey:
        return base.AccessKey(r[0], int(r[1]),
                              tuple(json.loads(r[2]) if r[2] else ()))

    def get(self, key: str) -> Optional[base.AccessKey]:
        _, rows = self._c.query(
            f"SELECT accesskey, appid, events FROM {self._t} "
            "WHERE accesskey=$1", (key,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[base.AccessKey]:
        _, rows = self._c.query(
            f"SELECT accesskey, appid, events FROM {self._t}")
        return [self._row(r) for r in rows]

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        _, rows = self._c.query(
            f"SELECT accesskey, appid, events FROM {self._t} WHERE appid=$1",
            (appid,))
        return [self._row(r) for r in rows]

    def update(self, k: base.AccessKey) -> None:
        self._c.query(
            f"UPDATE {self._t} SET appid=$1, events=$2 WHERE accesskey=$3",
            (k.appid, json.dumps(list(k.events)), k.key))

    def delete(self, key: str) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE accesskey=$1", (key,))


class PGChannels(base.Channels):
    _WIRE_ERROR = PGError
    _is_duplicate = PGApps.__dict__["_is_duplicate"]

    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_channels".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id BIGINT PRIMARY KEY, name TEXT NOT NULL, appid BIGINT NOT NULL)")

    def insert(self, channel: base.Channel) -> Optional[int]:
        if not base.Channel.is_valid_name(channel.name):
            return None
        try:
            if channel.id > 0:
                _, rows = self._c.query(
                    f"INSERT INTO {self._t} (id, name, appid) "
                    "VALUES ($1,$2,$3) RETURNING id",
                    (channel.id, channel.name, channel.appid))
            else:
                _, rows = self._c.query(
                    f"INSERT INTO {self._t} (id, name, appid) VALUES "
                    f"((SELECT COALESCE(MAX(id),0)+1 FROM {self._t}),"
                    "$1,$2) RETURNING id",
                    (channel.name, channel.appid))
        except self._WIRE_ERROR as e:
            if self._is_duplicate(e):
                return None
            raise
        return int(rows[0][0])

    def get(self, channel_id: int) -> Optional[base.Channel]:
        _, rows = self._c.query(
            f"SELECT id, name, appid FROM {self._t} WHERE id=$1",
            (channel_id,))
        return (base.Channel(int(rows[0][0]), rows[0][1], int(rows[0][2]))
                if rows else None)

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        _, rows = self._c.query(
            f"SELECT id, name, appid FROM {self._t} WHERE appid=$1",
            (appid,))
        return [base.Channel(int(r[0]), r[1], int(r[2])) for r in rows]

    def delete(self, channel_id: int) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (channel_id,))


class PGEngineInstances(base.EngineInstances):
    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_engineinstances".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id TEXT PRIMARY KEY, status TEXT, starttimeus BIGINT,"
            " engineid TEXT, engineversion TEXT, enginevariant TEXT,"
            " doc TEXT NOT NULL)")

    @staticmethod
    def _encode(i: base.EngineInstance) -> str:
        return json.dumps({
            "id": i.id, "status": i.status,
            "startTimeUs": _time_us(i.start_time) if i.start_time else None,
            "endTimeUs": _time_us(i.end_time) if i.end_time else None,
            "engineId": i.engine_id, "engineVersion": i.engine_version,
            "engineVariant": i.engine_variant,
            "engineFactory": i.engine_factory, "batch": i.batch,
            "env": dict(i.env), "runtimeConf": dict(i.runtime_conf),
            "dataSourceParams": i.data_source_params,
            "preparatorParams": i.preparator_params,
            "algorithmsParams": i.algorithms_params,
            "servingParams": i.serving_params,
        })

    @staticmethod
    def _decode(doc: str) -> base.EngineInstance:
        s = json.loads(doc)
        return base.EngineInstance(
            id=s["id"], status=s["status"],
            start_time=_from_us(s.get("startTimeUs")),
            end_time=_from_us(s.get("endTimeUs")),
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

    def _put(self, iid: str, i: base.EngineInstance) -> None:
        stored = base.EngineInstance(**{**i.__dict__, "id": iid})
        self._c.query(
            f"DELETE FROM {self._t} WHERE id=$1", (iid,))
        self._c.query(
            f"INSERT INTO {self._t} (id, status, starttimeus, engineid,"
            " engineversion, enginevariant, doc) VALUES ($1,$2,$3,$4,$5,$6,$7)",
            (iid, stored.status,
             _time_us(stored.start_time) if stored.start_time else None,
             stored.engine_id, stored.engine_version, stored.engine_variant,
             self._encode(stored)))

    def insert(self, i: base.EngineInstance) -> str:
        import uuid

        iid = i.id or uuid.uuid4().hex
        self._put(iid, i)
        return iid

    def get(self, instance_id: str) -> Optional[base.EngineInstance]:
        _, rows = self._c.query(
            f"SELECT doc FROM {self._t} WHERE id=$1", (instance_id,))
        return self._decode(rows[0][0]) if rows else None

    def get_all(self) -> list[base.EngineInstance]:
        _, rows = self._c.query(f"SELECT doc FROM {self._t}")
        return [self._decode(r[0]) for r in rows]

    def get_completed(self, engine_id, engine_version, engine_variant):
        _, rows = self._c.query(
            f"SELECT doc FROM {self._t} WHERE status='COMPLETED' AND "
            "engineid=$1 AND engineversion=$2 AND enginevariant=$3 "
            "ORDER BY starttimeus DESC",
            (engine_id, engine_version, engine_variant))
        return [self._decode(r[0]) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: base.EngineInstance) -> None:
        self._put(i.id, i)

    def delete(self, instance_id: str) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (instance_id,))


class PGEvaluationInstances(base.EvaluationInstances):
    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_evaluationinstances".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id TEXT PRIMARY KEY, status TEXT, starttimeus BIGINT,"
            " doc TEXT NOT NULL)")

    @staticmethod
    def _encode(i: base.EvaluationInstance) -> str:
        return json.dumps({
            "id": i.id, "status": i.status,
            "startTimeUs": _time_us(i.start_time) if i.start_time else None,
            "endTimeUs": _time_us(i.end_time) if i.end_time else None,
            "evaluationClass": i.evaluation_class,
            "engineParamsGeneratorClass": i.engine_params_generator_class,
            "batch": i.batch, "env": dict(i.env),
            "evaluatorResults": i.evaluator_results,
            "evaluatorResultsHTML": i.evaluator_results_html,
            "evaluatorResultsJSON": i.evaluator_results_json,
        })

    @staticmethod
    def _decode(doc: str) -> base.EvaluationInstance:
        s = json.loads(doc)
        return base.EvaluationInstance(
            id=s["id"], status=s["status"],
            start_time=_from_us(s.get("startTimeUs")),
            end_time=_from_us(s.get("endTimeUs")),
            evaluation_class=s.get("evaluationClass", ""),
            engine_params_generator_class=s.get(
                "engineParamsGeneratorClass", ""),
            batch=s.get("batch", ""), env=s.get("env") or {},
            evaluator_results=s.get("evaluatorResults", ""),
            evaluator_results_html=s.get("evaluatorResultsHTML", ""),
            evaluator_results_json=s.get("evaluatorResultsJSON", ""),
        )

    def _put(self, iid: str, i: base.EvaluationInstance) -> None:
        stored = base.EvaluationInstance(**{**i.__dict__, "id": iid})
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (iid,))
        self._c.query(
            f"INSERT INTO {self._t} (id, status, starttimeus, doc) "
            "VALUES ($1,$2,$3,$4)",
            (iid, stored.status,
             _time_us(stored.start_time) if stored.start_time else None,
             self._encode(stored)))

    def insert(self, i: base.EvaluationInstance) -> str:
        import uuid

        iid = i.id or uuid.uuid4().hex
        self._put(iid, i)
        return iid

    def get(self, instance_id: str) -> Optional[base.EvaluationInstance]:
        _, rows = self._c.query(
            f"SELECT doc FROM {self._t} WHERE id=$1", (instance_id,))
        return self._decode(rows[0][0]) if rows else None

    def get_all(self) -> list[base.EvaluationInstance]:
        _, rows = self._c.query(f"SELECT doc FROM {self._t}")
        return [self._decode(r[0]) for r in rows]

    def get_completed(self) -> list[base.EvaluationInstance]:
        _, rows = self._c.query(
            f"SELECT doc FROM {self._t} WHERE status='EVALCOMPLETED' "
            "ORDER BY starttimeus DESC")
        return [self._decode(r[0]) for r in rows]

    def update(self, i: base.EvaluationInstance) -> None:
        self._put(i.id, i)

    def delete(self, instance_id: str) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (instance_id,))


class PGModels(base.Models):
    def __init__(self, conn: PGConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_models".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id TEXT PRIMARY KEY, models BYTEA NOT NULL)")

    def insert(self, model: base.Model) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (model.id,))
        self._c.query(
            f"INSERT INTO {self._t} (id, models) VALUES ($1,$2)",
            (model.id, bytes(model.models)))

    def get(self, model_id: str) -> Optional[base.Model]:
        _, rows = self._c.query(
            f"SELECT models FROM {self._t} WHERE id=$1", (model_id,))
        if not rows:
            return None
        blob = rows[0][0]
        if isinstance(blob, str):
            blob = blob.encode()
        return base.Model(model_id, blob)

    def delete(self, model_id: str) -> None:
        self._c.query(f"DELETE FROM {self._t} WHERE id=$1", (model_id,))


class PGClient(base.BaseStorageClient):
    """`TYPE=PGSQL`; properties HOST (default 127.0.0.1), PORT (5432),
    USERNAME, PASSWORD, DATABASE (default = username). Serves all three
    repositories, like the reference's JDBC assembly."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        p = config.properties
        user = p.get("USERNAME", "pio")
        self._conn = PGConnection(
            host=p.get("HOST", "127.0.0.1"),
            port=int(p.get("PORT", "5432")),
            user=user,
            password=p.get("PASSWORD", ""),
            database=p.get("DATABASE", user),
        )
        self._daos: dict = {}

    def _dao(self, cls, namespace: str):
        # DAO constructors run DDL round trips; cache per (class, ns) so
        # per-request registry accessors don't repeat them on the wire.
        key = (cls, namespace)
        dao = self._daos.get(key)
        if dao is None:
            dao = self._daos[key] = cls(self._conn, namespace)
        return dao

    def apps(self, namespace: str = "pio_metadata"):
        return self._dao(PGApps, namespace)

    def access_keys(self, namespace: str = "pio_metadata"):
        return self._dao(PGAccessKeys, namespace)

    def channels(self, namespace: str = "pio_metadata"):
        return self._dao(PGChannels, namespace)

    def engine_instances(self, namespace: str = "pio_metadata"):
        return self._dao(PGEngineInstances, namespace)

    def evaluation_instances(self, namespace: str = "pio_metadata"):
        return self._dao(PGEvaluationInstances, namespace)

    def models(self, namespace: str = "pio_modeldata"):
        return self._dao(PGModels, namespace)

    def l_events(self, namespace: str = "pio_eventdata"):
        return self._dao(PGLEvents, namespace)

    def p_events(self, namespace: str = "pio_eventdata"):
        return PGPEvents(self.l_events(namespace))

    def close(self) -> None:
        self._conn.close()
