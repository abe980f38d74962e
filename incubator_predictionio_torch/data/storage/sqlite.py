"""SQLite storage backend — the `SQLITE` source type (JDBC-backend analog).

The port's own copy of ``incubator_predictionio_tpu/data/storage/sqlite.py``,
with the same table names, columns and orderings, so one ``pio.sqlite``
file is read and written by either package.

Re-design of the reference JDBC backend (reference: storage/jdbc/src/main/
scala/.../jdbc/{StorageClient,JDBCLEvents,JDBCPEvents,JDBCModels,JDBCApps,
JDBCAccessKeys,JDBCChannels,JDBCEngineInstances,JDBCEvaluationInstances,
JDBCUtils}.scala). Same shape: one relational source serving all three
repositories, tables prefixed by the repository namespace (_NAME env var),
one event table per (app, channel) named <ns>_<appId>[_<channelId>], times
stored as epoch microseconds UTC.

SQLite is the bundled zero-dependency engine; the DAO SQL is vanilla enough
that a Postgres/MySQL client could subclass with a different connection
factory (the reference's scalikejdbc role).
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import sqlite3
import threading
from typing import Iterable, Iterator, Optional, Sequence

from . import base
from .datamap import DataMap, PropertyMap
from .event import Event, new_event_id

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _to_micros(t: _dt.datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int((t - _EPOCH).total_seconds() * 1_000_000)


def _from_micros(us: int) -> _dt.datetime:
    return _EPOCH + _dt.timedelta(microseconds=us)


def _micros_or_none(t: Optional[_dt.datetime]) -> Optional[int]:
    return None if t is None else _to_micros(t)


def _dt_or_none(us: Optional[int]) -> Optional[_dt.datetime]:
    return None if us is None else _from_micros(us)


class SQLiteClient(base.BaseStorageClient):
    """`TYPE=SQLITE`; property PATH = database file (":memory:" allowed)."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("PATH", "pio.sqlite")
        if path != ":memory:" and os.path.dirname(path):
            # sqlite3 does not create the file's parent directories
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
        self._daos: dict[tuple[str, str], object] = {}

    def _dao(self, kind: str, namespace: str, factory):
        # Cache per (kind, namespace): DAO constructors run DDL; don't
        # repeat it on every registry accessor call.
        key = (kind, namespace)
        with self._lock:
            if key not in self._daos:
                self._daos[key] = factory()
            return self._daos[key]

    # DAO accessors -------------------------------------------------------
    def apps(self, namespace: str = "pio_metadata"):
        return self._dao("apps", namespace,
                         lambda: SQLiteApps(self._conn, self._lock, namespace))

    def access_keys(self, namespace: str = "pio_metadata"):
        return self._dao("access_keys", namespace,
                         lambda: SQLiteAccessKeys(self._conn, self._lock, namespace))

    def channels(self, namespace: str = "pio_metadata"):
        return self._dao("channels", namespace,
                         lambda: SQLiteChannels(self._conn, self._lock, namespace))

    def engine_instances(self, namespace: str = "pio_metadata"):
        return self._dao("engine_instances", namespace,
                         lambda: SQLiteEngineInstances(self._conn, self._lock, namespace))

    def evaluation_instances(self, namespace: str = "pio_metadata"):
        return self._dao("evaluation_instances", namespace,
                         lambda: SQLiteEvaluationInstances(self._conn, self._lock, namespace))

    def models(self, namespace: str = "pio_modeldata"):
        return self._dao("models", namespace,
                         lambda: SQLiteModels(self._conn, self._lock, namespace))

    def l_events(self, namespace: str = "pio_eventdata"):
        return self._dao("l_events", namespace,
                         lambda: SQLiteLEvents(self._conn, self._lock, namespace))

    def p_events(self, namespace: str = "pio_eventdata"):
        return self._dao("p_events", namespace,
                         lambda: SQLitePEvents(self.l_events(namespace)))

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def _safe_ident(name: str) -> str:
    """Namespace/table identifiers come from env vars — restrict to
    [A-Za-z0-9_] (reference: JDBCUtils sanitizes the same way)."""
    if not name or not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"invalid storage namespace {name!r}")
    return name


class _Dao:
    def __init__(
        self,
        conn: sqlite3.Connection,
        lock: threading.RLock,
        namespace: str = "pio",
    ):
        self._conn = conn
        self._lock = lock
        self._ns = _safe_ident(namespace)

    def _ensure(self, ddl: str, *indexes: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(ddl)
            for ix in indexes:
                self._conn.execute(ix)


class SQLiteApps(base.Apps, _Dao):
    def __init__(self, conn, lock, namespace="pio_metadata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._t = f"{self._ns}_apps"
        self._ensure(
            f"""CREATE TABLE IF NOT EXISTS {self._t} (
                  id INTEGER PRIMARY KEY AUTOINCREMENT,
                  name TEXT NOT NULL UNIQUE,
                  description TEXT)"""
        )

    def insert(self, app: base.App) -> Optional[int]:
        with self._lock, self._conn:
            try:
                if app.id > 0:
                    cur = self._conn.execute(
                        f"INSERT INTO {self._t} (id, name, description) VALUES (?,?,?)",
                        (app.id, app.name, app.description),
                    )
                else:
                    cur = self._conn.execute(
                        f"INSERT INTO {self._t} (name, description) VALUES (?,?)",
                        (app.name, app.description),
                    )
                return cur.lastrowid
            except sqlite3.IntegrityError:
                return None

    def get(self, app_id: int) -> Optional[base.App]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id, name, description FROM {self._t} WHERE id=?", (app_id,)
            ).fetchone()
        return base.App(*row) if row else None

    def get_by_name(self, name: str) -> Optional[base.App]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id, name, description FROM {self._t} WHERE name=?", (name,)
            ).fetchone()
        return base.App(*row) if row else None

    def get_all(self) -> list[base.App]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT id, name, description FROM {self._t} ORDER BY id"
            ).fetchall()
        return [base.App(*r) for r in rows]

    def update(self, app: base.App) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                f"UPDATE {self._t} SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id),
            )

    def delete(self, app_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._t} WHERE id=?", (app_id,))


class SQLiteAccessKeys(base.AccessKeys, _Dao):
    def __init__(self, conn, lock, namespace="pio_metadata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._t = f"{self._ns}_accesskeys"
        self._ensure(
            f"""CREATE TABLE IF NOT EXISTS {self._t} (
                  accesskey TEXT PRIMARY KEY,
                  appid INTEGER NOT NULL,
                  events TEXT NOT NULL)"""
        )

    def insert(self, k: base.AccessKey) -> Optional[str]:
        import secrets

        key = k.key or secrets.token_urlsafe(48)
        with self._lock, self._conn:
            try:
                self._conn.execute(
                    f"INSERT INTO {self._t} (accesskey, appid, events) VALUES (?,?,?)",
                    (key, k.appid, json.dumps(list(k.events))),
                )
                return key
            except sqlite3.IntegrityError:
                return None

    def get(self, key: str) -> Optional[base.AccessKey]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT accesskey, appid, events FROM {self._t} WHERE accesskey=?",
                (key,),
            ).fetchone()
        return base.AccessKey(row[0], row[1], tuple(json.loads(row[2]))) if row else None

    def get_all(self) -> list[base.AccessKey]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT accesskey, appid, events FROM {self._t}"
            ).fetchall()
        return [base.AccessKey(r[0], r[1], tuple(json.loads(r[2]))) for r in rows]

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT accesskey, appid, events FROM {self._t} WHERE appid=?",
                (appid,),
            ).fetchall()
        return [base.AccessKey(r[0], r[1], tuple(json.loads(r[2]))) for r in rows]

    def update(self, k: base.AccessKey) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                f"UPDATE {self._t} SET appid=?, events=? WHERE accesskey=?",
                (k.appid, json.dumps(list(k.events)), k.key),
            )

    def delete(self, key: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._t} WHERE accesskey=?", (key,))


class SQLiteChannels(base.Channels, _Dao):
    def __init__(self, conn, lock, namespace="pio_metadata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._t = f"{self._ns}_channels"
        self._ensure(
            f"""CREATE TABLE IF NOT EXISTS {self._t} (
                  id INTEGER PRIMARY KEY AUTOINCREMENT,
                  name TEXT NOT NULL,
                  appid INTEGER NOT NULL)"""
        )

    def insert(self, channel: base.Channel) -> Optional[int]:
        if not base.Channel.is_valid_name(channel.name):
            return None
        with self._lock, self._conn:
            try:
                if channel.id > 0:
                    cur = self._conn.execute(
                        f"INSERT INTO {self._t} (id, name, appid) VALUES (?,?,?)",
                        (channel.id, channel.name, channel.appid),
                    )
                else:
                    cur = self._conn.execute(
                        f"INSERT INTO {self._t} (name, appid) VALUES (?,?)",
                        (channel.name, channel.appid),
                    )
                return cur.lastrowid
            except sqlite3.IntegrityError:
                return None

    def get(self, channel_id: int) -> Optional[base.Channel]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id, name, appid FROM {self._t} WHERE id=?", (channel_id,)
            ).fetchone()
        return base.Channel(*row) if row else None

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT id, name, appid FROM {self._t} WHERE appid=?", (appid,)
            ).fetchall()
        return [base.Channel(*r) for r in rows]

    def delete(self, channel_id: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._t} WHERE id=?", (channel_id,))


class SQLiteEngineInstances(base.EngineInstances, _Dao):
    _COLS = (
        "id,status,starttime,endtime,engineid,engineversion,enginevariant,"
        "enginefactory,batch,env,runtimeconf,datasourceparams,"
        "preparatorparams,algorithmsparams,servingparams"
    )

    def __init__(self, conn, lock, namespace="pio_metadata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._t = f"{self._ns}_engineinstances"
        self._ensure(
            f"""CREATE TABLE IF NOT EXISTS {self._t} (
                  id TEXT PRIMARY KEY,
                  status TEXT, starttime INTEGER, endtime INTEGER,
                  engineid TEXT, engineversion TEXT, enginevariant TEXT,
                  enginefactory TEXT, batch TEXT, env TEXT, runtimeconf TEXT,
                  datasourceparams TEXT, preparatorparams TEXT,
                  algorithmsparams TEXT, servingparams TEXT)"""
        )

    def _row_to_obj(self, r) -> base.EngineInstance:
        return base.EngineInstance(
            id=r[0], status=r[1], start_time=_from_micros(r[2]),
            end_time=_dt_or_none(r[3]), engine_id=r[4], engine_version=r[5],
            engine_variant=r[6], engine_factory=r[7], batch=r[8],
            env=json.loads(r[9]), runtime_conf=json.loads(r[10]),
            data_source_params=r[11], preparator_params=r[12],
            algorithms_params=r[13], serving_params=r[14],
        )

    def insert(self, i: base.EngineInstance) -> str:
        iid = i.id or new_event_id()
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {self._t} ({self._COLS}) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    iid, i.status, _to_micros(i.start_time),
                    _micros_or_none(i.end_time), i.engine_id, i.engine_version,
                    i.engine_variant, i.engine_factory, i.batch,
                    json.dumps(i.env), json.dumps(i.runtime_conf),
                    i.data_source_params, i.preparator_params,
                    i.algorithms_params, i.serving_params,
                ),
            )
        return iid

    def get(self, instance_id: str) -> Optional[base.EngineInstance]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._t} WHERE id=?",
                (instance_id,),
            ).fetchone()
        return self._row_to_obj(row) if row else None

    def get_all(self) -> list[base.EngineInstance]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._t}"
            ).fetchall()
        return [self._row_to_obj(r) for r in rows]

    def get_completed(self, engine_id, engine_version, engine_variant):
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._t} WHERE "
                "status='COMPLETED' AND engineid=? AND engineversion=? AND "
                "enginevariant=? ORDER BY starttime DESC",
                (engine_id, engine_version, engine_variant),
            ).fetchall()
        return [self._row_to_obj(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: base.EngineInstance) -> None:
        self.insert(i)

    def delete(self, instance_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._t} WHERE id=?", (instance_id,))


class SQLiteEvaluationInstances(base.EvaluationInstances, _Dao):
    _COLS = (
        "id,status,starttime,endtime,evaluationclass,enginparamsgeneratorclass,"
        "batch,env,evaluatorresults,evaluatorresultshtml,evaluatorresultsjson"
    )

    def __init__(self, conn, lock, namespace="pio_metadata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._t = f"{self._ns}_evaluationinstances"
        self._ensure(
            f"""CREATE TABLE IF NOT EXISTS {self._t} (
                  id TEXT PRIMARY KEY,
                  status TEXT, starttime INTEGER, endtime INTEGER,
                  evaluationclass TEXT, enginparamsgeneratorclass TEXT,
                  batch TEXT, env TEXT, evaluatorresults TEXT,
                  evaluatorresultshtml TEXT, evaluatorresultsjson TEXT)"""
        )

    def _row_to_obj(self, r) -> base.EvaluationInstance:
        return base.EvaluationInstance(
            id=r[0], status=r[1], start_time=_from_micros(r[2]),
            end_time=_dt_or_none(r[3]), evaluation_class=r[4],
            engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7]), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def insert(self, i: base.EvaluationInstance) -> str:
        iid = i.id or new_event_id()
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {self._t} ({self._COLS}) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (
                    iid, i.status, _to_micros(i.start_time),
                    _micros_or_none(i.end_time), i.evaluation_class,
                    i.engine_params_generator_class, i.batch, json.dumps(i.env),
                    i.evaluator_results, i.evaluator_results_html,
                    i.evaluator_results_json,
                ),
            )
        return iid

    def get(self, instance_id: str) -> Optional[base.EvaluationInstance]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._t} WHERE id=?",
                (instance_id,),
            ).fetchone()
        return self._row_to_obj(row) if row else None

    def get_all(self) -> list[base.EvaluationInstance]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._t}"
            ).fetchall()
        return [self._row_to_obj(r) for r in rows]

    def get_completed(self) -> list[base.EvaluationInstance]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT {self._COLS} FROM {self._t} WHERE "
                "status='EVALCOMPLETED' ORDER BY starttime DESC"
            ).fetchall()
        return [self._row_to_obj(r) for r in rows]

    def update(self, i: base.EvaluationInstance) -> None:
        self.insert(i)

    def delete(self, instance_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._t} WHERE id=?", (instance_id,))


class SQLiteModels(base.Models, _Dao):
    def __init__(self, conn, lock, namespace="pio_modeldata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._t = f"{self._ns}_models"
        self._ensure(
            f"CREATE TABLE IF NOT EXISTS {self._t} (id TEXT PRIMARY KEY, models BLOB)"
        )

    def insert(self, model: base.Model) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {self._t} (id, models) VALUES (?,?)",
                (model.id, model.models),
            )

    def get(self, model_id: str) -> Optional[base.Model]:
        with self._lock:
            row = self._conn.execute(
                f"SELECT id, models FROM {self._t} WHERE id=?", (model_id,)
            ).fetchone()
        return base.Model(row[0], row[1]) if row else None

    def exists(self, model_id: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                f"SELECT 1 FROM {self._t} WHERE id=?", (model_id,)
            ).fetchone()
        return row is not None

    def delete(self, model_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(f"DELETE FROM {self._t} WHERE id=?", (model_id,))


class SQLiteLEvents(base.LEvents, _Dao):
    """Event table per (app, channel): <ns>_<appId>[_<channelId>]
    (reference: JDBCUtils.eventTableName). Tables are auto-created on first
    write so insert-before-init behaves like the memory backend."""

    def __init__(self, conn, lock, namespace="pio_eventdata"):
        _Dao.__init__(self, conn, lock, namespace)
        self._known_tables: set[str] = set()

    def _table(self, app_id: int, channel_id: Optional[int]) -> str:
        suffix = f"_{channel_id}" if channel_id is not None else ""
        return f"{self._ns}_{app_id}{suffix}"

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = self._table(app_id, channel_id)
        self._ensure(
            f"""CREATE TABLE IF NOT EXISTS {t} (
                  id TEXT PRIMARY KEY,
                  event TEXT NOT NULL,
                  entitytype TEXT NOT NULL,
                  entityid TEXT NOT NULL,
                  targetentitytype TEXT,
                  targetentityid TEXT,
                  properties TEXT,
                  eventtime INTEGER NOT NULL,
                  tags TEXT,
                  prid TEXT,
                  creationtime INTEGER NOT NULL)""",
            f"CREATE INDEX IF NOT EXISTS {t}_time ON {t} (eventtime)",
            f"CREATE INDEX IF NOT EXISTS {t}_entity ON {t} (entitytype, entityid)",
        )
        self._known_tables.add(t)
        return True

    def _ensure_table(self, app_id: int, channel_id: Optional[int]) -> str:
        t = self._table(app_id, channel_id)
        if t not in self._known_tables:
            self.init(app_id, channel_id)
        return t

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = self._table(app_id, channel_id)
        with self._lock, self._conn:
            self._conn.execute(f"DROP TABLE IF EXISTS {t}")
        self._known_tables.discard(t)
        return True

    @staticmethod
    def _event_row(event: Event, eid: str) -> tuple:
        return (
            eid, event.event, event.entity_type, event.entity_id,
            event.target_entity_type, event.target_entity_id,
            json.dumps(event.properties.to_dict()),
            _to_micros(event.event_time), json.dumps(list(event.tags)),
            event.pr_id, _to_micros(event.creation_time),
        )

    # Upsert semantics across backends: re-inserting an existing eventId
    # moves the event to the END of its equal-timestamp tie group (the
    # JSONL log re-appends by construction; INSERT OR REPLACE is
    # delete+insert so the new rowid sorts last; the memory backend
    # pops+appends to match).
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        t = self._ensure_table(app_id, channel_id)
        eid = event.event_id or new_event_id()
        with self._lock, self._conn:
            self._conn.execute(
                f"INSERT OR REPLACE INTO {t} VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                self._event_row(event, eid),
            )
        return eid

    def insert_batch(self, events, app_id, channel_id=None):
        t = self._ensure_table(app_id, channel_id)
        rows, ids = [], []
        for event in events:
            eid = event.event_id or new_event_id()
            ids.append(eid)
            rows.append(self._event_row(event, eid))
        with self._lock, self._conn:
            self._conn.executemany(
                f"INSERT OR REPLACE INTO {t} VALUES (?,?,?,?,?,?,?,?,?,?,?)", rows
            )
        return ids

    @staticmethod
    def _row_to_event(r) -> Event:
        return Event(
            event=r[1], entity_type=r[2], entity_id=r[3],
            target_entity_type=r[4], target_entity_id=r[5],
            properties=DataMap(json.loads(r[6]) if r[6] else {}),
            event_time=_from_micros(r[7]),
            tags=tuple(json.loads(r[8]) if r[8] else ()),
            pr_id=r[9], event_id=r[0], creation_time=_from_micros(r[10]),
        )

    @staticmethod
    def _missing_table(e: sqlite3.OperationalError) -> bool:
        # Only "no such table" means an un-init()ed app/channel; every
        # other OperationalError (locked db, disk I/O...) must surface.
        return "no such table" in str(e)

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        t = self._table(app_id, channel_id)
        with self._lock:
            try:
                row = self._conn.execute(
                    f"SELECT * FROM {t} WHERE id=?", (event_id,)
                ).fetchone()
            except sqlite3.OperationalError as e:
                if self._missing_table(e):
                    return None
                raise
        return self._row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = self._table(app_id, channel_id)
        with self._lock, self._conn:
            try:
                cur = self._conn.execute(f"DELETE FROM {t} WHERE id=?", (event_id,))
            except sqlite3.OperationalError as e:
                if self._missing_table(e):
                    return False
                raise
            return cur.rowcount > 0

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
        t = self._table(app_id, channel_id)
        clauses, params = [], []
        if start_time is not None:
            clauses.append("eventtime >= ?")
            params.append(_to_micros(start_time))
        if until_time is not None:
            clauses.append("eventtime < ?")
            params.append(_to_micros(until_time))
        if entity_type is not None:
            clauses.append("entitytype = ?")
            params.append(entity_type)
        if entity_id is not None:
            clauses.append("entityid = ?")
            params.append(entity_id)
        if event_names is not None:
            # Empty list matches nothing (same as the memory backend).
            if not event_names:
                clauses.append("1=0")
            else:
                clauses.append("event IN (%s)" % ",".join("?" * len(event_names)))
                params.extend(event_names)
        if target_entity_type is not None:
            clauses.append("targetentitytype = ?")
            params.append(target_entity_type)
        if target_entity_id is not None:
            clauses.append("targetentityid = ?")
            params.append(target_entity_id)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        # Ties on eventtime keep insertion order either way (stable
        # ascending / stable descending — matching the other backends).
        order = (" ORDER BY eventtime DESC, rowid ASC" if reversed_order
                 else " ORDER BY eventtime ASC, rowid ASC")
        lim = f" LIMIT {int(limit)}" if limit is not None and limit >= 0 else ""
        sql = f"SELECT * FROM {t}{where}{order}{lim}"
        with self._lock:
            try:
                rows = self._conn.execute(sql, params).fetchall()
            except sqlite3.OperationalError as e:
                if not self._missing_table(e):
                    raise
                rows = []
        for r in rows:
            yield self._row_to_event(r)


    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        """$set/$unset/$delete replay on raw rows — result-identical to
        the generic Event replay over find() (same SQL ordering) without
        materializing an Event per row; only each row's properties JSON
        is parsed."""
        t = self._table(app_id, channel_id)
        clauses = ["event IN ('$set','$unset','$delete')"]
        params: list = []
        if entity_type is not None:
            clauses.append("entitytype = ?")
            params.append(entity_type)
        if start_time is not None:
            clauses.append("eventtime >= ?")
            params.append(_to_micros(start_time))
        if until_time is not None:
            clauses.append("eventtime < ?")
            params.append(_to_micros(until_time))
        sql = (f"SELECT entityid, event, properties, eventtime FROM {t} "
               f"WHERE {' AND '.join(clauses)} "
               "ORDER BY eventtime ASC, rowid ASC")
        with self._lock:
            try:
                rows = self._conn.execute(sql, params).fetchall()
            except sqlite3.OperationalError as e:
                if not self._missing_table(e):
                    raise
                rows = []
        state: dict[str, tuple[dict, int, int]] = {}
        for eid, ev, props_s, t_us in rows:
            if ev == "$set":
                d = json.loads(props_s) if props_s else {}
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
                    if props_s:
                        for k in json.loads(props_s):
                            props.pop(k, None)
                    state[eid] = (props, first, t_us)
            else:  # $delete
                state.pop(eid, None)
        out = {
            eid: PropertyMap(props, _from_micros(first), _from_micros(last))
            for eid, (props, first, last) in state.items()
        }
        if required:
            req = set(required)
            out = {k: v for k, v in out.items() if req.issubset(v.keyset())}
        return out


class SQLitePEvents(base.PEvents):
    def __init__(self, l_events: SQLiteLEvents):
        self._l = l_events

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None) -> Iterator[Event]:
        return self._l.find(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id,
        )

    def write(self, events: Iterable[Event], app_id: int, channel_id: Optional[int] = None) -> None:
        self._l.insert_batch(list(events), app_id, channel_id)

    def delete(self, event_ids: Iterable[str], app_id: int, channel_id: Optional[int] = None) -> None:
        for eid in event_ids:
            self._l.delete(eid, app_id, channel_id)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        return self._l.aggregate_properties(
            app_id, entity_type, channel_id, start_time, until_time,
            required)
