"""MySQL backend — the `MYSQL` source type (all three repositories).

The port's own copy of ``incubator_predictionio_tpu/data/storage/mysql.py``; the wire
bytes and the tables are the reference's, so either package reads a store
the other wrote.

Reference: storage/jdbc/.../JDBCUtils.scala (SURVEY.md §2.1) — the
reference's JDBC layer served Postgres *and* MySQL from one DAO set with
dialect-specific DDL. This mirrors that factoring: the DAO bodies are
shared with the Postgres backend (postgres.py — both connections accept
the same ``$N`` placeholder SQL and never interpolate parameters), and
this module overrides only what the MySQL dialect genuinely changes:

- DDL: ``VARCHAR(191)`` for indexed/key text columns (utf8mb4 fits the
  767-byte legacy index limit), ``LONGBLOB`` for model blobs,
  ``AUTO_INCREMENT`` for generated ids, no ``CREATE INDEX IF NOT
  EXISTS`` (duplicate-index errno 1061 is swallowed instead).
- No ``RETURNING``: generated keys ride the OK packet's
  ``last_insert_id`` and deletes report ``affected_rows`` — the same
  channels JDBC's getGeneratedKeys()/executeUpdate() used.
- Upserts: ``ON DUPLICATE KEY UPDATE col=VALUES(col)`` instead of
  ``ON CONFLICT ... DO UPDATE``.

    PIO_STORAGE_SOURCES_MY_TYPE=MYSQL
    PIO_STORAGE_SOURCES_MY_HOST=db-host      PORT=3306
    PIO_STORAGE_SOURCES_MY_USERNAME=pio      PASSWORD=...
    PIO_STORAGE_SOURCES_MY_DATABASE=pio
"""

from __future__ import annotations

from typing import Optional

from . import base
from .event import Event, new_event_id
from .mysqlwire import MySQLConnection, MySQLError
from .sqlite import _safe_ident
from .postgres import (
    PGAccessKeys, PGApps, PGChannels, PGEngineInstances,
    PGEvaluationInstances, PGLEvents, PGModels, PGPEvents,
)

_ER_DUP_KEYNAME = 1061


def _make_index(conn: MySQLConnection, name: str, table: str,
                cols: str) -> None:
    """CREATE INDEX, tolerating "already exists" (MySQL has no
    IF NOT EXISTS for indexes; errno 1061 is the idempotence signal)."""
    try:
        conn.query(f"CREATE INDEX {name} ON {table} ({cols})")
    except MySQLError as e:
        if e.errno != _ER_DUP_KEYNAME:
            raise


class MySQLLEvents(PGLEvents):
    def _ensure(self):
        self._c.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "  appid BIGINT NOT NULL,"
            "  channelid BIGINT NOT NULL,"
            "  eventid VARCHAR(255) NOT NULL,"
            "  seq BIGINT NOT NULL,"
            "  event TEXT NOT NULL,"
            "  entitytype TEXT NOT NULL,"
            "  entityid TEXT NOT NULL,"
            "  targetentitytype TEXT,"
            "  targetentityid TEXT,"
            "  eventtimeus BIGINT NOT NULL,"
            "  eventjson LONGTEXT NOT NULL,"
            "  PRIMARY KEY (appid, channelid, eventid))")
        _make_index(self._c, f"{self._t}_time", self._t,
                    "appid, channelid, eventtimeus, seq")
        _make_index(self._c, f"{self._t}_seq", self._t, "seq")

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        eid = event.event_id or new_event_id()
        if len(eid.encode()) > 255:
            # the PK column is VARCHAR(255): refuse loudly rather than
            # let a non-strict server silently truncate the id (two ids
            # sharing a 255-byte prefix would collide and upsert over
            # each other — silent data loss)
            raise MySQLError(
                1406, "22001",
                f"eventId longer than 255 bytes ({len(eid.encode())}) "
                "cannot be stored in the MySQL backend")
        stored = event.with_event_id(eid)
        chan = self._chan(channel_id)
        # Same atomic move-to-end-of-tie-group upsert as the PG backend,
        # in MySQL's dialect (the PK is the duplicate-key target).
        self._c.query(
            self._INSERT_SQL + " ON DUPLICATE KEY UPDATE"
            " seq=VALUES(seq), event=VALUES(event),"
            " entitytype=VALUES(entitytype), entityid=VALUES(entityid),"
            " targetentitytype=VALUES(targetentitytype),"
            " targetentityid=VALUES(targetentityid),"
            " eventtimeus=VALUES(eventtimeus), eventjson=VALUES(eventjson)",
            (app_id, chan, eid, self._seq.next()) + self._row_tail(stored))
        return eid

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        self._c.query(
            f"DELETE FROM {self._t} "
            "WHERE appid=$1 AND channelid=$2 AND eventid=$3",
            (app_id, self._chan(channel_id), event_id))
        return self._c.affected_rows > 0

    def _delete_chunk(self, chunk, app_id: int, chan: int) -> set[str]:
        """MySQL has no DELETE..RETURNING, so a SELECT snapshots which
        ids exist before the DELETE — a writer racing between the two
        statements can skew individual booleans, the same weak guarantee
        the per-event loop's affected_rows check gives. Chunk loop +
        duplicate-id bookkeeping are inherited from PGLEvents."""
        ph = ",".join(f"${j}" for j in range(3, 3 + len(chunk)))
        where = f"WHERE appid=$1 AND channelid=$2 AND eventid IN ({ph})"
        _, rows = self._c.query(
            f"SELECT eventid FROM {self._t} {where}",
            (app_id, chan, *chunk))
        present = {r[0] for r in rows}
        if present:
            self._c.query(f"DELETE FROM {self._t} {where}",
                          (app_id, chan, *chunk))
        return present

    def find(self, app_id, channel_id=None, start_time=None,
             until_time=None, entity_type=None, entity_id=None,
             event_names=None, target_entity_type=None,
             target_entity_id=None, limit=None, reversed_order=False,
             stream: bool = False):
        """``stream=True`` pages via KEYSET pagination — repeated
        self-contained queries ``WHERE (eventtimeus, seq) > (t, s) …
        LIMIT page`` riding the (appid, channelid, eventtimeus, seq)
        index — so the 20M-event training feed never materializes as
        one list (the PG backend's portal streaming, in the dialect
        MySQL can do without cursor round-trip state). Each page is an
        independent query: interleaving other queries is safe here."""
        if event_names is not None:
            # materialize ONCE: a one-shot iterable must survive both
            # the emptiness check and every keyset page below
            event_names = list(event_names)
        if not (stream and limit is None and not reversed_order):
            return super().find(
                app_id, channel_id, start_time, until_time, entity_type,
                entity_id, event_names, target_entity_type,
                target_entity_id, limit, reversed_order)
        if event_names is not None and not event_names:
            return iter(())
        return self._find_keyset(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id)

    def _find_keyset(self, app_id, channel_id, start_time, until_time,
                     entity_type, entity_id, event_names,
                     target_entity_type, target_entity_id):
        import json as _json
        from ...common import envknobs
        from .event import event_time_us as _us

        page = envknobs.env_int("PIO_SQL_PAGE_SIZE", 5000, lo=1)
        cursor = None  # (eventtimeus, seq) of the last yielded row
        while True:
            where = ["appid=$1", "channelid=$2"]
            params: list = [app_id, self._chan(channel_id)]

            def arg(v):
                params.append(v)
                return f"${len(params)}"

            if cursor is not None:
                where.append(f"(eventtimeus, seq) > ({arg(cursor[0])},"
                             f" {arg(cursor[1])})")
            if start_time is not None:
                where.append(f"eventtimeus >= {arg(_us(start_time))}")
            if until_time is not None:
                where.append(f"eventtimeus < {arg(_us(until_time))}")
            if entity_type is not None:
                where.append(f"entitytype = {arg(entity_type)}")
            if entity_id is not None:
                where.append(f"entityid = {arg(entity_id)}")
            if target_entity_type is not None:
                where.append(
                    f"targetentitytype = {arg(target_entity_type)}")
            if target_entity_id is not None:
                where.append(f"targetentityid = {arg(target_entity_id)}")
            if event_names is not None:
                slots = ",".join(arg(n) for n in event_names)
                where.append(f"event IN ({slots})")
            sql = (f"SELECT eventjson, eventtimeus, seq FROM {self._t} "
                   "WHERE " + " AND ".join(where)
                   + f" ORDER BY eventtimeus ASC, seq ASC LIMIT {page}")
            _, rows = self._c.query(sql, params)
            for r in rows:
                yield Event.from_json(_json.loads(r[0]))
            if len(rows) < page:
                return
            cursor = (int(rows[-1][1]), int(rows[-1][2]))


class MySQLPEvents(PGPEvents):
    pass


class MySQLApps(PGApps):
    _WIRE_ERROR = MySQLError

    @staticmethod
    def _is_duplicate(e) -> bool:
        return e.errno == 1062  # ER_DUP_ENTRY (sqlstate 23000 is broader)

    def __init__(self, conn: MySQLConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_apps".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id BIGINT AUTO_INCREMENT PRIMARY KEY,"
            " name VARCHAR(191) NOT NULL UNIQUE, description TEXT)")

    def insert(self, app: base.App) -> Optional[int]:
        if self.get_by_name(app.name) is not None:
            return None
        try:
            if app.id > 0:
                self._c.query(
                    f"INSERT INTO {self._t} (id, name, description) "
                    "VALUES ($1,$2,$3)",
                    (app.id, app.name, app.description))
                return app.id
            self._c.query(
                f"INSERT INTO {self._t} (name, description) VALUES ($1,$2)",
                (app.name, app.description))
        except self._WIRE_ERROR as e:
            if self._is_duplicate(e):
                return None
            raise
        return int(self._c.last_insert_id)


class MySQLAccessKeys(PGAccessKeys):
    _WIRE_ERROR = MySQLError

    @staticmethod
    def _is_duplicate(e) -> bool:
        return e.errno == 1062  # ER_DUP_ENTRY (sqlstate 23000 is broader)

    def __init__(self, conn: MySQLConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_accesskeys".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "accesskey VARCHAR(191) PRIMARY KEY,"
            " appid BIGINT NOT NULL, events TEXT)")


class MySQLChannels(PGChannels):
    _WIRE_ERROR = MySQLError

    @staticmethod
    def _is_duplicate(e) -> bool:
        return e.errno == 1062  # ER_DUP_ENTRY (sqlstate 23000 is broader)

    def __init__(self, conn: MySQLConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_channels".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id BIGINT AUTO_INCREMENT PRIMARY KEY,"
            " name VARCHAR(191) NOT NULL, appid BIGINT NOT NULL)")

    def insert(self, channel: base.Channel) -> Optional[int]:
        if not base.Channel.is_valid_name(channel.name):
            return None
        try:
            if channel.id > 0:
                self._c.query(
                    f"INSERT INTO {self._t} (id, name, appid) "
                    "VALUES ($1,$2,$3)",
                    (channel.id, channel.name, channel.appid))
                return channel.id
            self._c.query(
                f"INSERT INTO {self._t} (name, appid) VALUES ($1,$2)",
                (channel.name, channel.appid))
        except self._WIRE_ERROR as e:
            if self._is_duplicate(e):
                return None
            raise
        return int(self._c.last_insert_id)


class MySQLEngineInstances(PGEngineInstances):
    def __init__(self, conn: MySQLConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_engineinstances".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id VARCHAR(64) PRIMARY KEY, status TEXT, starttimeus BIGINT,"
            " engineid TEXT, engineversion TEXT, enginevariant TEXT,"
            " doc LONGTEXT NOT NULL)")


class MySQLEvaluationInstances(PGEvaluationInstances):
    def __init__(self, conn: MySQLConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_evaluationinstances".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id VARCHAR(64) PRIMARY KEY, status TEXT, starttimeus BIGINT,"
            " doc LONGTEXT NOT NULL)")


class MySQLModels(PGModels):
    def __init__(self, conn: MySQLConnection, namespace: str):
        self._c = conn
        self._t = f"{_safe_ident(namespace)}_models".lower()
        conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._t} ("
            "id VARCHAR(191) PRIMARY KEY, models LONGBLOB NOT NULL)")


class MySQLClient(base.BaseStorageClient):
    """`TYPE=MYSQL`; properties HOST (default 127.0.0.1), PORT (3306),
    USERNAME, PASSWORD, DATABASE (default = username). Serves all three
    repositories — the MySQL half of the reference's JDBC assembly."""

    def __init__(self, config: base.StorageClientConfig):
        super().__init__(config)
        p = config.properties
        user = p.get("USERNAME", "pio")
        self._conn = MySQLConnection(
            host=p.get("HOST", "127.0.0.1"),
            port=int(p.get("PORT", "3306")),
            user=user,
            password=p.get("PASSWORD", ""),
            database=p.get("DATABASE", user),
        )
        self._daos: dict = {}

    def _dao(self, cls, namespace: str):
        key = (cls, namespace)
        dao = self._daos.get(key)
        if dao is None:
            dao = self._daos[key] = cls(self._conn, namespace)
        return dao

    def apps(self, namespace: str = "pio_metadata"):
        return self._dao(MySQLApps, namespace)

    def access_keys(self, namespace: str = "pio_metadata"):
        return self._dao(MySQLAccessKeys, namespace)

    def channels(self, namespace: str = "pio_metadata"):
        return self._dao(MySQLChannels, namespace)

    def engine_instances(self, namespace: str = "pio_metadata"):
        return self._dao(MySQLEngineInstances, namespace)

    def evaluation_instances(self, namespace: str = "pio_metadata"):
        return self._dao(MySQLEvaluationInstances, namespace)

    def models(self, namespace: str = "pio_modeldata"):
        return self._dao(MySQLModels, namespace)

    def l_events(self, namespace: str = "pio_eventdata"):
        return self._dao(MySQLLEvents, namespace)

    def p_events(self, namespace: str = "pio_eventdata"):
        return MySQLPEvents(self.l_events(namespace))

    def close(self) -> None:
        self._conn.close()
