"""The port's partition feed (``data/api/partition_feed.py``,
``workflow/train_feed.py``) held against the JAX package's on the same
seeded ``.p<i>`` event logs, one written by each package:

- ``assigned_shards`` deals the canonical shard order round-robin, equal to
  the reference's for every gang size and worker;
- ``partition_ratings`` and ``partition_properties`` of every worker of
  gangs of 1, 2 and 3 (each read in one process, as the reference's own
  tests read them) equal the reference's: the id maps, the triple, the
  property map — with a within-shard delete, a CROSS-partition delete, a
  rating-less event, compacted shards and the tails appended past their
  snapshots;
- the gang of one reads the merged view's events as a multiset;
- the property merge rule (last update wins, ties by canonical shard
  position) equals the reference's;
- the feed's guards: ``--feed merged`` in a gang raises, naming its
  ROADMAP item, and one process falls back to the merged read.
"""

import collections
import datetime as dt
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu.data.api import event_log as ref_log  # noqa: E402
from incubator_predictionio_tpu.data.api import partition_feed as ref_pfeed  # noqa: E402
from incubator_predictionio_tpu.data.storage import Storage as RefStorage  # noqa: E402
from incubator_predictionio_tpu.data.storage import base as ref_base  # noqa: E402
from incubator_predictionio_tpu.data.storage import datamap as ref_datamap  # noqa: E402
from incubator_predictionio_tpu.data.storage import event as ref_event  # noqa: E402
from incubator_predictionio_tpu.data.storage import jsonl as ref_jsonl  # noqa: E402
from incubator_predictionio_tpu.workflow import train_feed as ref_feed  # noqa: E402
from incubator_predictionio_torch.data.api import event_log  # noqa: E402
from incubator_predictionio_torch.data.api import partition_feed as pfeed  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.data.storage import base  # noqa: E402
from incubator_predictionio_torch.data.storage import datamap  # noqa: E402
from incubator_predictionio_torch.data.storage import event  # noqa: E402
from incubator_predictionio_torch.data.storage import jsonl  # noqa: E402
from incubator_predictionio_torch.data.store import PEventStore  # noqa: E402
from incubator_predictionio_torch.workflow import train_feed  # noqa: E402

APP, APP_NAME = 1, "feedapp"
WRITERS = {
    "port": (event.Event, datamap.DataMap, jsonl.JSONLEvents,
             event_log.compact_log),
    "reference": (ref_event.Event, ref_datamap.DataMap, ref_jsonl.JSONLEvents,
                  ref_log.compact_log),
}


def _t(seconds) -> dt.datetime:
    return (dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
            + dt.timedelta(seconds=int(seconds)))


def _build_log(events_dir: str, writer: str, monkeypatch, seed=7,
               n_events=160) -> str:
    """A base log and partitions p0/p1/p2 written by ``writer``: rate and
    rating-less events, user and item ``$set``s, views; a within-shard
    delete; base and p1 compacted, then more appended past the snapshot;
    a CROSS-partition delete (the tombstone in p2, its victim in p1's
    tail)."""
    Event, DataMap, Events, compact = WRITERS[writer]
    rng = np.random.default_rng(seed)

    def store(part):
        if part is None:
            monkeypatch.delenv("PIO_EVENT_PARTITION", raising=False)
        else:
            monkeypatch.setenv("PIO_EVENT_PARTITION", str(part))
        st = Events(events_dir)
        monkeypatch.delenv("PIO_EVENT_PARTITION", raising=False)
        return st

    def rate(user, item, rating, t, name="rate"):
        return Event(event=name, entity_type="user", entity_id=str(user),
                     target_entity_type="item", target_entity_id=str(item),
                     properties=DataMap({"rating": float(rating)}
                                        if rating is not None else {}),
                     event_time=_t(t))

    victims = []
    for part in (None, 0, 1, 2):
        st = store(part)
        evs = [rate(rng.integers(0, 25), rng.integers(0, 18),
                    rng.integers(1, 6), rng.integers(0, 5000))
               for _ in range(n_events // 4)]
        evs.append(rate(rng.integers(0, 25), rng.integers(0, 18), None,
                        5001, name="buy"))
        ids = st.insert_batch(evs, APP)
        victims.append(ids[3])
        st.insert_batch([Event(
            event="$set", entity_type="item", entity_id=str(j),
            properties=DataMap({"categories": ["a", f"p{part}"],
                                "rank": j}),
            event_time=_t(6000 + j + (part or 0))) for j in range(5)], APP)
        st.insert_batch([rate(rng.integers(0, 25), rng.integers(0, 18),
                              None, 7000 + j, name="view")
                         for j in range(5)], APP)
    store(0).delete_batch([victims[1]], APP)
    for name in ("events_1.jsonl", "events_1.p1.jsonl"):
        assert compact(os.path.join(events_dir, name))
    tail_ids = store(1).insert_batch(
        [rate(100 + j, 200 + j, 3, 9000 + j) for j in range(6)], APP)
    store(2).delete_batch([tail_ids[0]], APP)
    return events_dir


def _storages(root: str):
    env = {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
           "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
           "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
           "PIO_STORAGE_SOURCES_JL_PATH": root}
    port, ref = Storage(env), RefStorage(env)
    port.get_meta_data_apps().insert(base.App(id=APP, name=APP_NAME))
    ref.get_meta_data_apps().insert(ref_base.App(id=APP, name=APP_NAME))
    return port, ref


@pytest.fixture(params=sorted(WRITERS))
def logs(request, tmp_path, monkeypatch):
    """(port storage, reference storage, events dir) over one log written
    by the parametrized package."""
    port, ref = _storages(str(tmp_path / "events"))
    events_dir = port.get_l_events().events_dir
    assert events_dir == ref.get_l_events().events_dir
    _build_log(events_dir, request.param, monkeypatch)
    yield port, ref, events_dir
    port.close()
    ref.close()


def _as_gang_worker(monkeypatch, worker: int, n: int) -> None:
    monkeypatch.setenv("PIO_NUM_PROCESSES", str(n))
    monkeypatch.setenv("PIO_PROCESS_ID", str(worker))


def test_assigned_shards_match_reference(logs):
    _, _, events_dir = logs
    canonical = jsonl.shard_paths(events_dir, APP)
    assert len(canonical) == 4
    for n in (1, 2, 3, 4, 7):
        union = []
        for w in range(n):
            mine = pfeed.assigned_shards(events_dir, APP, None, w, n)
            assert mine == ref_pfeed.assigned_shards(events_dir, APP, None,
                                                     w, n)
            assert mine == canonical[w::n]
            union += mine
        assert sorted(union) == sorted(canonical)
    with pytest.raises(ValueError):
        pfeed.assigned_shards(events_dir, APP, None, 2, 2)


def test_scan_shard_reads_snapshot_and_tail(logs):
    _, _, events_dir = logs
    compacted = os.path.join(events_dir, "events_1.p1.jsonl")
    shard = pfeed.scan_shard(compacted)
    ref = ref_pfeed.scan_shard(compacted)
    assert shard.snapshot_bytes > 0 and shard.tail_bytes > 0
    assert (shard.snapshot_bytes, shard.tail_bytes) == (ref.snapshot_bytes,
                                                        ref.tail_bytes)
    assert shard.tombstone_ids == ref.tombstone_ids
    assert np.array_equal(shard.live, ref.live)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_partition_ratings_match_reference(logs, monkeypatch, n):
    port, ref, _ = logs
    kw = dict(event_names=["rate", "buy"],
              event_default_ratings={"buy": 4.0})
    for w in range(n):
        _as_gang_worker(monkeypatch, w, n)
        report = {}
        got = train_feed.partition_ratings(APP_NAME, storage=port,
                                           report=report, **kw)
        want = ref_feed.partition_ratings(APP_NAME, storage=ref, **kw)
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(got[0]) > 0 and len(got[3]) > 0
        assert list(got[3].keys()) == list(want[3].keys())
        assert list(got[4].keys()) == list(want[4].keys())
        assert report["rank"] == w and report["world"] == n
        assert report["local_ratings"] == len(got[0])
        assert [os.path.basename(p) for p in report["shards"]] == [
            os.path.basename(p) for p in pfeed.assigned_shards(
                port.get_l_events().events_dir, APP, None, w, n)]


def test_gang_of_one_reads_the_merged_multiset(logs, monkeypatch):
    port, _, _ = logs
    _as_gang_worker(monkeypatch, 0, 1)
    kw = dict(event_names=["rate", "buy"],
              event_default_ratings={"buy": 4.0})
    u, i, r, users, items = train_feed.partition_ratings(
        APP_NAME, storage=port, **kw)
    mu, mi, mr, musers, mitems = PEventStore.find_ratings(
        APP_NAME, storage=port, **kw)

    def multiset(u, i, r, users, items):
        return collections.Counter(
            (users.inverse(int(a)), items.inverse(int(b)), float(c))
            for a, b, c in zip(u, i, r))

    assert multiset(u, i, r, users, items) == \
        multiset(mu, mi, mr, musers, mitems)
    # the cross-partition victim is gone from both
    assert not any(users.inverse(int(a)) == "100" for a in u)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_partition_properties_match_reference(logs, monkeypatch, n):
    port, ref, _ = logs
    for w in range(n):
        _as_gang_worker(monkeypatch, w, n)
        feed_ctx = train_feed.open_feed(APP_NAME, port)
        ref_ctx = ref_feed.open_feed(APP_NAME, ref)
        assert feed_ctx[2] == ref_ctx[2]  # the exchanged tombstones
        got = train_feed.partition_properties(APP_NAME, "item",
                                              storage=port, feed_ctx=feed_ctx)
        want = ref_feed.partition_properties(APP_NAME, "item", storage=ref,
                                             feed_ctx=ref_ctx)
        assert got == want and got
        # the shared scan also feeds the rating read, as the template does
        views = train_feed.partition_ratings(
            APP_NAME, event_names=["view"], rating_from_props=False,
            storage=port, feed_ctx=feed_ctx)
        ref_views = ref_feed.partition_ratings(
            APP_NAME, event_names=["view"], rating_from_props=False,
            storage=ref, feed_ctx=ref_ctx)
        assert len(views[0]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(views[:3],
                                                        ref_views[:3]))


def test_property_merge_rule_matches_reference():
    rng = np.random.default_rng(3)
    absent = np.iinfo(np.int64).min
    gathered = []
    for _worker in range(3):
        part = []
        for pos in rng.permutation(6)[:3]:
            rep = {}
            for e in range(5):
                last = int(rng.choice([absent, 10, 20, 20, 30]))
                rep[f"e{e}"] = [{"k": int(rng.integers(0, 9)),
                                 f"x{pos}": 1}, 0, last]
            part.append((int(pos), rep))
        gathered.append(part)
    assert train_feed._merge_property_parts(gathered) == \
        ref_feed._merge_property_parts(gathered)


def test_gang_feed_guards(logs, monkeypatch, caplog):
    port, _, _ = logs
    monkeypatch.setenv("PIO_TRAIN_FEED", "merged")
    err = train_feed.gang_feed_error(port, 2)
    assert "item 7.1" in err and "--feed merged" in err
    assert train_feed.gang_feed_error(port, 1) is None
    _as_gang_worker(monkeypatch, 1, 2)
    with pytest.raises(NotImplementedError, match="item 7.1"):
        train_feed.partition_feed_active(port)
    _as_gang_worker(monkeypatch, 0, 1)
    assert train_feed.partition_feed_active(port) is False
    monkeypatch.setenv("PIO_TRAIN_FEED", "partition")
    assert train_feed.partition_feed_active(port) is True
    # a store without a JSONL log: a gang refuses, one process reads merged
    mem = Storage({"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                   "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
                   "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                   "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY"})
    assert "item 7.1" in train_feed.gang_feed_error(mem, 2)
    assert train_feed.partition_feed_active(mem) is False
