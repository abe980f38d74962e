"""The port's served-result cache on the CPU: ``tests/test_query_cache.py``'s
contracts (canonical user-scoped keys, LRU, copy isolation, TTL, exact
targeted invalidation, the generation guard, app-scoped keys and flushes,
the fold-in footprint rule, and over HTTP: a swap and a rollback flush
everything, so no stale answer is served), and one operation sequence on
the port's and the reference's ``QueryResultCache`` giving equal
``snapshot()``s.
"""

import json
import time
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.workflow.create_server import (  # noqa: E402
    QueryResultCache as RefCache,
)
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    EngineServer, QueryResultCache,
)


def test_cache_key_is_canonical_and_user_scoped():
    k1 = QueryResultCache.key_for({"user": "a", "num": 3})
    assert k1 == QueryResultCache.key_for({"num": 3, "user": "a"})
    assert k1[0] == "a"
    assert QueryResultCache.key_for({"items": ["i1"], "num": 3})[0] is None
    assert k1 != QueryResultCache.key_for({"user": "a", "num": 4})
    # the same function as the reference's: the keys are equal
    for q in ({"user": "a", "num": 3}, {"items": ["x"]}, {"user": 7}):
        assert QueryResultCache.key_for(q, "app") == RefCache.key_for(q, "app")


def test_cache_hit_miss_lru_and_copy_isolation():
    c = QueryResultCache(2, ttl_s=60.0)
    ka, kb, kc = (QueryResultCache.key_for({"user": u}) for u in "abc")
    assert c.get(ka) is None and c.misses == 1
    c.put(ka, {"itemScores": [{"item": "i", "score": 1.0}]})
    got = c.get(ka)
    assert got == {"itemScores": [{"item": "i", "score": 1.0}]}
    # hits hand out copies: a plugin mutating its result in place must
    # not corrupt the cached entry
    got["itemScores"].clear()
    assert c.get(ka)["itemScores"], "cached entry mutated through a hit"
    c.put(kb, {"v": "b"})
    c.put(kc, {"v": "c"})
    assert c.get(ka) is None and c.evictions == 1
    snap = c.snapshot()
    assert snap["entries"] == 2 and snap["maxEntries"] == 2
    assert snap["hits"] == 2 and snap["evictions"] == 1


def test_cache_ttl_expires_entries():
    c = QueryResultCache(8, ttl_s=0.05)
    k = QueryResultCache.key_for({"user": "a"})
    c.put(k, {"v": 1})
    assert c.get(k) == {"v": 1}
    time.sleep(0.08)
    assert c.get(k) is None
    assert c.snapshot()["entries"] == 0


def test_cache_targeted_invalidation_is_exact():
    c = QueryResultCache(16, ttl_s=60.0)
    c.put(QueryResultCache.key_for({"user": "a", "num": 1}), {"v": 1})
    c.put(QueryResultCache.key_for({"user": "a", "num": 2}), {"v": 2})
    c.put(QueryResultCache.key_for({"user": "b", "num": 1}), {"v": 3})
    c.put(QueryResultCache.key_for({"items": ["i1"]}), {"v": 4})
    assert c.invalidate_users(["a"]) == 2
    assert c.get(QueryResultCache.key_for({"user": "a", "num": 1})) is None
    assert c.get(QueryResultCache.key_for({"user": "b", "num": 1})) == {"v": 3}
    assert c.get(QueryResultCache.key_for({"items": ["i1"]})) == {"v": 4}
    snap = c.snapshot()
    assert snap["invalidations"] == 1 and snap["invalidatedEntries"] == 2
    assert c.flush("swap") == 2
    assert c.snapshot()["entries"] == 0
    assert c.snapshot()["invalidations"] == 2


def test_cache_generation_guard_drops_stale_insert():
    c = QueryResultCache(8, ttl_s=60.0)
    k = QueryResultCache.key_for({"user": "a"})
    gen = c.generation          # dispatch starts on the old model
    c.flush("swap")             # a swap invalidates mid-flight
    c.put(k, {"v": "stale"}, gen)
    assert c.get(k) is None, "stale insert survived the generation guard"
    c.put(k, {"v": "fresh"}, c.generation)
    assert c.get(k) == {"v": "fresh"}


def test_cache_app_scoped_keys_invalidation_and_flush():
    q = {"user": "u", "num": 1}
    kA, kB = QueryResultCache.key_for(q, "app-A"), QueryResultCache.key_for(
        q, "app-B")
    assert kA != kB and kA != QueryResultCache.key_for(q)
    assert kA[0] == kB[0] == "u"
    c = QueryResultCache(16, ttl_s=60.0)
    c.put(kA, {"v": "A"})
    c.put(kB, {"v": "B"})
    assert c.invalidate_users(["u"], app="app-A") == 1
    assert c.get(kA) is None and c.get(kB) == {"v": "B"}
    kA2 = QueryResultCache.key_for({"items": ["i1"]}, "app-A")
    c.put(kA, {"v": 1})
    c.put(kA2, {"v": 2})
    gen = c.generation
    assert c.flush_app("app-A", "tenant") == 2
    assert c.get(kB) == {"v": "B"}
    c.put(kA, {"v": "stale"}, gen)
    assert c.get(kA) is None


def _inst(iid, marker=None):
    return types.SimpleNamespace(
        id=iid, runtime_conf={} if marker is None else {"foldin": marker})


def test_foldin_footprint_requires_users_and_lineage():
    prev = _inst("base")
    mk = lambda **kw: json.dumps({"of": "base", "events": 1, **kw})  # noqa: E731
    fp = EngineServer._foldin_footprint
    assert fp(_inst("inc", mk(bases=["base"], users=["u1", "u2"])),
              prev) == ["u1", "u2"]
    assert fp(_inst("inc", mk(bases=["base"])), prev) is None
    assert fp(_inst("inc", mk(bases=["other"], users=["u1"])), prev) is None
    assert fp(_inst("inc", mk(users=["u1"])), prev) is None
    assert fp(_inst("inc"), prev) is None
    assert fp(_inst("inc", mk(bases=["base"], users=["u1"])), None) is None
    assert fp(types.SimpleNamespace(id="inc", runtime_conf={"foldin": {
        "of": "base", "bases": ["base"], "users": ["u9"]}}), prev) == ["u9"]
    assert fp(_inst("inc", "}{"), prev) is None


def _sequence(cache, key_for):
    """One operation sequence: misses, hits, LRU evictions, a targeted
    invalidation, an app flush, a stale insert and a full flush."""
    keys = [key_for({"user": f"u{j % 5}", "num": j % 3}, None if j % 4
                    else "app") for j in range(12)]
    for j, k in enumerate(keys):
        cache.get(k)
        cache.put(k, {"j": j})
        cache.get(k)
    gen = cache.generation
    cache.invalidate_users(["u1", "u3"])
    cache.put(keys[0], {"stale": True}, gen)
    cache.flush_app("app", "tenant")
    for k in keys[:6]:
        cache.get(k)
    cache.flush("swap")
    cache.put(keys[1], {"j": "again"})
    cache.get(keys[1])


def test_snapshot_equals_reference_for_one_sequence():
    port, ref = QueryResultCache(6, ttl_s=60.0), RefCache(6, ttl_s=60.0)
    _sequence(port, QueryResultCache.key_for)
    _sequence(ref, RefCache.key_for)
    assert port.snapshot() == ref.snapshot()
    assert port.generation == ref.generation


def test_server_cache_swap_and_rollback_flush_no_stale_serves():
    """A swap flushes, a rollback flushes: the TTL (minutes) would serve a
    surviving stale entry, so each fresh answer proves the flush."""
    storage = ts.memory_storage()
    iid1 = ts.train_lifecycle(storage, "one")
    server = EngineServer(ts.lifecycle_engine(),
                          engine_factory_name="lifecycle", storage=storage,
                          device="cpu", query_cache_size=32,
                          query_cache_ttl_ms=300_000)
    with ts.serving(server) as base:
        assert ts.query(base, {"user": "u1"})[1]["tag"] == "one"  # miss
        assert ts.query(base, {"user": "u1"})[1]["tag"] == "one"  # hit
        snap = ts.status(base)["queryCache"]
        assert snap["hits"] == 1 and snap["misses"] == 1
        assert snap["entries"] == 1
        # probe traffic bypasses the cache both ways
        assert ts.query(base, {"user": "u1"},
                        headers={"X-Pio-Probe": "x"})[0] == 200
        assert ts.status(base)["queryCache"]["hits"] == 1

        iid2 = ts.train_lifecycle(storage, "two")
        code, doc, _ = ts.call(base, "GET", "/reload")
        assert code == 200 and doc["engineInstanceId"] == iid2 != iid1
        assert ts.query(base, {"user": "u1"})[1]["tag"] == "two"
        inv = ts.status(base)["queryCache"]["invalidations"]
        assert inv >= 1

        code, doc, _ = ts.call(base, "POST", "/rollback")
        assert code == 200 and doc["engineInstanceId"] == iid1
        assert ts.query(base, {"user": "u1"})[1]["tag"] == "one"
        assert ts.status(base)["queryCache"]["invalidations"] > inv
