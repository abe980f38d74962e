"""The port's multi-tenant serving (``workflow/multitenant.py`` and the
engine server's tenant routing) on the CPU: the six cases of
``tests/test_multitenant.py``.

- ``resolve_app`` gives the reference's answer on the same requests (the
  app header, then the ``app`` parameter, then the ``accessKey`` parameter,
  then the ``X-Pio-Access-Key`` header; a bad key raises);
- the resident LRU is bounded and pins survive eviction;
- eviction never drops a tenant mid-query;
- a tenant's admission budget sheds that app alone;
- a poisoned tenant rolls back alone;
- over HTTP, one server serves 12 apps with 4 resident: every answer is its
  own app's, evictions happen, a bad key is 401, a poisoned tenant is
  pinned and rolled back alone while its neighbors answer 200, and
  ``pio status --engine-url`` prints the per-tenant table. The counts are
  read from ``/status`` (the port has no ``/metrics`` yet).
"""

import io
import time
import types
from contextlib import redirect_stdout

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.data import storage as ref_storage  # noqa: E402
from incubator_predictionio_tpu.workflow import multitenant as ref_mt  # noqa: E402
from incubator_predictionio_torch.data.storage import AccessKey, App, Storage  # noqa: E402
from incubator_predictionio_torch.tools.commands.management import (  # noqa: E402
    _print_engine_overload,
)
from incubator_predictionio_torch.workflow import multitenant  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.core_workflow import run_train  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    AdmissionShed, EngineServer, Request,
)

FACTORY = "torch_serving.lifecycle_engine"


def _train(storage, app, tag=None, mode="good"):
    iid = run_train(ts.lifecycle_engine(), ts.lifecycle_params(tag or app,
                                                               mode),
                    WorkflowContext(app_name=app, storage=storage,
                                    device="cpu"),
                    engine_factory_name=FACTORY)
    time.sleep(0.002)  # strictly ordered start_times
    return iid


def _mk_app(storage, name):
    return storage.get_meta_data_apps().insert(App(0, name))


def _server(storage, max_resident=2, max_pending=32, **kw):
    return EngineServer(ts.lifecycle_engine(), engine_factory_name=FACTORY,
                        storage=storage, device="cpu",
                        tenant_max_resident=max_resident,
                        tenant_max_pending=max_pending, **kw)


# -- routing: the reference's answers ---------------------------------------

REQUESTS = [
    ({"X-Pio-App": "tenant-a"}, {}),
    ({}, {"app": "tenant-a"}),
    ({"X-Pio-App": "other"}, {"accessKey": "KEY-A"}),
    ({"X-Pio-App": "first"}, {"app": "second"}),
    ({}, {"accessKey": "KEY-A"}),
    ({"X-Pio-Access-Key": "KEY-A"}, {}),
    ({"X-Pio-Access-Key": "NO-SUCH-KEY"}, {"accessKey": "KEY-A"}),
    ({}, {}),
    ({"X-Pio-Other": "x"}, {"user": "u1"}),
    ({}, {"accessKey": "NO-SUCH-KEY"}),
    ({"X-Pio-Access-Key": "NO-SUCH-KEY"}, {}),
]


@pytest.fixture(scope="module")
def routing(tmp_path_factory):
    """One SQLite store read by both packages: the app tenant-a, its key
    KEY-A, and the default app's instance."""
    root = tmp_path_factory.mktemp("routing")
    env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "DB"
           for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(root / "pio.sqlite")}
    storage = Storage(env)
    app_id = _mk_app(storage, "tenant-a")
    storage.get_meta_data_access_keys().insert(AccessKey("KEY-A", app_id))
    _train(storage, "default-app")
    port = _server(storage)
    ref = ref_mt.TenantMux(types.SimpleNamespace(
        storage=ref_storage.Storage(env)), 2, 32)
    yield port._tenants, ref
    port.stop()
    storage.close()


def _answer(mux, request):
    try:
        return mux.resolve_app(request)
    except (multitenant.UnknownTenant, ref_mt.UnknownTenant) as e:
        return type(e).__name__


@pytest.mark.parametrize("headers,params", REQUESTS,
                         ids=lambda v: repr(v)[:30])
def test_resolve_app_gives_the_reference_answer(routing, headers, params):
    mux, ref = routing
    got = _answer(mux, Request(headers, {k: [v] for k, v in params.items()},
                               b""))
    want = _answer(ref, types.SimpleNamespace(headers=headers, query=params))
    assert got == want


def test_resolve_app_routing_order_and_bad_key(routing):
    mux, _ = routing
    assert mux.resolve_app(Request({"X-Pio-App": "tenant-a"}, {}, b"")) \
        == "tenant-a"
    assert mux.resolve_app(Request({}, {"accessKey": ["KEY-A"]}, b"")) \
        == "tenant-a"
    assert "KEY-A" in mux._keys     # TTL-cached
    assert mux.resolve_app(Request({}, {}, b"")) is None
    with pytest.raises(multitenant.UnknownTenant):
        mux.resolve_app(Request({}, {"accessKey": ["NO-SUCH-KEY"]}, b""))
    # an unregistered app name is refused at admission (→ 404)
    with pytest.raises(multitenant.UnknownTenant):
        mux.admit("never-registered")


# -- the resident cache, admission and the per-tenant lifecycle ------------------

def test_lru_eviction_bound_and_pins_survive_eviction():
    storage = ts.memory_storage()
    for name in ("t0", "t1", "t2"):
        _mk_app(storage, name)
        _train(storage, name)
    _train(storage, "default-app")
    mux = _server(storage, max_resident=2)._tenants

    def query_once(app):
        state = mux.admit(app)
        try:
            mux.ensure_loaded(state)
            assert state.deployment is not None
        finally:
            mux.release(state)
        return state

    query_once("t0")
    query_once("t1")
    snap = mux.snapshot()
    assert snap["resident"] == 2 and snap["evictions"] == 0
    # loading t2 past the bound evicts the LRU tenant (t0)
    s2 = query_once("t2")
    snap = mux.snapshot()
    assert snap["resident"] == 2 and snap["evictions"] == 1
    rows = {r["app"]: r for r in snap["tenants"]}
    assert not rows["t0"]["resident"] and rows["t2"]["resident"]
    # the evicted tenant kept its lifecycle state but dropped the model
    assert rows["t0"]["instance"] is None and rows["t0"]["loads"] == 1
    # pins survive eviction
    s2.pinned["dead-beef"] = "validate"
    query_once("t0")
    snap = mux.snapshot()
    rows = {r["app"]: r for r in snap["tenants"]}
    assert rows["t0"]["resident"] and rows["t0"]["loads"] == 2
    evicted = [a for a in ("t1", "t2") if not rows[a]["resident"]]
    assert evicted == ["t1"]
    assert rows["t2"]["pinned"] == {"dead-beef": "validate"}
    assert snap["evictions"] == 2 and snap["coldLoads"] == 4


def test_eviction_never_drops_a_tenant_mid_query():
    storage = ts.memory_storage()
    for name in ("busy", "b", "c"):
        _mk_app(storage, name)
        _train(storage, name)
    _train(storage, "default-app")
    mux = _server(storage, max_resident=2)._tenants
    held = mux.admit("busy")        # an in-flight query: admit, no release
    mux.ensure_loaded(held)
    for name in ("b", "c"):
        st = mux.admit(name)
        mux.ensure_loaded(st)
        mux.release(st)
    rows = {r["app"]: r for r in mux.snapshot()["tenants"]}
    # the LRU-oldest tenant is busy: the scan skipped it and "b" paid
    assert rows["busy"]["resident"] and held.deployment is not None
    assert not rows["b"]["resident"] and rows["c"]["resident"]
    # the debt is collected at release, and the bound holds
    mux.release(held)
    assert mux.snapshot()["resident"] <= 2


def test_per_tenant_admission_budget_sheds_hot_app_only():
    storage = ts.memory_storage()
    for name in ("hot", "cold"):
        _mk_app(storage, name)
        _train(storage, name)
    _train(storage, "default-app")
    mux = _server(storage, max_resident=4, max_pending=2)._tenants
    a = mux.admit("hot")
    b = mux.admit("hot")
    with pytest.raises(AdmissionShed) as ei:
        mux.admit("hot")
    assert ei.value.reason == "tenant"
    c = mux.admit("cold")           # the cold tenant's budget is untouched
    rows = {r["app"]: r for r in mux.snapshot()["tenants"]}
    assert rows["hot"]["shed"] == 1 and rows["cold"]["shed"] == 0
    for st in (a, b, c):
        mux.release(st)
    mux.release(mux.admit("hot"))   # the budget freed: hot admits again


def test_poisoned_tenant_rolls_back_alone_in_process():
    storage = ts.memory_storage()
    for name in ("victim", "bystander"):
        _mk_app(storage, name)
        _train(storage, name)
    _train(storage, "default-app")
    mux = _server(storage, max_resident=4, swap_watch_ms=60_000,
                  swap_max_error_rate=0.3)._tenants
    for name in ("victim", "bystander"):
        st = mux.admit(name)
        mux.ensure_loaded(st)
        mux.release(st)
    victim = mux.admit("victim")
    mux.release(victim)
    good = victim.instance.id
    # a NEWER poisoned instance (it passes the golden-query gate) swaps in
    bad = _train(storage, "victim", tag="victim-poison", mode="poison")
    with victim.lock:
        mux._load_tenant_locked(victim, bad)
    assert victim.instance.id == bad and victim.previous is not None
    assert mux.note_result(victim, ok=True) is False
    assert mux.note_result(victim, ok=False) is False   # errors=1: no trip
    assert mux.note_result(victim, ok=False) is True    # errors=2: trip
    assert mux.rollback_tenant(victim, "error-rate") is not None
    assert victim.instance.id == good
    assert victim.pinned == {bad: "error-rate"}
    assert victim.rollbacks == {"error-rate": 1}
    rows = {r["app"]: r for r in mux.snapshot()["tenants"]}
    assert rows["bystander"]["pinned"] == {}
    assert rows["bystander"]["rollbacks"] == {}
    assert rows["bystander"]["instance"] is not None
    # a reload cannot re-pick the pinned poison
    again = mux.admit("victim")
    mux.release(again)
    assert again.instance.id == good


# -- over HTTP --------------------------------------------------------------------

N_APPS = 12
MAX_RESIDENT = 4


def _q(base, app, user):
    return ts.query(base, {"user": user}, headers={"X-Pio-App": app})


def test_apps_one_process_evictions_poison_isolated():
    """One server serves 12 apps with 4 resident slots: every app answers
    its own model's answer (lazy load), evictions happen, an evicted tenant
    answers after one reload, a bad key is 401, and a poisoned tenant rolls
    back alone while its neighbors answer 200."""
    storage = ts.memory_storage()
    apps = [f"app{i:02d}" for i in range(N_APPS)]
    iids = {}
    for name in apps:
        app_id = _mk_app(storage, name)
        storage.get_meta_data_access_keys().insert(
            AccessKey(f"KEY-{name}", app_id))
        iids[name] = _train(storage, name)
    default_app = apps[-1]     # the newest instance: the default deployment
    server = _server(storage, max_resident=MAX_RESIDENT,
                     swap_watch_ms=60_000, swap_max_error_rate=0.3)
    with ts.serving(server) as base:
        for name in apps:
            status, body, _ = _q(base, name, "golden")
            assert status == 200 and body["tag"] == name, (name, body)
        t = ts.status(base)["tenants"]
        assert t["maxResident"] == MAX_RESIDENT
        assert t["resident"] <= MAX_RESIDENT
        assert t["evictions"] >= N_APPS - 1 - MAX_RESIDENT, t
        assert t["known"] >= N_APPS - 1    # the default app rides classic
        rows = {r["app"]: r for r in t["tenants"]}
        assert not rows["app00"]["resident"]
        status, body, _ = _q(base, "app00", "golden")
        assert status == 200 and body["tag"] == "app00"
        # access-key routing; a bad key is 401, never the default's answer
        status, body, _ = ts.call(base, "POST",
                                  "/queries.json?accessKey=KEY-app01",
                                  {"user": "golden"})
        assert status == 200 and body["tag"] == "app01"
        assert ts.call(base, "POST", "/queries.json?accessKey=WRONG",
                       {"user": "golden"})[0] == 401
        assert _q(base, "never-registered", "golden")[0] == 404

        # poison ONE tenant: its next lazy load picks the newest instance,
        # which passes the golden gate
        poison = "app03"
        bad = _train(storage, poison, tag=f"{poison}-poison", mode="poison")
        status, body, _ = _q(base, poison, "golden")
        assert status == 200 and body["tag"] == f"{poison}-poison"
        assert _q(base, poison, "u1")[0] == 500   # errors=1: no breach yet
        # the second failure trips the watch: the walk-back restores the
        # good instance and the hedge answers THIS query
        status, body, _ = _q(base, poison, "u2")
        assert status == 200 and body["tag"] == poison
        rows = {r["app"]: r for r in ts.status(base)["tenants"]["tenants"]}
        assert rows[poison]["pinned"].get(bad) == "error-rate"
        assert rows[poison]["rollbacks"] == {"error-rate": 1}
        assert rows[poison]["instance"] == iids[poison]
        for name, other in rows.items():
            if name != poison:
                assert other["pinned"] == {}, name
                assert other["rollbacks"] == {}, name
                assert other["degraded"] is None, name
        for name in ("app00", "app01", "app05", "app09", default_app):
            status, body, _ = _q(base, name, "golden")
            assert status == 200 and body["tag"] == name
        status, body, _ = _q(base, poison, "u-after")
        assert status == 200 and body["tag"] == poison

        buf = io.StringIO()
        with redirect_stdout(buf):
            _print_engine_overload(base)
        out = buf.getvalue()
        assert "tenants:" in out
        warn = [ln for ln in out.splitlines()
                if poison in ln and "[warn]" in ln]
        assert warn and any("rollbacks=1" in ln for ln in warn), out


def test_tenant_budget_is_held_until_an_expired_query_finishes():
    """A tenant query past its deadline answers 504 at once, but keeps its
    slot of the tenant's budget until its compute ends (the process gate's
    orphan rule, per tenant)."""
    storage = ts.memory_storage()
    for name in ("slow", "default-app"):
        _mk_app(storage, name)
        _train(storage, name)
    server = _server(storage, max_resident=2, max_pending=1)
    with ts.serving(server) as base:
        status, _, _ = ts.query(base, {"user": "u1", "sleepS": 0.8},
                                headers={"X-Pio-App": "slow",
                                         "X-Pio-Deadline-Ms": "100"})
        assert status == 504

        def row():
            return {r["app"]: r for r in
                    ts.status(base)["tenants"]["tenants"]}["slow"]

        assert row()["pending"] == 1 and row()["inflight"] == 1
        # the budget (1) is still taken: the next query of this app sheds
        assert _q(base, "slow", "golden")[0] == 503
        assert ts.wait_for(lambda: row()["pending"] == 0, 10)
        assert _q(base, "slow", "golden")[0] == 200
        assert row()["shed"] == 1


def test_tenant_foldin_increment_invalidates_only_its_cache(tmp_path):
    """Each resident tenant folds its own app's events: one tenant's
    increment is published through its own gate and evicts only that
    tenant's cached results."""
    import torch_foldin_engine as fe
    from incubator_predictionio_torch.data.storage import DataMap, Event

    storage = Storage({
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "JL",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
        "PIO_STORAGE_SOURCES_JL_TYPE": "JSONL",
        "PIO_STORAGE_SOURCES_JL_PATH": str(tmp_path / "events")})
    le = storage.get_l_events()
    factory = "torch_foldin_engine.engine_factory"
    ids = {}
    for name in ("ta", "tb", "default-app"):
        ids[name] = _mk_app(storage, name)
        le.insert(Event("rate", "user", "u0", "item", "i0",
                        DataMap({"rating": 1.0})), ids[name])
        run_train(fe.engine_factory(), fe.engine_params(name),
                  WorkflowContext(app_name=name, storage=storage,
                                  device="cpu"),
                  engine_factory_name=factory)
        time.sleep(0.002)
    server = EngineServer(fe.engine_factory(), engine_factory_name=factory,
                          storage=storage, device="cpu",
                          tenant_max_resident=4, foldin_ms=60,
                          query_cache_size=100)
    with ts.serving(server) as base:
        for name in ("ta", "tb"):
            for user in ("u0", "newbie"):
                assert _q(base, name, user)[0] == 200
        cache = ts.status(base)["queryCache"]
        assert cache["entries"] == 4
        le.insert(Event("rate", "user", "newbie", "item", "i1",
                        DataMap({"rating": 5.0})), ids["ta"])
        known = ts.wait_for(lambda: _q(base, "ta", "newbie")[1].get("known"),
                            15)
        assert known
        rows = {r["app"]: r for r in ts.status(base)["tenants"]["tenants"]}
        assert rows["ta"]["foldinPublishes"] == 1 and rows["ta"]["swaps"] == 1
        assert rows["tb"]["foldinPublishes"] == 0 and rows["tb"]["swaps"] == 0
        hits = ts.status(base)["queryCache"]["hits"]
        # tb's entries survived the increment: both answered from the cache
        assert _q(base, "tb", "newbie")[1] == {"user": "newbie",
                                                "known": False}
        assert _q(base, "tb", "u0")[0] == 200
        assert ts.status(base)["queryCache"]["hits"] == hits + 2
