"""A tenant's chain of unobserved swaps, driven without races.

The seven cases of ``tests/test_torch_swap_chain.py`` on one tenant of the
mux (``workflow/multitenant.py``): a fold-in publish that lands while the
tenant's outgoing watch is still open keeps the last instance OBSERVED
healthy as the tenant's previous deployment, a rollback pins every link
of the chain, publishes wait once the chain is a window old, and the
walks skip increments folded through a pinned instance. Swaps go through
the tenant's ``_publish_tenant``, queries through the engine server's
HTTP handler with ``X-Pio-App``, and the watch's clock is stepped by hand.

Where the tenant's answers differ from the default deployment's, it is the
mux's own query rule: a tenant's failure is answered 500 until its watch
trips, and the tripping query is answered on the restored deployment.
"""

import dataclasses
import datetime as dt
import json
import time

import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.data.storage import App  # noqa: E402
from incubator_predictionio_torch.workflow import (  # noqa: E402
    create_server, model_artifact, multitenant,
)
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.core_workflow import run_train  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    EngineServer,
)

pytestmark = [pytest.mark.multitenant]

WATCH_MS = 10_000.0
FACTORY = "torch_serving.lifecycle_engine"
APP = "tenant"
DEFAULT_APP = "default-app"


class _SteppedClock:
    """The ``time`` module as the engine server and the mux see it, with
    ``monotonic`` shifted by a hand-set offset (everything else is the
    real clock)."""

    def __init__(self):
        self.offset = 0.0

    def monotonic(self):
        return time.monotonic() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def clock(monkeypatch):
    c = _SteppedClock()
    monkeypatch.setattr(create_server, "_time", c)
    monkeypatch.setattr(multitenant, "time", c)
    return c


@pytest.fixture()
def store():
    s = ts.memory_storage()
    for name in (APP, DEFAULT_APP):
        s.get_meta_data_apps().insert(App(0, name))
    return s


def _train(storage, tag: str, mode: str = "good", app: str = APP) -> str:
    iid = run_train(ts.lifecycle_engine(), ts.lifecycle_params(tag, mode),
                    WorkflowContext(app_name=app, storage=storage,
                                    device="cpu"),
                    engine_factory_name=FACTORY)
    time.sleep(0.002)  # strictly ordered start_times
    return iid


def _server(storage, watch_ms: float = WATCH_MS):
    """The default app's instance is trained last, so the process's
    default deployment is that app's and the tenant rides the mux."""
    _train(storage, "default", app=DEFAULT_APP)
    return EngineServer(ts.lifecycle_engine(), engine_factory_name=FACTORY,
                        storage=storage, device="cpu", tenant_max_resident=4,
                        swap_watch_ms=watch_ms, swap_max_error_rate=0.5)


def _tenant(server):
    """The tenant's state, loaded (its newest instance, lazily)."""
    mux = server._tenants
    state = mux.admit(APP)
    try:
        mux.ensure_loaded(state)
    finally:
        mux.release(state)
    return state


def _answers(base, users):
    out = []
    for u in users:
        code, doc, _ = ts.query(base, {"user": u}, headers={"X-Pio-App": APP})
        out.append((code, doc.get("tag") if code == 200 else None))
    return out


def _row(base) -> dict:
    rows = ts.status(base)["tenants"]["tenants"]
    return next(r for r in rows if r["app"] == APP)


def _chain_state(state):
    with state.lock:
        prev = state.chain.previous
        return (state.instance.id, prev[1].id if prev else None,
                list(state.chain.links))


def test_poisoned_chain_rolls_back_to_last_observed_and_pins_every_link(
        store, clock):
    """A is healthy; poisoned B swaps in, and C, folded through B, swaps
    in before B has answered two queries. C's first failure, counted
    with B's, trips the tenant's watch: the rollback restores A (never
    the unobserved B) and pins both B and C: no re-pick after."""
    a = _train(store, "one")
    server = _server(store)
    with ts.serving(server) as base:
        mux = server._tenants
        state = _tenant(server)
        b = _train(store, "b", mode="poison")
        mux._publish_tenant(state)
        row = _row(base)
        assert (row["instance"], row["previous"]) == (b, a)
        assert _answers(base, ["u0"]) == [(500, None)]
        clock.offset += WATCH_MS / 4e3          # inside B's window
        c = _train(store, "c", mode="poison")
        mux._publish_tenant(state)
        row = _row(base)
        # B was never observed: A stays the rollback target
        assert (row["instance"], row["previous"]) == (c, a)
        assert _answers(base, ["u1", "u2", "u3"]) == [(200, "one")] * 3
        row = _row(base)
        assert row["instance"] == a and row["previous"] is None
        assert row["pinned"] == {b: "error-rate", c: "error-rate"}
        assert row["rollbacks"] == {"error-rate": 1}
        # the walk and the fold-in publish re-pick neither poisoned link
        assert mux._publish_tenant(state) == "current"
        assert model_artifact.newer_completed_instance(
            store.get_meta_data_engine_instances(), FACTORY,
            server.engine_variant, state.instance,
            exclude=set(state.pinned), app_name=APP) is None
        assert state.instance.id == a


def test_watch_closed_clean_advances_the_baseline(store, clock):
    """B's watch closes without tripping: B is observed healthy, so the
    next swap makes B the previous deployment, and a poisoned C rolls
    back to B, pinning C alone."""
    a = _train(store, "one")
    server = _server(store)
    with ts.serving(server) as base:
        mux = server._tenants
        state = _tenant(server)
        b = _train(store, "two")
        assert mux._publish_tenant(state) == "swapped"
        assert _answers(base, ["u0", "u1"]) == [(200, "two")] * 2
        clock.offset += WATCH_MS / 1e3 + 0.001  # B's window has passed
        c = _train(store, "c", mode="poison")
        assert mux._publish_tenant(state) == "swapped"
        assert _chain_state(state) == (c, b, [c])
        assert _answers(base, ["u2", "u3"]) == [(500, None), (200, "two")]
        row = _row(base)
        assert (row["instance"], row["pinned"]) == (b, {c: "error-rate"})
        assert a not in row["pinned"]


@pytest.mark.parametrize("past_ms,extends", [(0.0, True), (1.0, False)])
def test_swap_at_the_watch_edge_is_decided_on_one_clock_reading(
        store, clock, past_ms, extends):
    """A swap landing exactly as the tenant's outgoing watch closes: at
    the window's last instant the outgoing instance is still unobserved
    (the chain grows); one millisecond later it closed clean (it becomes
    the previous deployment). Both sides are decided under the tenant's
    lock."""
    a = _train(store, "one")
    server = _server(store)
    mux = server._tenants
    state = _tenant(server)
    b = _train(store, "two")
    assert mux._publish_tenant(state) == "swapped"
    with state.lock:
        until = state.chain.watch["until"]
    c = _train(store, "three")
    # one reading for the whole swap: the window's end, or 1 ms past it
    clock.monotonic = lambda: until + past_ms / 1e3
    try:
        assert mux._publish_tenant(state) == "swapped"
    finally:
        del clock.monotonic
    want = (c, a, [b, c]) if extends else (c, b, [c])
    assert _chain_state(state) == want


def test_the_chain_spans_at_most_one_watch_window(store, clock):
    """Fold-in publishes wait once the tenant's chain began a whole
    window ago and the live watch is open ("deferred"); the wait ends
    when the live instance's own window closes, which makes it the
    previous deployment. An operator load is never held back, and makes
    the outgoing instance the previous one."""
    a = _train(store, "one")
    server = _server(store)
    mux = server._tenants
    state = _tenant(server)
    b = _train(store, "two")
    assert mux._publish_tenant(state) == "swapped"
    clock.offset += WATCH_MS / 2e3
    c = _train(store, "three")
    assert mux._publish_tenant(state) == "swapped"
    assert _chain_state(state) == (c, a, [b, c])
    clock.offset += WATCH_MS / 2e3 + 0.001      # the chain is one window old
    d = _train(store, "four")
    with state.lock:
        assert state.chain.full(c, multitenant.time.monotonic(), WATCH_MS)
    assert mux._publish_tenant(state) == "deferred"
    assert mux._publish_tenant(state) == "deferred"
    assert _chain_state(state) == (c, a, [b, c])
    clock.offset += WATCH_MS / 2e3              # C's own window closed
    assert mux._publish_tenant(state) == "swapped"
    assert _chain_state(state) == (d, c, [d])
    # an explicit load always swaps: the one-step rule
    with state.lock:
        mux._load_tenant_locked(state, b)
    assert _chain_state(state) == (b, d, [b])


def test_manual_rollback_pins_the_whole_chain(store, clock):
    a = _train(store, "one")
    server = _server(store)
    with ts.serving(server) as base:
        mux = server._tenants
        state = _tenant(server)
        b = _train(store, "two")
        assert mux._publish_tenant(state) == "swapped"
        c = _train(store, "three")
        assert mux._publish_tenant(state) == "swapped"
        restored = mux.rollback_tenant(state, "manual")
        assert restored is not None and state.instance.id == a
        assert _answers(base, ["u0"]) == [(200, "one")]
        row = _row(base)
        assert row["pinned"] == {b: "manual", c: "manual"}
        assert row["rollbacks"] == {"manual": 1}


def test_a_chain_of_one_keeps_the_one_step_rule(store, clock):
    """No open watch on the outgoing instance (a watch of 0 ms): every
    swap makes the outgoing instance the previous one."""
    a = _train(store, "one")
    server = _server(store, watch_ms=0)
    mux = server._tenants
    state = _tenant(server)
    b = _train(store, "two")
    assert mux._publish_tenant(state) == "swapped"
    assert _chain_state(state) == (b, a, [b])
    c = _train(store, "three")
    assert mux._publish_tenant(state) == "swapped"
    assert _chain_state(state) == (c, b, [c])
    with state.lock:
        assert not state.chain.full(c, multitenant.time.monotonic(), 0.0)


def _increment(storage, of: str, bases) -> str:
    """A COMPLETED fold-in increment row of instance ``of`` whose marker
    names ``bases``."""
    dao = storage.get_meta_data_engine_instances()
    row = dao.get(of)
    now = dt.datetime.now(dt.timezone.utc)
    inc = dataclasses.replace(
        row, id=f"inc-{of}", status="COMPLETED", start_time=now,
        end_time=now,
        runtime_conf={**(row.runtime_conf or {}),
                      "foldin": json.dumps({"of": of, "bases": bases})})
    dao.insert(inc)
    model_artifact.write_model(
        storage, inc.id, model_artifact.read_model(storage, of))
    time.sleep(0.002)
    return inc.id


def test_walk_skips_increments_folded_through_a_pinned_instance(store):
    """An increment of the tenant committed while publication waited,
    folded through a link the rollback pinned, carries the poison too:
    the tenant's publish walk and its load walk skip it like the pinned
    link."""
    a = _train(store, "one")
    b = _train(store, "two")
    inc = _increment(store, b, [b])
    dao = store.get_meta_data_engine_instances()
    assert model_artifact.folded_through(dao.get(inc), {b})
    assert not model_artifact.folded_through(dao.get(inc), {a})
    assert not model_artifact.folded_through(dao.get(a), {a, b})
    newer = model_artifact.newer_completed_instance(
        dao, FACTORY, "default", a, exclude={b}, app_name=APP)
    assert newer is None
    assert model_artifact.newer_completed_instance(
        dao, FACTORY, "default", a, exclude=(), app_name=APP).id == inc
    server = _server(store)
    mux = server._tenants
    state = _tenant(server)
    assert state.instance.id == inc
    with state.lock:
        state.pinned[b] = "error-rate"
        mux._load_tenant_locked(state)
    assert state.instance.id == a
