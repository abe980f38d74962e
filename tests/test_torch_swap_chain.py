"""The engine server's chain of unobserved swaps, driven without races.

An automatic publish (the refresh loop, the online fold-in) that lands
while the outgoing instance's post-swap watch is still open keeps the
last instance OBSERVED healthy as the previous deployment: the hedge
and the rollback target stay on it, and a rollback pins every instance
of the chain. These tests drive the swaps through ``_publish_once`` and
the queries through the real HTTP handler, with the watch's clock
stepped by hand, so no outcome depends on a sleep or a thread race.
"""

import dataclasses
import datetime as dt
import json
import time

import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.workflow import (  # noqa: E402
    create_server, model_artifact,
)
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    EngineServer,
)

WATCH_MS = 10_000.0


class _SteppedClock:
    """The ``time`` module as create_server sees it, with ``monotonic``
    shifted by a hand-set offset (everything else is the real clock)."""

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
    return c


@pytest.fixture()
def store():
    return ts.memory_storage()


def _server(storage):
    return EngineServer(ts.lifecycle_engine(), engine_factory_name="lifecycle",
                        storage=storage, device="cpu",
                        swap_watch_ms=WATCH_MS, swap_max_error_rate=0.5)


def _answers(base, users):
    out = []
    for u in users:
        code, doc, _ = ts.query(base, {"user": u})
        out.append((code, doc.get("tag") if code == 200 else None))
    return out


def _chain_state(server):
    with server._lock:
        prev = server._previous
        return (server.instance.id, prev[1].id if prev else None,
                list(server._chain))


def test_poisoned_chain_rolls_back_to_last_observed_and_pins_every_link(
        store, clock):
    """A is healthy; poisoned B and C swap in before B has answered two
    queries. C's failure is hedged onto A, trips the watch with B's, and
    the rollback restores A and pins both B and C: no re-pick after."""
    a = ts.train_lifecycle(store, "one")
    server = _server(store)
    with ts.serving(server) as base:
        b = ts.train_lifecycle(store, "b", mode="poison")
        assert server._publish_once("foldin") == "swapped"
        assert _chain_state(server) == (b, a, [b])
        assert _answers(base, ["u0"]) == [(200, "one")]
        clock.offset += WATCH_MS / 4e3          # inside B's window
        c = ts.train_lifecycle(store, "c", mode="poison")
        assert server._publish_once("foldin") == "swapped"
        # B was never observed: A stays the hedge and rollback target
        assert _chain_state(server) == (c, a, [b, c])
        assert _answers(base, ["u1", "u2", "u3"]) == [(200, "one")] * 3
        lc = ts.status(base)["lifecycle"]
        assert lc["instance"] == a and lc["previous"] is None
        assert lc["pinned"] == {b: "error-rate", c: "error-rate"}
        assert lc["rollbacks"] == {"error-rate": 1}
        # the walk and the refresh loop re-pick neither poisoned link
        assert server._publish_once("refresh") == "current"
        assert server._newer_candidate() is None
        assert server.instance.id == a


def test_watch_closed_clean_advances_the_baseline(store, clock):
    """B's watch closes without tripping: B is observed healthy, so the
    next swap makes B the previous deployment, and a poisoned C rolls
    back to B, pinning C alone."""
    a = ts.train_lifecycle(store, "one")
    server = _server(store)
    with ts.serving(server) as base:
        b = ts.train_lifecycle(store, "two")
        assert server._publish_once("foldin") == "swapped"
        assert _answers(base, ["u0", "u1"]) == [(200, "two")] * 2
        clock.offset += WATCH_MS / 1e3 + 0.001  # B's window has passed
        c = ts.train_lifecycle(store, "c", mode="poison")
        assert server._publish_once("foldin") == "swapped"
        assert _chain_state(server) == (c, b, [c])
        assert _answers(base, ["u2", "u3"]) == [(200, "two")] * 2
        lc = ts.status(base)["lifecycle"]
        assert (lc["instance"], lc["pinned"]) == (b, {c: "error-rate"})
        assert a not in lc["pinned"]


@pytest.mark.parametrize("past_ms,extends", [(0.0, True), (1.0, False)])
def test_swap_at_the_watch_edge_is_decided_on_one_clock_reading(
        store, clock, past_ms, extends):
    """A swap landing exactly as the outgoing watch closes: at the
    window's last instant the outgoing instance is still unobserved (the
    chain grows); one millisecond later it closed clean (it becomes the
    previous deployment). Both sides are decided under the lock."""
    a = ts.train_lifecycle(store, "one")
    server = _server(store)
    b = ts.train_lifecycle(store, "two")
    assert server._publish_once("foldin") == "swapped"
    with server._lock:
        until = server._watch["until"]
    c = ts.train_lifecycle(store, "three")
    # one reading for the whole swap: the window's end, or 1 ms past it
    clock.monotonic = lambda: until + past_ms / 1e3
    try:
        assert server._publish_once("foldin") == "swapped"
    finally:
        del clock.monotonic
    want = (c, a, [b, c]) if extends else (c, b, [c])
    assert _chain_state(server) == want


def test_the_chain_spans_at_most_one_watch_window(store, clock):
    """Automatic publishes wait once the chain began a whole window ago
    and the live watch is open ("deferred"); the wait ends when the live
    instance's own window closes, which makes it the previous deployment.
    An operator reload is never held back, and makes the outgoing
    instance the previous one."""
    a = ts.train_lifecycle(store, "one")
    server = _server(store)
    b = ts.train_lifecycle(store, "two")
    assert server._publish_once("foldin") == "swapped"
    clock.offset += WATCH_MS / 2e3
    c = ts.train_lifecycle(store, "three")
    assert server._publish_once("refresh") == "swapped"
    assert _chain_state(server) == (c, a, [b, c])
    clock.offset += WATCH_MS / 2e3 + 0.001      # the chain is one window old
    d = ts.train_lifecycle(store, "four")
    assert server._chain_full()
    assert server._publish_once("foldin") == "deferred"
    assert server._publish_once("refresh") == "deferred"
    assert _chain_state(server) == (c, a, [b, c])
    clock.offset += WATCH_MS / 2e3              # C's own window closed
    assert not server._chain_full()
    assert server._publish_once("foldin") == "swapped"
    assert _chain_state(server) == (d, c, [d])
    # an explicit load always swaps: the one-step rule
    server._load(b)
    assert _chain_state(server) == (b, d, [b])


def test_manual_rollback_pins_the_whole_chain(store, clock):
    a = ts.train_lifecycle(store, "one")
    server = _server(store)
    with ts.serving(server) as base:
        b = ts.train_lifecycle(store, "two")
        assert server._publish_once("foldin") == "swapped"
        c = ts.train_lifecycle(store, "three")
        assert server._publish_once("foldin") == "swapped"
        code, doc, _ = ts.call(base, "POST", "/rollback")
        assert code == 200 and doc["engineInstanceId"] == a
        lc = ts.status(base)["lifecycle"]
        assert lc["pinned"] == {b: "manual", c: "manual"}
        assert lc["rollbacks"] == {"manual": 1}


def test_a_chain_of_one_keeps_the_one_step_rule(store, clock):
    """No open watch on the outgoing instance (the initial deploy, a watch
    of 0 ms): every swap makes the outgoing instance the previous one."""
    a = ts.train_lifecycle(store, "one")
    server = EngineServer(ts.lifecycle_engine(),
                          engine_factory_name="lifecycle", storage=store,
                          device="cpu", swap_watch_ms=0)
    b = ts.train_lifecycle(store, "two")
    assert server._publish_once("foldin") == "swapped"
    assert _chain_state(server) == (b, a, [b])
    c = ts.train_lifecycle(store, "three")
    assert server._publish_once("foldin") == "swapped"
    assert _chain_state(server) == (c, b, [c])
    assert not server._chain_full()


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
    return inc.id


def test_walk_skips_increments_folded_through_a_pinned_instance(store):
    """An increment committed while publication waited, folded through a
    link the rollback pinned, carries the poison too: the refresh poll
    and the latest-completed walk skip it like the pinned link."""
    a = ts.train_lifecycle(store, "one")
    b = ts.train_lifecycle(store, "two")
    inc = _increment(store, b, [b])
    dao = store.get_meta_data_engine_instances()
    assert model_artifact.folded_through(dao.get(inc), {b})
    assert not model_artifact.folded_through(dao.get(inc), {a})
    assert not model_artifact.folded_through(dao.get(a), {a, b})
    newer = model_artifact.newer_completed_instance(
        dao, "lifecycle", "default", a, exclude={b})
    assert newer is None
    assert model_artifact.newer_completed_instance(
        dao, "lifecycle", "default", a, exclude=()).id == inc
    server = _server(store)
    assert server.instance.id == inc
    with server._lock:
        server._pinned[b] = "error-rate"
    server._load(None)
    assert server.instance.id == a
