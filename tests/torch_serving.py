"""Shared helpers of the port's engine-server tests
(``tests/test_torch_engine_server.py``, ``test_torch_query_cache.py``,
``test_torch_query_overload.py``, ``test_torch_model_lifecycle.py``): an
in-memory port store seeded with the reference tests' ratings, a small
Recommendation train on the CPU, an HTTP client on ``http.client`` with a
timeout on every call, a serving context, and the port's copy of
``tests/lifecycle_engine.py`` (its models persist as arrays, not pickles).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as dt
import http.client
import json
import time

import numpy as np

from incubator_predictionio_torch.controller import (
    Algorithm, DataSource, Engine, EngineParams,
)
from incubator_predictionio_torch.data.storage import App, DataMap, Event, Storage
from incubator_predictionio_torch.models.recommendation import RecommendationEngine
from incubator_predictionio_torch.workflow.context import WorkflowContext
from incubator_predictionio_torch.workflow.core_workflow import run_train

#: tests/test_dase_train_e2e.py's ENGINE_PARAMS
ENGINE_JSON = {
    "datasource": {"params": {"app_name": "testapp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 8, "numIterations": 8, "lambda": 0.05}}],
}
ENGINE_PARAMS = EngineParams.from_json(ENGINE_JSON)
MEM_ENV = {
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    "PIO_STORAGE_SOURCES_MEM_TYPE": "MEMORY",
}


def rating_triples(n_users=30, n_items=20, seed=0):
    """tests/test_dase_train_e2e.py's ``_seed_ratings`` values: (user,
    item, rating, seconds after 2024-01-01)."""
    rng = np.random.default_rng(seed)
    xu = rng.standard_normal((n_users, 3))
    xi = rng.standard_normal((n_items, 3))
    out = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < 0.4:
                r = float(np.clip(xu[u] @ xi[i] + 3.0, 1, 5))
                out.append((str(u), f"i{i}", r, len(out)))
    return out


def seed_ratings(storage, app_name="testapp") -> int:
    app_id = storage.get_meta_data_apps().insert(App(0, app_name))
    le = storage.get_l_events()
    le.init(app_id)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    le.insert_batch([
        Event("rate", "user", u, "item", i, DataMap({"rating": r}),
              t0 + dt.timedelta(seconds=s))
        for u, i, r, s in rating_triples()], app_id)
    return app_id


def memory_storage() -> Storage:
    return Storage(dict(MEM_ENV))


def train(storage, factory="rec", params=ENGINE_PARAMS) -> str:
    """One Recommendation train on the CPU; returns the instance id."""
    iid = run_train(RecommendationEngine()(), params,
                    WorkflowContext(app_name="testapp", storage=storage,
                                    device="cpu"),
                    engine_factory_name=factory)
    time.sleep(0.002)  # strictly ordered start_times for the next train
    return iid


def call(base: str, method: str, path: str, body=None, headers=None,
         raw: bytes | None = None, timeout: float = 30):
    """One request on a fresh connection → (status, JSON body, headers)."""
    host, port = base.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read()
        return (resp.status, json.loads(payload) if payload else None,
                dict(resp.getheaders()))
    finally:
        conn.close()


def query(base: str, q, headers=None, timeout: float = 30):
    """POST /queries.json → (status, JSON body, headers)."""
    return call(base, "POST", "/queries.json", q, headers, timeout=timeout)


def status(base: str) -> dict:
    return call(base, "GET", "/status")[1]


@contextlib.contextmanager
def serving(server):
    """Serve ``server`` on a free port of 127.0.0.1; yields its base URL."""
    host, port = server.start("127.0.0.1", 0)
    try:
        yield f"http://{host}:{port}"
    finally:
        server.stop()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(fn, deadline_s: float = 15.0, interval: float = 0.05):
    """``fn()`` until it is truthy or the deadline passes; its last value."""
    end = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < end:
        last = fn()
        if last:
            return last
        time.sleep(interval)
    return last


# -- the port's copy of tests/lifecycle_engine.py ----------------------------


@dataclasses.dataclass
class LifecycleModel:
    """``mode=good`` answers every query; ``poison`` passes the swap gate
    (the golden query works, the arrays are finite) but raises on every
    other user; ``nan`` carries a NaN weight the gate's NaN guard must
    refuse."""

    tag: str
    mode: str
    weights: np.ndarray

    def example_query(self):
        return {"user": "golden"}


class LifecycleDataSource(DataSource):
    def read_training(self, ctx):
        return None


class LifecycleAlgorithm(Algorithm):
    def train(self, ctx, prepared_data):
        p = dict(self.params) if isinstance(self.params, dict) else {}
        mode = str(p.get("mode", "good"))
        weights = (np.array([1.0, float("nan")]) if mode == "nan"
                   else np.ones(3))
        return LifecycleModel(tag=str(p.get("tag", "")), mode=mode,
                              weights=weights)

    def predict(self, model, query):
        user = query["user"]
        if model.mode == "poison" and user != "golden":
            raise RuntimeError("poisoned model: predict exploded")
        # a poison model raises BEFORE sleeping, so a canary failure spends
        # none of the budget while a hedge can spend all of it
        delay = float(query.get("sleepS", 0) or 0)
        if delay:
            time.sleep(delay)
        return {"user": user, "tag": model.tag,
                "score": float(model.weights[0])}

    def prepare_model_for_persistence(self, model):
        return {"tag": model.tag, "mode": model.mode,
                "weights": np.asarray(model.weights)}

    def restore_model(self, stored, ctx):
        return LifecycleModel(str(stored["tag"]), str(stored["mode"]),
                              np.asarray(stored["weights"]))


def lifecycle_engine() -> Engine:
    return Engine(LifecycleDataSource, None, {"": LifecycleAlgorithm}, None)


def lifecycle_params(tag: str, mode: str = "good") -> EngineParams:
    return EngineParams(algorithm_params_list=[("", {"tag": tag,
                                                     "mode": mode})])


def train_lifecycle(storage, tag: str, mode: str = "good") -> str:
    iid = run_train(lifecycle_engine(), lifecycle_params(tag, mode),
                    WorkflowContext(app_name="lifeapp", storage=storage,
                                    device="cpu"),
                    engine_factory_name="lifecycle")
    time.sleep(0.002)
    return iid
