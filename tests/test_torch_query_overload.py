"""Overload-safe serving of the port on the CPU: ``tests/test_query_overload.py``'s
contracts with a test engine whose ``predict`` sleeps (``sleepS`` in the
query; the port's fault modes other than ``fail`` wait for ROADMAP item
3.2): admission sheds 503 with a jittered integer ``Retry-After``, a spent
deadline answers 504 (the header tightens, loosens up to its cap, and a
malformed one falls back), an overrun worker is counted as orphaned and
keeps its slot until it finishes, the micro-batch path is gated and
deadlined too, ``/stop`` drains in process, concurrent reloads conflict
409, ``pio status --engine-url`` prints the counters, and a ``pio deploy
--device cpu`` process answers its in-flight query 200 after SIGTERM and
exits 0.
"""

import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from incubator_predictionio_torch.common import deadline  # noqa: E402
from incubator_predictionio_torch.tools.commands import management  # noqa: E402
from incubator_predictionio_torch.workflow.create_server import (  # noqa: E402
    EngineServer, _env_int,
)

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@pytest.fixture()
def store():
    storage = ts.memory_storage()
    ts.train_lifecycle(storage, "one")
    return storage


def _server(storage, **kw):
    return EngineServer(ts.lifecycle_engine(), engine_factory_name="lifecycle",
                        storage=storage, device="cpu", **kw)


def _slow(user, s):
    return {"user": user, "sleepS": s}


def test_admission_cap_sheds_excess_load(store):
    server = _server(store, query_conc=1, query_max_pending=2,
                     query_deadline_ms=20_000)
    n = 10
    with ts.serving(server) as base:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            rs = list(pool.map(lambda u: ts.query(base, _slow(f"u{u}", 0.3)),
                               range(n)))
        doc = ts.status(base)
    codes = [r[0] for r in rs]
    assert set(codes) <= {200, 503}, codes
    shed = [r for r in rs if r[0] == 503]
    assert 200 in codes and shed, codes
    for _, body, headers in shed:
        assert int(headers["Retry-After"]) >= 1
        assert "shed" in body["message"]
    ov = doc["overload"]
    assert ov["pendingLimit"] == 3 and ov["peakPending"] <= 3
    assert ov["shed"] == len(shed)
    assert doc["queryCount"] == codes.count(200)  # sheds never count


@pytest.mark.parametrize("window_ms", [0.0, 5.0], ids=["executor", "batcher"])
def test_gate_accounting_survives_thread_interleaving(store, window_ms):
    """24 clients against a gate of 2 + 3 slots with a thread switch
    forced every microsecond: every request is answered 200 or shed 503,
    the counters add up (no lost update) and every slot is returned."""
    server = _server(store, query_conc=2, query_max_pending=3,
                     batch_window_ms=window_ms, max_batch=4,
                     query_cache_size=2, query_deadline_ms=20_000)
    n_clients, per_client = 24, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ts.serving(server) as base:
            with concurrent.futures.ThreadPoolExecutor(n_clients) as pool:
                codes = [c for got in pool.map(
                    lambda k: [ts.query(base, {"user": f"u{(k + j) % 5}"})[0]
                               for j in range(per_client)], range(n_clients))
                    for c in got]
            assert ts.wait_for(
                lambda: ts.status(base)["overload"]["pending"] == 0, 10)
            doc = ts.status(base)
    finally:
        sys.setswitchinterval(old)
    assert len(codes) == n_clients * per_client
    assert set(codes) <= {200, 503}, set(codes)
    ov, cache = doc["overload"], doc["queryCache"]
    assert ov["peakPending"] <= 5 and ov["shed"] == codes.count(503)
    assert doc["queryCount"] == codes.count(200)
    assert cache["hits"] + cache["misses"] == len(codes)
    assert server._unanswered == 0


def test_retry_after_is_jittered():
    import random

    from incubator_predictionio_torch.common.resilience import (
        retry_after_jitter,
    )

    rng = random.Random(0)
    assert {retry_after_jitter(1.0, rng) for _ in range(200)} == {1, 2}
    assert {retry_after_jitter(2.0, rng) for _ in range(200)} == {
        1, 2, 3, 4}
    assert retry_after_jitter(0.0, rng) == 1


def test_micro_batch_path_is_admission_gated_too(store):
    server = _server(store, batch_window_ms=5.0, max_batch=4, query_conc=1,
                     query_max_pending=2, query_deadline_ms=20_000)
    with ts.serving(server) as base:
        with concurrent.futures.ThreadPoolExecutor(10) as pool:
            rs = list(pool.map(lambda u: ts.query(base, _slow(f"u{u}", 0.1)),
                               range(10)))
        ov = ts.status(base)["overload"]
    codes = [r[0] for r in rs]
    assert set(codes) <= {200, 503} and 503 in codes, codes
    assert ov["peakPending"] <= 3


def test_deadline_header_504_and_orphan_accounting(store):
    """A query that outlives its X-Pio-Deadline-Ms gets 504 before the
    slow model finishes; its worker can't be killed, so it is counted as
    orphaned, keeps its slot, and frees it when it finishes."""
    server = _server(store, query_conc=1, query_max_pending=2,
                     query_deadline_ms=20_000)
    with ts.serving(server) as base:
        t0 = time.perf_counter()
        code, doc, _ = ts.query(base, _slow("u1", 0.8),
                                headers={"X-Pio-Deadline-Ms": "100"})
        took = time.perf_counter() - t0
        assert code == 504 and "deadline" in doc["message"]
        assert took < 0.7, took
        ov = ts.status(base)["overload"]
        assert ov["deadlineExceeded"] == 1 and ov["orphaned"] == 1
        assert ov["pending"] >= 1  # the orphan still holds its slot
        assert ts.wait_for(
            lambda: ts.status(base)["overload"]["pending"] == 0, 10)
        assert ts.query(base, {"user": "u1"})[0] == 200


def test_deadline_default_header_override_and_poison_values(store,
                                                             monkeypatch):
    """The server default governs; the header tightens and loosens up to
    PIO_QUERY_DEADLINE_MAX_MS; "0", negative, nan, inf and malformed
    headers fall back to the default."""
    monkeypatch.setenv("PIO_QUERY_DEADLINE_MAX_MS", "300")
    server = _server(store, query_conc=4, query_max_pending=8,
                     query_deadline_ms=60)
    assert server.query_deadline_max_ms == 300
    with ts.serving(server) as base:
        slow = _slow("u1", 0.15)
        assert ts.query(base, slow)[0] == 504
        code, doc, _ = ts.query(base, slow,
                                headers={"X-Pio-Deadline-Ms": "1000"})
        assert code == 200, doc
        for poison in ("bananas", "0", "-5", "nan", "inf"):
            assert ts.query(base, slow, headers={
                "X-Pio-Deadline-Ms": poison})[0] == 504, poison
        # loosened past the ceiling: capped at 300 ms
        assert ts.query(base, _slow("u1", 0.4), headers={
            "X-Pio-Deadline-Ms": "500000"})[0] == 504
        # a tight header beats a slow-enough model
        assert ts.query(base, {"user": "u1"}, headers={
            "X-Pio-Deadline-Ms": "0.001"})[0] == 504
    assert server.overload_snapshot()["deadlineExceeded"] == 8
    with pytest.raises(ValueError):
        deadline.Deadline(float("nan"))


def test_deadline_rides_into_the_worker_and_stops_the_next_stage(
        monkeypatch):
    """The budget crosses into the worker thread through the copied
    context: Deployment.query's spend-point between predict and serve
    raises once it is spent. The deadline reads a clock the test moves,
    only inside ``predict``: however late the pool's thread starts, the
    budget is whole at the spend-point before predict and spent at the
    one after it."""
    now = [0.0]
    monkeypatch.setattr(deadline, "time",
                        types.SimpleNamespace(monotonic=lambda: now[0]))
    dl = deadline.Deadline(10)
    seen = []

    class Serving:
        def supplement(self, q):
            return q

        def serve(self, q, preds):
            seen.append("serve")
            return preds[0]

    class Algo:
        def predict(self, model, q):
            now[0] += 0.03  # predict outlasts the 10 ms budget
            return q

    from incubator_predictionio_torch.controller.engine import Deployment

    dep = Deployment([("", Algo())], [None], Serving())
    with deadline.running(dl):
        import contextvars

        ctx = contextvars.copy_context()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ctx.run, dep.query, {"user": "u"})
        with pytest.raises(deadline.DeadlineExceeded) as ei:
            fut.result(5)
    assert ei.value.stage == "query.serve" and not seen
    assert deadline.current() is None  # the caller's context is untouched


def test_env_int_tolerates_overflow(monkeypatch):
    for bad in ("bananas", "inf", "-inf", "nan", "1e999"):
        monkeypatch.setenv("PIO_QUERY_CONC", bad)
        assert _env_int("PIO_QUERY_CONC", 7) == 7, bad
    monkeypatch.setenv("PIO_QUERY_CONC", "1e1")
    assert _env_int("PIO_QUERY_CONC", 7) == 10


def test_batch_path_deadline_504_and_cancelled_entries_dropped(store):
    """A query whose budget runs out while queued in the batch window gets
    504 and never reaches batch_query; the batcher keeps serving."""
    server = _server(store, batch_window_ms=150.0, max_batch=8, query_conc=1,
                     query_max_pending=4, query_deadline_ms=20_000)
    dispatched = []
    real = server.deployment.batch_query

    def spying(queries):
        dispatched.append(len(queries))
        return real(queries)

    server.deployment.batch_query = spying
    with ts.serving(server) as base:
        code, doc, _ = ts.query(base, {"user": "u1"},
                                headers={"X-Pio-Deadline-Ms": "5"})
        assert code == 504 and "batch queue" in doc["message"]
        time.sleep(0.2)     # the window closes on the dead entry
        assert ts.query(base, {"user": "u1"})[0] == 200
        # a slow batch: its query's deadline expires mid-dispatch → 504
        code, _, _ = ts.query(base, _slow("u2", 0.3),
                              headers={"X-Pio-Deadline-Ms": "250"})
        assert code == 504
        assert ts.wait_for(
            lambda: ts.status(base)["overload"]["pending"] == 0, 10)
        assert ts.query(base, {"user": "u3"})[0] == 200
    assert dispatched == [1, 1, 1], dispatched


def test_stop_drains_inflight_and_sheds_new(store):
    server = _server(store, query_conc=2, query_max_pending=4,
                     query_deadline_ms=20_000, drain_deadline_ms=10_000)
    slow = {}
    with ts.serving(server) as base:
        assert ts.call(base, "GET", "/readyz")[0] == 200
        t = threading.Thread(target=lambda: slow.update(
            r=ts.query(base, _slow("u1", 1.0))))
        t.start()
        assert ts.wait_for(
            lambda: ts.status(base)["overload"]["pending"] == 1, 5)
        assert ts.call(base, "POST", "/stop")[1]["message"] == "Shutting down."
        code, doc, _ = ts.call(base, "GET", "/readyz")
        assert code == 503 and doc["draining"] is True
        code, doc, headers = ts.query(base, {"user": "u2"})
        assert code == 503 and "drain" in doc["message"]
        assert int(headers["Retry-After"]) >= 1
        assert ts.call(base, "POST", "/stop")[1]["message"] == \
            "Already draining."
        t.join(15)
        assert not t.is_alive()
    code, doc, _ = slow["r"]
    assert code == 200 and doc["tag"] == "one"


def test_reload_concurrent_conflict_409(store):
    server = _server(store)
    real_load = server._load

    def slow_load(instance_id):
        time.sleep(0.3)
        return real_load(instance_id)

    server._load = slow_load
    with ts.serving(server) as base:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            rs = list(pool.map(lambda _: ts.call(base, "GET", "/reload"),
                               range(2)))
        codes = sorted(r[0] for r in rs)
        assert codes == [200, 409], rs
        loser = next(r for r in rs if r[0] == 409)
        assert "already in progress" in loser[1]["message"]
        assert ts.status(base)["overload"]["reloadConflicts"] == 1
        assert ts.query(base, {"user": "u1"})[0] == 200


def test_pio_status_engine_url_reports_overload(store, capsys):
    server = _server(store, query_conc=2, query_max_pending=6)
    with ts.serving(server) as base:
        assert ts.query(base, {"user": "u1"})[0] == 200
        management._print_engine_overload(base)
    out = capsys.readouterr().out
    assert "serving: pending 0/8" in out
    assert "shed=0" in out and "deadlineExceeded=0" in out
    assert "draining=False" in out and "1 queries served" in out
    assert "lifecycle: previous None" in out
    management._print_engine_overload("http://127.0.0.1:9")
    assert "unreachable" in capsys.readouterr().out


def _sqlite_env(tmp_path):
    return {"PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite")}


def deploy_process(tmp_path, extra_args=(), extra_env=None):
    """``pio deploy --device cpu`` of the lifecycle engine in its own
    process on a free port → (Popen, base URL). The store is SQLite in
    ``tmp_path``; the engine is tests/torch_serving.py's."""
    from incubator_predictionio_torch.data.storage import Storage
    from incubator_predictionio_torch.workflow.context import WorkflowContext
    from incubator_predictionio_torch.workflow.core_workflow import run_train

    env_store = _sqlite_env(tmp_path)
    factory = "torch_serving.lifecycle_engine"
    if not (tmp_path / "engine.json").exists():
        storage = Storage(env_store)
        run_train(ts.lifecycle_engine(), ts.lifecycle_params("one"),
                  WorkflowContext(app_name="lifeapp", storage=storage,
                                  device="cpu"),
                  engine_factory_name=factory)
        storage.close()
        (tmp_path / "engine.json").write_text(json.dumps({
            "engineFactory": factory, "algorithms": [
                {"name": "", "params": {"tag": "one"}}]}))
    port = ts.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_STORAGE_", "PIO_FAULT"))}
    env.update(env_store, PYTHONPATH=os.pathsep.join([str(ROOT), str(HERE)]),
               **(extra_env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_predictionio_torch.tools.console",
         "deploy", "--device", "cpu", "--engine-dir", str(tmp_path),
         "--ip", "127.0.0.1", "--port", str(port), *extra_args],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"

    def up():
        if proc.poll() is not None:
            raise AssertionError(f"deploy exited {proc.returncode}: "
                                 f"{proc.stdout.read()[-3000:]}")
        try:
            return ts.call(base, "GET", "/readyz", timeout=2)[0] == 200
        except OSError:
            return False

    assert ts.wait_for(up, 120, 0.1), "deploy never became ready"
    return proc, base


def test_deploy_process_sigterm_drains_inflight_and_exits_0(tmp_path):
    proc, base = deploy_process(tmp_path, ["--drain-deadline-ms", "5000"])
    try:
        slow = {}
        t = threading.Thread(target=lambda: slow.update(
            r=ts.query(base, _slow("u1", 1.0))))
        t.start()
        assert ts.wait_for(
            lambda: ts.status(base)["overload"]["pending"] == 1, 10)
        proc.send_signal(signal.SIGTERM)
        code, doc, _ = ts.wait_for(
            lambda: (lambda r: r if r[0] == 503 else None)(
                ts.call(base, "GET", "/readyz")), 5, 0.02)
        assert code == 503 and doc["draining"] is True
        t.join(15)
        assert not t.is_alive()
        assert proc.wait(timeout=30) == 0, proc.stdout.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    code, doc, _ = slow["r"]
    assert code == 200 and doc["tag"] == "one"
