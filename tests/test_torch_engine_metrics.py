"""The engine server's ``/metrics`` and serving traces, on the CPU.

- **Family set.** One scripted scenario runs in both packages: a storage
  server over an in-memory store, an engine server whose store is that
  server (TYPE=HTTP), a train, two identical queries with the result cache
  armed, ``GET /metrics``. The set of (name, type, label names) of the
  families in scope — the query stages, the ``pio_engine_*`` gauges, the
  query cache, fold-in, quality, tenants, model integrity, storage
  transport and breakers — equals the reference's.
- **Stage histograms.** ``pio_query_stage_seconds{stage,batched}`` counts
  one observation per stage per query on the single path and one per
  micro-batch on the batched path.
- **Spans.** A query carrying ``X-Pio-Trace-Id`` under ``PIO_TRACE`` gets
  the ``query.featurize`` / ``query.predict`` / ``query.serve`` spans and
  the ``http`` root span under that id, with the reference's span names
  and tag keys; the answer echoes the id.
- **Gauges against ``/status``.** The engine gauges and the query-cache
  counters read what ``/status`` reports; the dashboard serves the same
  registry.
"""

import json
import re

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import requests  # noqa: E402

import torch_serving as ts  # noqa: E402
from incubator_predictionio_tpu.common import telemetry as ref_telemetry  # noqa: E402
from incubator_predictionio_torch.common import telemetry  # noqa: E402
from incubator_predictionio_torch.data.api.storage_server import StorageServer  # noqa: E402
from incubator_predictionio_torch.data.storage import Storage  # noqa: E402
from incubator_predictionio_torch.models.recommendation import (  # noqa: E402
    RecommendationEngine,
)
from incubator_predictionio_torch.workflow import (  # noqa: E402, F401
    multitenant, online, quality,
)
from incubator_predictionio_torch.workflow.create_server import EngineServer  # noqa: E402

#: the engine server's families this slice brings, by name prefix
SCOPE = ("pio_query_stage_seconds", "pio_query_cache_", "pio_engine_",
         "pio_foldin_", "pio_tenant_", "pio_model_", "pio_storage_")
QUERY = {"user": "1", "num": 3}


def _http_env(port):
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "NET"
            for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_NET_TYPE": "HTTP",
        "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
        "PIO_STORAGE_SOURCES_NET_PORTS": str(port)}


def _families(text, registry):
    """{(name, type, label names)} of the in-scope families on a page."""
    by_name = {f.name: f for f in registry.collect()}
    out = set()
    for name, kind in re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M):
        if name.startswith(SCOPE):
            out.add((name, kind, tuple(by_name[name].labelnames)))
    return out


def _port_scenario():
    backing = ts.memory_storage()
    ts.seed_ratings(backing)
    store = StorageServer(backing, "127.0.0.1", 0)
    port = store.start()[1]
    try:
        client = Storage(_http_env(port))
        ts.train(client)
        server = EngineServer(RecommendationEngine()(),
                              engine_factory_name="rec", storage=client,
                              device="cpu", query_cache_size=16)
        with ts.serving(server) as base:
            for _ in range(2):
                assert ts.query(base, QUERY)[0] == 200
            host, p = base.rsplit("/", 1)[-1].split(":")
            text = requests.get(f"http://{host}:{p}/metrics", timeout=30)
            status = ts.status(base)
    finally:
        store.stop()
    assert text.headers["Content-Type"].startswith("text/plain")
    return text.text, status


def _ref_scenario(memory_storage):
    from incubator_predictionio_tpu.data.api.storage_server import build_app
    from incubator_predictionio_tpu.data.storage import Storage as RefStorage
    from incubator_predictionio_tpu.models.recommendation import (
        RecommendationEngine as RefEngine,
    )
    from incubator_predictionio_tpu.workflow import (  # noqa: F401
        multitenant as _m, online as _o, quality as _q,
    )
    from incubator_predictionio_tpu.workflow.context import WorkflowContext
    from incubator_predictionio_tpu.workflow.core_workflow import run_train
    from incubator_predictionio_tpu.workflow.create_server import (
        EngineServer as RefEngineServer,
    )
    from server_utils import ServerThread
    from test_dase_train_e2e import ENGINE_PARAMS, _seed_ratings

    _seed_ratings(memory_storage)
    with ServerThread(build_app(memory_storage)) as store:
        client = RefStorage(_http_env(store.port))
        engine = RefEngine()()
        run_train(engine, ENGINE_PARAMS,
                  WorkflowContext(app_name="testapp", storage=client),
                  engine_factory_name="rec")
        ref = RefEngineServer(engine, engine_factory_name="rec",
                              storage=client, query_cache_size=16)
        with ServerThread(ref.app) as st:
            for _ in range(2):
                r = requests.post(st.base + "/queries.json", json=QUERY,
                                  timeout=30)
                assert r.status_code == 200
            return requests.get(st.base + "/metrics", timeout=30).text


def test_metrics_family_set_equals_reference(memory_storage):
    port_text, _ = _port_scenario()
    ref_text = _ref_scenario(memory_storage)
    port = _families(port_text, telemetry.registry())
    ref = _families(ref_text, ref_telemetry.registry())
    assert port == ref
    names = {n for n, _, _ in port}
    for want in ("pio_query_stage_seconds", "pio_engine_query_count",
                 "pio_engine_rollbacks_total", "pio_engine_compile_seconds",
                 "pio_query_cache_hits_total", "pio_foldin_events_total",
                 "pio_engine_quality_samples_total", "pio_tenant_resident",
                 "pio_storage_op_seconds", "pio_storage_breaker_state"):
        assert want in names


def _sample(text, name, **labels):
    """The value of one sample line of a Prometheus page (0 if absent)."""
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        head, _, value = line.rpartition(" ")
        m = re.fullmatch(re.escape(name) + r"(\{.*\})?", head)
        if not m:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
        if got == {k: str(v) for k, v in labels.items()}:
            return float(value)
    return 0.0


def test_gauges_and_cache_counters_read_what_status_shows():
    text, status = _port_scenario()
    assert _sample(text, "pio_engine_query_count") == status["queryCount"]
    assert _sample(text, "pio_engine_query_shed_total") == \
        status["overload"]["shed"]
    assert _sample(text, "pio_engine_model_swaps_total") == \
        status["lifecycle"]["swaps"]
    assert _sample(text, "pio_engine_rollbacks_total",
                   reason="error-rate") == 0
    assert status["queryCache"]["hits"] == 1
    assert _sample(text, "pio_query_cache_hits_total") >= 1
    assert _sample(text, "pio_storage_op_seconds_count",
                   backend="http.call") > 0
    assert _sample(text, "pio_storage_breaker_state",
                   endpoint=f"http:http://127.0.0.1:"
                   f"{_endpoint_port(text)}") == 0


def _endpoint_port(text):
    m = re.search(r'pio_storage_breaker_state\{endpoint="http:http://'
                  r'127\.0\.0\.1:(\d+)"\}', text)
    return m.group(1) if m else "?"


@pytest.mark.parametrize("window_ms", [0.0, 40.0], ids=["single", "batched"])
def test_stage_histograms_count_queries(window_ms):
    storage = ts.memory_storage()
    ts.seed_ratings(storage)
    ts.train(storage)
    batched = "1" if window_ms else "0"

    def counts():
        text = telemetry.render_all()
        return {stage: _sample(text, "pio_query_stage_seconds_count",
                               stage=stage, batched=batched)
                for stage in ("featurize", "predict", "serve")}

    server = EngineServer(RecommendationEngine()(), engine_factory_name="rec",
                          storage=storage, device="cpu",
                          batch_window_ms=window_ms, max_batch=8)
    before = counts()  # after the warm-up's batches
    with ts.serving(server) as base:
        for u in range(3):
            assert ts.query(base, {"user": str(u), "num": 2})[0] == 200
    after = counts()
    # one observation per stage per query (single) or per micro-batch
    # (batched: sequential queries each close their own window)
    assert {k: after[k] - before[k] for k in after} == {
        "featurize": 3, "predict": 3, "serve": 3}


def _spans(path, trace_id):
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {s["span"]: sorted((s.get("tags") or {}))
            for s in rows if s["traceId"] == trace_id}


def test_query_spans_match_reference(tmp_path, memory_storage):
    from incubator_predictionio_tpu.models.recommendation import (
        RecommendationEngine as RefEngine,
    )
    from incubator_predictionio_tpu.workflow.context import WorkflowContext
    from incubator_predictionio_tpu.workflow.core_workflow import run_train
    from incubator_predictionio_tpu.workflow.create_server import (
        EngineServer as RefEngineServer,
    )
    from server_utils import ServerThread
    from test_dase_train_e2e import ENGINE_PARAMS, _seed_ratings

    port_sink, ref_sink = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    telemetry.configure_tracer(rate=1e-9, sink=str(port_sink))
    ref_telemetry.configure_tracer(rate=1e-9, sink=str(ref_sink))
    try:
        storage = ts.memory_storage()
        ts.seed_ratings(storage)
        ts.train(storage)
        server = EngineServer(RecommendationEngine()(),
                              engine_factory_name="rec", storage=storage,
                              device="cpu")
        with ts.serving(server) as base:
            assert ts.query(base, QUERY)[0] == 200  # not sampled
            code, _, headers = ts.query(
                base, QUERY, headers={"X-Pio-Trace-Id": "trace-port-1"})
        assert code == 200 and headers["X-Pio-Trace-Id"] == "trace-port-1"
        _seed_ratings(memory_storage)
        engine = RefEngine()()
        run_train(engine, ENGINE_PARAMS,
                  WorkflowContext(app_name="testapp", storage=memory_storage),
                  engine_factory_name="rec")
        ref = RefEngineServer(engine, engine_factory_name="rec",
                              storage=memory_storage)
        with ServerThread(ref.app) as st:
            r = requests.post(st.base + "/queries.json", json=QUERY,
                              headers={"X-Pio-Trace-Id": "trace-ref-1"},
                              timeout=30)
            assert r.status_code == 200
    finally:
        telemetry.configure_tracer(rate=0.0)
        ref_telemetry.configure_tracer(rate=0.0)
    port = _spans(port_sink, "trace-port-1")
    ref = _spans(ref_sink, "trace-ref-1")
    assert port == ref
    assert {"query.featurize", "query.predict", "query.serve",
            "http POST /queries.json"} <= set(port)
    # the unsampled query wrote nothing
    with open(port_sink) as f:
        assert {json.loads(line)["traceId"] for line in f} == {
            "trace-port-1"}


def test_dashboard_serves_the_registry():
    from incubator_predictionio_torch.tools.dashboard import Dashboard

    dash = Dashboard(ts.memory_storage(), "127.0.0.1", 0)
    host, port = dash.start()
    try:
        text = requests.get(f"http://{host}:{port}/metrics", timeout=30)
        page = requests.get(f"http://{host}:{port}/metrics/html", timeout=30)
    finally:
        dash.stop()
    assert text.status_code == 200
    assert "# TYPE pio_query_stage_seconds histogram" in text.text
    assert page.status_code == 200 and "pio_query_stage_seconds" in page.text
