"""The port's telemetry (``incubator_predictionio_torch/common/
telemetry.py``) held against the JAX package's: the same records into
both registries render the same Prometheus text (counters, gauges,
histograms, labels that need escaping, a render-time collector); the
log2 bucket index agrees for a sweep of integers and bucket shapes;
``PIO_METRICS=0`` allocates nothing per record (tracemalloc, and the
allocator's block count as ``tests/test_telemetry.py`` reads it) and is
honoured from the environment; the trace sink's lines have the
reference's schema; and a sampled ingest POST echoes ``X-Pio-Trace-Id``,
writes the root span and the group-commit span of the committer thread
under the same trace id.
"""

import gc
import json
import os
import subprocess
import sys
import threading
import tracemalloc

import pytest
import requests

pytest.importorskip("torch")

from incubator_predictionio_tpu.common import telemetry as ref  # noqa: E402
from incubator_predictionio_torch.common import telemetry  # noqa: E402
from incubator_predictionio_torch.data import storage as port_pkg  # noqa: E402
from incubator_predictionio_torch.data.api.event_server import (  # noqa: E402
    EventServer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(mod):
    reg = mod.Registry()
    c = reg.counter("pio_t_requests_total", "Requests\nby route",
                    ("route", "status"))
    c.labels("/events.json", 201).inc()
    c.labels("/events.json", 201).inc(4)
    c.labels('/we"ird\\path\n', 500).inc(2)
    reg.counter("pio_t_plain_total", "no labels").labels().inc(7)
    g = reg.gauge("pio_t_depth", "Queue depth", ("queue",))
    g.labels("a").set(3.5)
    g.labels("b").inc(2)
    g.labels("b").inc(0.25)
    h = reg.histogram("pio_t_latency_seconds", "Latency", ("op",))
    for v in (1, 999, 1024, 1025, 10 ** 6, 3 * 10 ** 9, 2 ** 40):
        h.labels("commit").observe_raw(v)
    sizes = reg.histogram("pio_t_group_size", "Group size", lo_exp=0,
                          n_buckets=14, scale=1)
    for v in (0, 1, 2, 3, 256, 9999, 20000):
        sizes.labels().observe_raw(v)
    fam = mod.CounterFamily("pio_t_collected_total", "From a collector",
                            ("app_id",))
    fam.labels(3).inc(11)
    reg.register_collector("k", lambda: [fam])
    reg.register_collector("broken", lambda: 1 / 0)
    return reg


def test_same_records_render_the_same_text():
    got, want = _record(telemetry).render(), _record(ref).render()
    assert got == want
    assert "pio_t_collected_total{app_id=\"3\"} 11" in got
    assert 'route="/we\\"ird\\\\path\\n"' in got


@pytest.mark.parametrize("shape", [(10, 26, 1e-9), (0, 14, 1), (-3, 8, 1.0),
                                   (4, 3, 2.0)])
def test_bucket_index_agrees(shape):
    a, b = telemetry.Histogram(*shape), ref.Histogram(*shape)
    values = list(range(0, 5000)) + [2 ** k + d for k in range(0, 63)
                                     for d in (-1, 0, 1)]
    for v in values:
        assert a.bucket_index(v) == b.bucket_index(v), v
    for j in range(shape[1]):
        assert a.upper_bound(j) == b.upper_bound(j)


def test_counter_shards_stay_bounded_under_many_threads():
    c = telemetry.CounterFamily("pio_t_threads_total", "x").labels()
    ts = [threading.Thread(target=lambda: [c.inc() for _ in range(100)])
          for _ in range(64)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value() == 6400
    assert len(c._shards) == telemetry._N_SHARDS == ref._N_SHARDS


def test_disabled_path_allocates_nothing():
    fam_c = telemetry.CounterFamily("pio_t_noalloc_total", "x")
    fam_h = telemetry.HistogramFamily("pio_t_noalloc_seconds", "x")
    c, h = fam_c.labels(), fam_h.labels()

    def hot_request():
        t0 = telemetry.timer_start()
        c.inc()
        h.observe_since(t0)

    telemetry.set_metrics_enabled(False)
    try:
        for _ in range(100):
            hot_request()
        gc.collect()
        tracemalloc.start()
        snap0 = tracemalloc.take_snapshot()
        before = sys.getallocatedblocks()
        for _ in range(10_000):
            hot_request()
        grown = sys.getallocatedblocks() - before
        snap1 = tracemalloc.take_snapshot()
        tracemalloc.stop()
    finally:
        telemetry.set_metrics_enabled(True)
    here = [s for s in snap1.compare_to(snap0, "filename")
            if s.traceback[0].filename == telemetry.__file__
            and s.size_diff > 0]
    assert not here, here
    assert grown <= 10, f"disabled telemetry allocated ({grown} blocks)"
    assert c.value() == 0 and h.snapshot()[1] == 0
    hot_request()
    assert c.value() == 1 and h.snapshot()[1] == 1


def test_pio_metrics_env_turns_recording_off():
    code = ("from incubator_predictionio_torch.common import telemetry as t;"
            "c = t.registry().counter('x_total', 'x').labels(); c.inc();"
            "print(t.metrics_enabled(), t.timer_start(), c.value())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PIO_METRICS="0",
                                  PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "0", "0"]


def test_trace_sink_schema_matches_reference(tmp_path):
    lines = {}
    for name, mod in (("port", telemetry), ("ref", ref)):
        sink = tmp_path / f"{name}.jsonl"
        rec = mod.TraceRecorder(rate=1.0, sink=str(sink))
        assert rec.sample(None) is not None
        assert mod.TraceRecorder(rate=0.0, sink=str(sink)).sample(
            "upstream") is None  # off means off
        tr = rec.sample("fixed-id")
        tr.add_span("ingest.group_commit", 12_345_678, key="(1, None)",
                    events=3)
        with tr.span("plain"):
            pass
        tr.flush()
        lines[name] = [json.loads(x) for x in sink.read_text().splitlines()]

    def schema(spans):
        return [(sorted(s), s["traceId"], s["span"], s.get("tags"),
                 type(s["startUs"]), type(s["durUs"])) for s in spans]

    assert schema(lines["port"]) == schema(lines["ref"])
    assert lines["port"][0]["durUs"] == lines["ref"][0]["durUs"] == 12_345


def test_ingest_post_is_traced_into_the_committer(tmp_path, monkeypatch):
    """A POST carrying X-Pio-Trace-Id: the id is echoed, the sink gets the
    root span (status 201) and the committer thread's group-commit span
    under the same id; an untraced POST gets neither."""
    monkeypatch.setenv("PIO_ACCESSKEY_CACHE_SECS", "0")
    sink = tmp_path / "spans.jsonl"
    telemetry.configure_tracer(rate=1.0, sink=str(sink))
    storage = port_pkg.Storage({
        f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
        for r in ("METADATA", "EVENTDATA", "MODELDATA")} | {
        "PIO_STORAGE_SOURCES_M_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_M_PATH": str(tmp_path / "t.sqlite")})
    app_id = storage.get_meta_data_apps().insert(port_pkg.App(0, "tr"))
    storage.get_meta_data_access_keys().insert(
        port_pkg.AccessKey("tk", app_id, ()))
    server = EventServer(storage, "127.0.0.1", 0)
    host, port = server.start()
    try:
        url = f"http://{host}:{port}/events.json?accessKey=tk"
        body = {"event": "view", "entityType": "user", "entityId": "u1"}
        r = requests.post(url, json=body,
                          headers={"X-Pio-Trace-Id": "ingest-trace-7"},
                          timeout=30)
        assert r.status_code == 201
        assert r.headers["X-Pio-Trace-Id"] == "ingest-trace-7"
        telemetry.configure_tracer(rate=0.0)
        r2 = requests.post(url, json=body, timeout=30)
        assert r2.status_code == 201 and "X-Pio-Trace-Id" not in r2.headers
    finally:
        telemetry.configure_tracer(rate=0.0)
        server.stop()
        storage.close()
    spans = [json.loads(x) for x in sink.read_text().splitlines()]
    assert {s["traceId"] for s in spans} == {"ingest-trace-7"}
    root = [s for s in spans if s["span"] == "http POST /events.json"]
    assert root and root[0]["tags"]["status"] == 201
    commit = [s for s in spans if s["span"] == "ingest.group_commit"]
    assert commit and commit[0]["tags"]["events"] == 1
