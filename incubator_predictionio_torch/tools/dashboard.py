"""Dashboard — the leaderboard of completed evaluations, on :9000.

Port of ``incubator_predictionio_tpu/tools/dashboard.py`` (reference:
tools/.../dashboard/Dashboard.scala with its CorsSupport) on the standard
library's ``ThreadingHTTPServer``. Read-only routes, each with the CORS
headers (and ``OPTIONS`` preflight on any path):

- ``GET /``: every completed evaluation with its metric, best score and
  the best params as JSON ready to paste into engine.json;
- ``GET /instances/<id>``: one evaluation's candidates ranked by score,
  each with its params as a diff against the best;
- ``GET /instances.json`` and ``GET /instances/<id>.json``: the JSON the
  pages are built from;
- ``GET /metrics``: the process registry as Prometheus text, and
  ``GET /metrics/html``: the same families as a table.

TLS: with ``PIO_SSL_CERTFILE`` and ``PIO_SSL_KEYFILE`` set the dashboard
answers HTTPS only (``common/ssl_config.py``).
"""

from __future__ import annotations

import html
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..common import telemetry
from ..common.ssl_config import TLSServerMixin, ssl_context_from_env

log = logging.getLogger("pio.torch.dashboard")

_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type",
}

_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2em; }
table { border-collapse: collapse; }
th, td { border: 1px solid #999; padding: 4px 8px; text-align: left;
         vertical-align: top; }
th { background: #eee; }
tr.best { background: #e8f4e8; }
pre { margin: 0; max-width: 60em; overflow-x: auto; }
.muted { color: #777; }
"""


def _flatten(obj, prefix="") -> dict:
    """Nested params JSON → dotted-key leaves, for diffing."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, list):
        for j, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}{j}."))
    else:
        out[prefix.rstrip(".")] = obj
    return out


def params_diff(candidate: dict, best: dict) -> list[tuple[str, object, object]]:
    """(dotted key, candidate value, best value) for every leaf that
    differs."""
    c, b = _flatten(candidate), _flatten(best)
    rows = []
    for key in sorted(set(c) | set(b)):
        cv, bv = c.get(key, "<absent>"), b.get(key, "<absent>")
        if cv != bv:
            rows.append((key, cv, bv))
    return rows


def _parsed_results(i) -> dict:
    """bestScore / metricHeader / bestEngineParams / candidates from the
    stored MetricEvaluatorResult JSON (empty on a malformed row)."""
    try:
        r = json.loads(i.evaluator_results_json or "{}")
    except json.JSONDecodeError:
        return {}
    if not isinstance(r, dict):
        return {}
    return {
        "metricHeader": r.get("metricHeader"),
        "bestScore": r.get("bestScore"),
        "bestEngineParams": r.get("bestEngineParams"),
        "results": r.get("results", []) or [],
        "candidates": len(r.get("results", []) or []),
    }


def _fmt(score) -> str:
    return f"{score:.6g}" if isinstance(score, (int, float)) else "—"


def _page(title: str, body: str) -> str:
    return (f"<html><head><title>{html.escape(title)}</title>"
            f"<style>{_STYLE}</style></head><body>{body}</body></html>")


def index_page(instances) -> str:
    rows = []
    for i in instances:
        res = _parsed_results(i)
        best_params = res.get("bestEngineParams")
        params_pre = (html.escape(json.dumps(best_params, indent=2))
                      if best_params is not None else "—")
        rows.append(
            "<tr><td><a href='/instances/{id}'>{sid}</a> "
            "<a class=muted href='/instances/{id}.json'>json</a></td>"
            "<td>{cls}</td><td>{metric}</td><td>{score}</td>"
            "<td>{cand}</td><td>{start}</td><td>{end}</td>"
            "<td><details><summary>engine.json params</summary>"
            "<pre>{params}</pre></details></td></tr>".format(
                id=html.escape(i.id), sid=html.escape(i.id[:13]),
                cls=html.escape(i.evaluation_class),
                metric=html.escape(str(res.get("metricHeader") or "—")),
                score=_fmt(res.get("bestScore")),
                cand=res.get("candidates", "—"),
                start=html.escape(str(i.start_time)),
                end=html.escape(str(i.end_time)), params=params_pre))
    body = ("<h1>Completed evaluations</h1>"
            "<table><tr><th>ID</th><th>Evaluation</th>"
            "<th>Metric</th><th>Best score</th><th>Candidates</th>"
            "<th>Started</th><th>Finished</th><th>Best params</th></tr>"
            + "".join(rows) + "</table>")
    return _page("PredictionIO Dashboard", body)


def instance_page(i) -> str:
    """Every candidate ranked by score, its params as a diff against the
    best."""
    res = _parsed_results(i)
    best = res.get("bestEngineParams") or {}
    ranked = sorted(res.get("results", []),
                    key=lambda r: (r.get("score") is not None, r.get("score")),
                    reverse=True)
    rows = []
    for rank, cand in enumerate(ranked, 1):
        ep = cand.get("engineParams") or {}
        diff = params_diff(ep, best)
        if not diff:
            diff_html = "<span class=muted>= best</span>"
        else:
            diff_html = "<br>".join(
                "<code>{k}</code>: {cv} <span class=muted>(best: {bv})"
                "</span>".format(k=html.escape(str(k)),
                                 cv=html.escape(json.dumps(cv)),
                                 bv=html.escape(json.dumps(bv)))
                for k, cv, bv in diff)
        others = cand.get("others") or []
        rows.append(
            "<tr class='{cls}'><td>{rank}</td><td>{score}</td>"
            "<td>{others}</td><td>{diff}</td>"
            "<td><details><summary>full params</summary><pre>{full}"
            "</pre></details></td></tr>".format(
                cls="best" if not diff else "", rank=rank,
                score=_fmt(cand.get("score")),
                others=html.escape(", ".join(
                    _fmt(o) if isinstance(o, (int, float)) else str(o)
                    for o in others) or "—"),
                diff=diff_html,
                full=html.escape(json.dumps(ep, indent=2))))
    body = (
        f"<h1>Evaluation {html.escape(i.id[:13])}</h1>"
        f"<p>{html.escape(i.evaluation_class)} — metric: "
        f"{html.escape(str(res.get('metricHeader') or '—'))} — "
        f"<a href='/'>back</a> · "
        f"<a href='/instances/{html.escape(i.id)}.json'>json</a></p>"
        "<h2>Best params (paste into engine.json)</h2>"
        f"<pre>{html.escape(json.dumps(best, indent=2))}</pre>"
        "<h2>Candidates</h2>"
        "<table><tr><th>#</th><th>Score</th><th>Other metrics</th>"
        "<th>Diff vs best</th><th>Params</th></tr>"
        + "".join(rows) + "</table>")
    return _page(f"Evaluation {i.id[:13]}", body)


def instances_json(instances) -> list:
    out = []
    for i in instances:
        res = _parsed_results(i)
        out.append({
            "id": i.id,
            "evaluationClass": i.evaluation_class,
            "engineParamsGeneratorClass": i.engine_params_generator_class,
            "startTime": i.start_time.isoformat(),
            "endTime": i.end_time.isoformat() if i.end_time else None,
            "batch": i.batch,
            "metricHeader": res.get("metricHeader"),
            "bestScore": res.get("bestScore"),
            "bestEngineParams": res.get("bestEngineParams"),
            "candidates": res.get("candidates"),
        })
    return out


def metrics_page() -> str:
    """Every family in the process registry as a table (name, type,
    labels, value)."""
    rows = []
    for fam in telemetry.registry().collect():
        for values, child in fam.samples():
            if fam.kind == "histogram":
                _counts, total, sum_raw = child.snapshot()
                shown = f"count={total}, sum={sum_raw * child.scale:.6g}"
            else:
                shown = f"{child.value():.10g}"
            labels = ", ".join(
                f"{n}={v}" for n, v in zip(fam.labelnames, values))
            rows.append(
                "<tr><td><code>{name}</code></td><td>{kind}</td>"
                "<td>{labels}</td><td>{value}</td></tr>".format(
                    name=html.escape(fam.name), kind=html.escape(fam.kind),
                    labels=html.escape(labels) or "—",
                    value=html.escape(shown)))
    return _page("Telemetry", (
        "<h1>Telemetry</h1>"
        "<p><a href='/'>back</a> · <a href='/metrics'>raw "
        "(Prometheus text format)</a></p>"
        "<table><tr><th>Metric</th><th>Type</th><th>Labels</th>"
        "<th>Value</th></tr>" + "".join(rows) + "</table>"))


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"
    protocol_version = "HTTP/1.1"
    wbufsize = -1  # headers and body leave in one send (see create_server)

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        for k, v in _CORS.items():
            self.send_header(k, v)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, obj) -> None:
        self._send(status, json.dumps(obj).encode(),
                   "application/json; charset=utf-8")

    def _html(self, status: int, text: str) -> None:
        self._send(status, text.encode(), "text/html; charset=utf-8")

    def do_OPTIONS(self):  # noqa: N802 - http.server's naming
        self._send(200, b"", "text/plain")

    def do_GET(self):  # noqa: N802
        dao = self.server.storage.get_meta_data_evaluation_instances()
        path = self.path.split("?", 1)[0]
        if path == "/":
            self._html(200, index_page(dao.get_completed()))
        elif path == "/metrics":
            self._send(200, telemetry.render_all().encode(),
                       "text/plain; charset=utf-8")
        elif path == "/metrics/html":
            self._html(200, metrics_page())
        elif path == "/instances.json":
            self._json(200, instances_json(dao.get_completed()))
        elif path.startswith("/instances/") and path.endswith(".json"):
            i = dao.get(path[len("/instances/"):-len(".json")])
            if i is None:
                self._json(404, {"message": "not found"})
                return
            try:
                results = json.loads(i.evaluator_results_json or "{}")
            except json.JSONDecodeError:
                results = {}
            self._json(200, {"id": i.id, "results": results,
                             "pretty": i.evaluator_results})
        elif path.startswith("/instances/"):
            i = dao.get(path[len("/instances/"):])
            if i is None:
                self._html(404, _page("not found",
                                      "<h1>Instance not found</h1>"))
                return
            self._html(200, instance_page(i))
        else:
            self._json(404, {"message": f"no route {self.path}"})

    def log_message(self, fmt, *args):
        log.debug("%s - " + fmt, self.address_string(), *args)


class _Server(TLSServerMixin, ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, storage):
        # a bad PIO_SSL_* file raises here, before the socket is bound
        self.ssl_context = ssl_context_from_env()
        super().__init__(addr, _Handler)
        self.storage = storage


class Dashboard:
    """Serves the evaluation leaderboard of ``storage`` (the process's
    ``Storage.instance()`` when None) on ``host:port`` (0: a free port)."""

    def __init__(self, storage=None, host: str = "127.0.0.1",
                 port: int = 9000):
        if storage is None:
            from ..data.storage.registry import Storage

            storage = Storage.instance()
        self._httpd = _Server((host, port), storage)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def serve_forever(self) -> None:
        """Serve on the calling thread until :meth:`stop`."""
        self._httpd.serve_forever()

    def start(self) -> tuple[str, int]:
        """Serve on a background thread; returns (host, port)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="pio-dashboard", daemon=True)
        self._thread.start()
        return self.address

    def close(self) -> None:
        """Release the listening socket (after serving has stopped)."""
        self._httpd.server_close()

    def stop(self) -> None:
        """Stop a dashboard started with :meth:`start`."""
        self._httpd.shutdown()
        self.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
