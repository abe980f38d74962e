"""Telemetry: the metric registry, the Prometheus text exposition and
sampled request tracing.

The port's own copy of ``incubator_predictionio_tpu/common/telemetry.py``:

- **Metric registry** — the process-wide :class:`Registry` of counter /
  gauge / histogram families with Prometheus-style label sets. Counters
  are lock-*sharded* (a fixed number of per-thread-bucket locks, summed
  on read), so the ingest hot path never serializes on one metric lock
  and a server with a thread per connection still holds only
  ``_N_SHARDS`` cells per counter. Histograms use fixed log2 buckets
  whose index is a ``bit_length``, not a ``log``/bisect, fed from
  ``time.perf_counter_ns`` integers. With ``PIO_METRICS=0`` every record
  call returns before touching state, and :func:`timer_start` returns the
  cached small int 0, so a disabled hot path allocates nothing per
  request.
- **Prometheus exposition** — :meth:`Registry.render`: the text format
  (``# HELP``/``# TYPE``, escaped labels, cumulative
  ``_bucket``/``_sum``/``_count``) served by the event server at
  ``GET /metrics``; :meth:`Registry.register_collector` adds families
  built at render time (a server instance's per-app counters).
- **Sampled request tracing** — ``PIO_TRACE`` sets a sample rate;
  sampled requests get a trace id (an incoming ``X-Pio-Trace-Id`` skips
  the probability roll whenever tracing is on at all; ``PIO_TRACE``
  unset/0 stays fully off). The id rides a ``contextvars`` slot: the
  ``http.server`` handler thread binds it around its dispatch
  (:func:`traced_dispatch`, the counterpart of the reference's aiohttp
  middleware), and the ingest buffer hands the bound trace to its
  committer thread with the queued event, which adds the group commit's
  span. Finished spans are written as JSON lines to ``PIO_TRACE_SINK``
  (a path, or ``stderr``).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import random
import sys
import threading
import time
import uuid
from typing import Callable, Iterable, Optional

from . import envknobs

__all__ = [
    "CounterFamily", "GaugeFamily", "HistogramFamily", "Registry",
    "Trace", "TraceRecorder", "TRACE_HEADER",
    "current_trace", "activate_trace", "deactivate_trace",
    "metrics_enabled", "set_metrics_enabled", "timer_start",
    "registry", "render_all", "sample_trace", "configure_tracer",
    "traced_dispatch",
]

TRACE_HEADER = "X-Pio-Trace-Id"


# ---------------------------------------------------------------------------
# enablement
# ---------------------------------------------------------------------------

def _env_flag(name: str, default: bool) -> bool:
    return envknobs.env_flag(name, default)


class _State:
    """Mutable module state behind one attribute load (the hot-path
    check is ``if not _STATE.metrics_on: return``)."""

    __slots__ = ("metrics_on",)


_STATE = _State()
_STATE.metrics_on = _env_flag("PIO_METRICS", True)


def metrics_enabled() -> bool:
    return _STATE.metrics_on


def set_metrics_enabled(on: bool) -> None:
    """Flip metric recording at runtime (bench A/B, tests)."""
    _STATE.metrics_on = bool(on)


def timer_start() -> int:
    """Start a latency timer: ``perf_counter_ns`` when metrics are on,
    the cached small int ``0`` when off. The 0 sentinel makes the
    paired ``Histogram.observe_since`` a no-op, and — critically for
    the disabled-path guarantee — allocates nothing."""
    if _STATE.metrics_on:
        return time.perf_counter_ns()
    return 0


# ---------------------------------------------------------------------------
# metric children
# ---------------------------------------------------------------------------

_N_SHARDS = 8  # power of two; see _shard_index


def _shard_index() -> int:
    # thread idents are pointer-ish (low bits aligned-zero), so shift
    # before masking or every thread lands in shard 0
    return (threading.get_ident() >> 6) & (_N_SHARDS - 1)


class Counter:
    """Monotonic counter, lock-sharded: each thread bucket has its own
    (lock, value) cell, reads sum the shards. Concurrent writers on
    different shards never contend; same-shard writers serialize only
    against each other, not against every metric in the process."""

    __slots__ = ("_shards",)

    def __init__(self):
        self._shards = tuple(
            (threading.Lock(), [0]) for _ in range(_N_SHARDS))

    def inc(self, n: int = 1) -> None:
        if not _STATE.metrics_on:
            return
        lock, box = self._shards[_shard_index()]
        with lock:
            box[0] += n

    def value(self) -> int:
        total = 0
        for lock, box in self._shards:
            with lock:
                total += box[0]
        return total


class Gauge:
    """Last-write-wins gauge. Not gated on ``metrics_enabled`` — gauges
    are set from cold paths (pipeline end, breaker snapshots, compile
    accounting), never per-request."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed log2-bucket histogram over integer raw units.

    Bucket ``j`` has upper bound ``2**(lo_exp + j)`` raw units; the
    index is ``(v - 1).bit_length() - lo_exp`` — the smallest bound
    that is ``>= v``, computed without logs, division, or a bisect
    (bucket-boundary math is golden-tested). Values past the top
    bucket land in ``+Inf``. ``scale`` converts raw units to the
    exposition unit (1e-9 for ns→seconds histograms, 1 for sizes).
    """

    __slots__ = ("_lock", "lo_exp", "n_buckets", "scale", "counts",
                 "sum_raw")

    def __init__(self, lo_exp: int, n_buckets: int, scale: float):
        self._lock = threading.Lock()
        self.lo_exp = lo_exp
        self.n_buckets = n_buckets
        self.scale = scale
        self.counts = [0] * (n_buckets + 1)  # [+Inf] is the last slot
        self.sum_raw = 0

    def bucket_index(self, v: int) -> int:
        if v <= 1:
            return 0 if self.lo_exp >= 0 else max(0, -self.lo_exp)
        i = (v - 1).bit_length() - self.lo_exp
        if i < 0:
            return 0
        return min(i, self.n_buckets)

    def observe_raw(self, v: int) -> None:
        """Record one observation of ``v`` raw units (ns for latency
        histograms, a plain count for size histograms)."""
        if not _STATE.metrics_on:
            return
        i = self.bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.sum_raw += v

    def observe_since(self, t0: int) -> None:
        """Record the elapsed ns since a :func:`timer_start` result;
        a 0 start (metrics were off at timer creation) is a no-op."""
        if t0:
            self.observe_raw(time.perf_counter_ns() - t0)

    def snapshot(self) -> tuple[list[int], int, int]:
        """(bucket counts, total count, raw sum) under the lock."""
        with self._lock:
            counts = list(self.counts)
            return counts, sum(counts), self.sum_raw

    def upper_bound(self, j: int) -> float:
        """Exposition-unit upper bound of bucket ``j``."""
        return (2.0 ** (self.lo_exp + j)) * self.scale


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

class _Family:
    """Named metric with a label schema; children cached per label
    values. The children dict is read lock-free (GIL-safe ``get``) and
    written under a lock — the hot path after warm-up is one dict get."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames: tuple = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: dict = {}
        self._lock = threading.Lock()

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, *values) -> object:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {values!r}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def samples(self) -> Iterable[tuple[tuple, object]]:
        """(label values, child) pairs, stable-sorted for exposition."""
        return sorted(self._children.items())


class CounterFamily(_Family):
    kind = "counter"

    def _new_child(self) -> Counter:
        return Counter()


class GaugeFamily(_Family):
    kind = "gauge"

    def _new_child(self) -> Gauge:
        return Gauge()


class HistogramFamily(_Family):
    kind = "histogram"

    #: default latency shape: 2**10 ns (~1 us) .. 2**35 ns (~34 s)
    DEFAULT_LO_EXP = 10
    DEFAULT_N_BUCKETS = 26

    def __init__(self, name: str, help_: str, labelnames: tuple = (),
                 lo_exp: int = DEFAULT_LO_EXP,
                 n_buckets: int = DEFAULT_N_BUCKETS,
                 scale: float = 1e-9):
        super().__init__(name, help_, labelnames)
        self._shape = (lo_exp, n_buckets, scale)

    def _new_child(self) -> Histogram:
        return Histogram(*self._shape)


# ---------------------------------------------------------------------------
# registry + exposition
# ---------------------------------------------------------------------------

def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v) -> str:
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    if not parts:
        return ""
    return "{" + ",".join(parts) + "}"


def render_families(families: Iterable[_Family]) -> str:
    """Prometheus text exposition format 0.0.4 for ``families``."""
    out: list[str] = []
    for fam in families:
        out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for values, child in fam.samples():
            if fam.kind == "histogram":
                counts, total, sum_raw = child.snapshot()
                cum = 0
                for j in range(child.n_buckets):
                    cum += counts[j]
                    le = f'le="{_fmt(child.upper_bound(j))}"'
                    out.append(
                        f"{fam.name}_bucket"
                        f"{_labels_text(fam.labelnames, values, le)} {cum}")
                inf = 'le="+Inf"'
                out.append(
                    f"{fam.name}_bucket"
                    f"{_labels_text(fam.labelnames, values, inf)} {total}")
                out.append(
                    f"{fam.name}_sum"
                    f"{_labels_text(fam.labelnames, values)} "
                    f"{_fmt(sum_raw * child.scale)}")
                out.append(
                    f"{fam.name}_count"
                    f"{_labels_text(fam.labelnames, values)} {total}")
            else:
                out.append(
                    f"{fam.name}{_labels_text(fam.labelnames, values)} "
                    f"{_fmt(child.value())}")
    return "\n".join(out) + "\n" if out else ""


class Registry:
    """Named family registry plus render-time collectors.

    Families are process-cumulative objects created once
    (``counter``/``gauge``/``histogram`` are get-or-create, so module
    A and module B asking for the same name share the family).
    *Collectors* are callables returning families built at render time
    — for state owned elsewhere (circuit breakers, a server instance's
    per-instance stats). Collectors register under a key and REPLACE
    any previous registrant of that key, so a test spinning up a fresh
    server replaces the old server's collector instead of duplicating
    metric names in the exposition.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._collectors: dict[str, Callable[[], Iterable[_Family]]] = {}

    def _family(self, cls, name: str, help_: str, labelnames: tuple,
                **kwargs) -> _Family:
        # histogram() always passes the full shape; None for other kinds
        shape = ((kwargs["lo_exp"], kwargs["n_buckets"], kwargs["scale"])
                 if cls is HistogramFamily else None)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help_, labelnames, **kwargs)
                self._families[name] = fam
            elif (not isinstance(fam, cls)
                  or fam.labelnames != tuple(labelnames)
                  or getattr(fam, "_shape", None) != shape):
                raise ValueError(
                    f"metric {name!r} re-registered with a different "
                    f"type/labels/shape")
            return fam

    def counter(self, name: str, help_: str,
                labelnames: tuple = ()) -> CounterFamily:
        return self._family(CounterFamily, name, help_, labelnames)

    def gauge(self, name: str, help_: str,
              labelnames: tuple = ()) -> GaugeFamily:
        return self._family(GaugeFamily, name, help_, labelnames)

    def histogram(self, name: str, help_: str, labelnames: tuple = (),
                  lo_exp: int = HistogramFamily.DEFAULT_LO_EXP,
                  n_buckets: int = HistogramFamily.DEFAULT_N_BUCKETS,
                  scale: float = 1e-9) -> HistogramFamily:
        return self._family(HistogramFamily, name, help_, labelnames,
                            lo_exp=lo_exp, n_buckets=n_buckets, scale=scale)

    def register_collector(self, key: str,
                           fn: Callable[[], Iterable[_Family]]) -> None:
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    def collect(self) -> list[_Family]:
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
            collectors = list(self._collectors.values())
        seen = {f.name for f in families}
        for fn in collectors:
            try:
                extra = list(fn())
            except Exception:  # noqa: BLE001 - exposition must not 500
                continue
            for fam in extra:
                if fam.name not in seen:
                    seen.add(fam.name)
                    families.append(fam)
        return families

    def render(self) -> str:
        """The full Prometheus text page for this registry."""
        return render_families(self.collect())


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide default registry every layer records into."""
    return _REGISTRY


def render_all() -> str:
    return _REGISTRY.render()


# ---------------------------------------------------------------------------
# sampled request tracing
# ---------------------------------------------------------------------------

_TRACE_VAR: "contextvars.ContextVar[Optional[Trace]]" = \
    contextvars.ContextVar("pio_trace", default=None)


class Trace:
    """One sampled request: collects spans, flushed once at the end.

    Spans are buffered in-process and written as JSON lines in one
    flush so a trace's spans land contiguously in the sink even under
    concurrent requests."""

    __slots__ = ("trace_id", "_recorder", "_spans", "_lock")

    def __init__(self, trace_id: str, recorder: "TraceRecorder"):
        self.trace_id = trace_id
        self._recorder = recorder
        self._spans: list[dict] = []
        self._lock = threading.Lock()

    def add_span(self, name: str, dur_ns: int, **tags) -> None:
        span = {
            "traceId": self.trace_id,
            "span": name,
            "startUs": (time.time_ns() - dur_ns) // 1000,
            "durUs": dur_ns // 1000,
        }
        if tags:
            span["tags"] = tags
        with self._lock:
            self._spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        t0 = time.perf_counter_ns()
        try:
            yield self
        finally:
            self.add_span(name, time.perf_counter_ns() - t0, **tags)

    def flush(self) -> None:
        with self._lock:
            spans, self._spans = self._spans, []
        if spans:
            self._recorder.emit(spans)


class TraceRecorder:
    """``PIO_TRACE``-rate span sampler writing JSON lines to a sink.

    ``PIO_TRACE``: unset/0 → off; ``1``/``on`` → every request; a
    float in (0, 1) → that sampling probability. ``PIO_TRACE_SINK``:
    a file path (lines appended under a lock) or ``stderr`` (default).
    With tracing enabled, an incoming ``X-Pio-Trace-Id`` skips the
    probability roll — the upstream tier already decided this request
    is worth following. With ``PIO_TRACE`` unset/0 the header is
    ignored: off means off, clients cannot force span writes."""

    def __init__(self, rate: Optional[float] = None,
                 sink: Optional[str] = None):
        if rate is None:
            raw = envknobs.env_str("PIO_TRACE", "")
            if raw in ("", "0", "off", "false", "no"):
                rate = 0.0
            elif raw in ("1", "on", "true", "yes"):
                rate = 1.0
            else:
                rate = envknobs.env_float("PIO_TRACE", 0.0)
        self.rate = max(0.0, min(1.0, float(rate)))
        self.sink = (sink
                     or envknobs.env_str("PIO_TRACE_SINK", "", lower=False)
                     or "stderr")
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.rate > 0.0

    def sample(self, incoming_id: Optional[str] = None) -> Optional[Trace]:
        if not self.rate:
            return None
        if incoming_id:
            return Trace(incoming_id[:64], self)
        if self.rate < 1.0 and random.random() >= self.rate:
            return None
        return Trace(uuid.uuid4().hex[:16], self)

    def emit(self, spans: list[dict]) -> None:
        data = "".join(json.dumps(s, separators=(",", ":")) + "\n"
                       for s in spans)
        try:
            with self._lock:
                if self.sink == "stderr":
                    sys.stderr.write(data)
                else:
                    with open(self.sink, "a", encoding="utf-8") as f:
                        f.write(data)
        except OSError:  # noqa: PERF203 - a dead sink must not fail requests
            pass


_TRACER: Optional[TraceRecorder] = None
_TRACER_LOCK = threading.Lock()


def _tracer() -> TraceRecorder:
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = TraceRecorder()
    return _TRACER


def configure_tracer(rate: Optional[float] = None,
                     sink: Optional[str] = None) -> TraceRecorder:
    """(Re)build the process tracer — re-reads PIO_TRACE / PIO_TRACE_SINK
    for arguments left None. Tests and `pio` verbs use this after
    changing the environment."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = TraceRecorder(rate, sink)
        return _TRACER


def sample_trace(incoming_id: Optional[str] = None) -> Optional[Trace]:
    """Sampling decision for one request (None → not traced)."""
    return _tracer().sample(incoming_id)


def current_trace() -> Optional[Trace]:
    """The active request's Trace, if sampled: set in the handler thread
    by :func:`traced_dispatch`."""
    return _TRACE_VAR.get()


def activate_trace(tr: Trace):
    return _TRACE_VAR.set(tr)


def deactivate_trace(token) -> None:
    _TRACE_VAR.reset(token)


def traced_dispatch(headers, method: str, path: str,
                    serve: Callable[[], int]) -> int:
    """One request of an ``http.server`` handler: sample it, bind the
    trace into the handler thread's context for the whole of ``serve()``
    (which answers the request and returns its status; the reply reads
    :func:`current_trace` to stamp ``X-Pio-Trace-Id``), then flush the
    root span. With tracing off it calls ``serve`` after one None
    check."""
    tr = sample_trace(headers.get(TRACE_HEADER))
    if tr is None:
        return serve()
    token = activate_trace(tr)
    t0 = time.perf_counter_ns()
    status = 500
    try:
        status = serve()
        return status
    finally:
        deactivate_trace(token)
        tr.add_span(f"http {method} {path}", time.perf_counter_ns() - t0,
                    status=status)
        tr.flush()
