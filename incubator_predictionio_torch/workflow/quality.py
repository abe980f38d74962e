"""Continuous quality evaluation: the shadow scorer behind the
quality-triggered rollback.

The port's own copy of ``incubator_predictionio_tpu/workflow/quality.py``,
with the reference's ``/status`` keys:

1. **Sample.** The engine server offers every answered query; a slice
   (``PIO_QUALITY_SAMPLE``) is kept: (user, query, ranked items), so the
   request path pays one RNG draw and, for a sampled query, one list.
2. **Shadow.** On the scorer's own thread each sampled query is replayed
   against the RETAINED last-good deployment by driving the DASE stages
   directly (as the swap gate does: no admission slot, no ``query.*``
   fault points).
3. **Label.** Held-out *next events* tailed from the app's log partitions
   (``data/api/holdout.py``): the user's later actions are the relevance
   labels. A sample resolves once it is older than the resolve window AND
   its user acted; unlabeled samples expire.
4. **Grade.** MAP@k / NDCG@k / AUC of both legs through K7's
   ``ops.eval.ranking_metrics`` on the server's device, folded into
   per-window accumulators; ``ops.eval.quality_verdict`` (the NDCG drop of
   the live model against the last-good one, behind a minimum-sample gate)
   is the breach verdict.
5. **Roll back.** The engine server's quality thread feeds a breach into
   the same rollback path as an error-rate breach, with reason
   ``quality``.

Telemetry: ``pio_engine_quality_samples_total``,
``pio_engine_quality_scored_total``, ``pio_engine_quality_expired_total``,
``pio_engine_quality_breaches_total``, and the
``pio_engine_quality_metric``/``pio_engine_quality_delta`` gauges
(labelled by metric), on the engine server's ``/metrics``; the same counts
ride :meth:`QualityShadow.view`, which ``/status`` reports.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from collections import deque
from typing import Optional

from ..common import telemetry
from ..data.api.holdout import HoldoutTailer
from ..ops import eval as evalops

log = logging.getLogger("pio.torch.quality")

__all__ = ["QualityShadow", "extract_ranking"]


_M_SAMPLES = telemetry.registry().counter(
    "pio_engine_quality_samples_total",
    "Live queries sampled by the shadow scorer").labels()
_M_SCORED = telemetry.registry().counter(
    "pio_engine_quality_scored_total",
    "Sampled queries that resolved against held-out next events and "
    "were graded").labels()
_M_EXPIRED = telemetry.registry().counter(
    "pio_engine_quality_expired_total",
    "Sampled queries dropped unresolved (the user never acted inside "
    "the expiry window, or the served model swapped)").labels()
_M_BREACHES = telemetry.registry().counter(
    "pio_engine_quality_breaches_total",
    "Quality-watch verdicts that crossed the canary-vs-last-good "
    "threshold (each arms one quality rollback)").labels()
_M_METRIC = telemetry.registry().gauge(
    "pio_engine_quality_metric",
    "Windowed mean ranking quality of the LIVE model against held-out "
    "next events", ("metric",))
_M_DELTA = telemetry.registry().gauge(
    "pio_engine_quality_delta",
    "Windowed last-good-minus-live quality delta (positive = the live "
    "model is worse)", ("metric",))


def extract_ranking(prediction) -> Optional[list]:
    """The ranked item-id list of a prediction, or None when the engine's
    answer carries no ranking (scalar predictions are not sampled)."""
    if not isinstance(prediction, dict):
        return None
    scores = prediction.get("itemScores")
    if not isinstance(scores, list) or not scores:
        return None
    items = []
    for s in scores:
        item = s.get("item") if isinstance(s, dict) else None
        if item is None:
            return None
        items.append(str(item))
    return items


class _Sample:
    __slots__ = ("user", "query", "live", "shadow", "t")

    def __init__(self, user: str, query: dict, live: list, t: float):
        self.user = user
        self.query = query
        self.live = live
        self.shadow: Optional[list] = None
        self.t = t


class QualityShadow:
    """One app's shadow scorer, ticked by the engine server's quality
    thread (single-flight, so the scoring state needs no lock). The request
    threads share only the intake deque (atomic appends, drained by the
    tick) and the sampled count (under its lock)."""

    # unlabeled samples are held this many resolve windows before expiring
    _EXPIRE_FACTOR = 4.0

    def __init__(self, storage, *, sample: float, k: int,
                 min_samples: int, max_drop: float, resolve_ms: float,
                 max_pending: int = 512, device="cuda"):
        self.storage = storage
        self.sample = min(1.0, max(0.0, float(sample)))
        self.k = max(1, int(k))
        self.min_samples = max(1, int(min_samples))
        self.max_drop = float(max_drop)
        self.resolve_s = max(0.0, float(resolve_ms)) / 1e3
        self.max_pending = max(1, int(max_pending))
        self.device = device
        self._rng = random.Random()
        self._intake: deque = deque(maxlen=self.max_pending)
        self._offer_lock = threading.Lock()
        self._pending: "deque[_Sample]" = deque()
        self._tailer: Optional[HoldoutTailer] = None
        self._app_id: Optional[int] = None
        self._app_name: Optional[str] = None
        self._disabled: Optional[str] = None
        self._instance_id: Optional[str] = None
        self._live = evalops.MetricWindow()
        self._shadow = evalops.MetricWindow()
        self._deltas = {"map": 0.0, "ndcg": 0.0, "auc": 0.0}
        self._breached = False
        self._breaches = 0
        self._sampled = 0
        self._scored = 0
        self._expired = 0
        self._last_error: Optional[str] = None

    # -- request-path hook (must stay cheap) --------------------------------
    def offer(self, query, prediction) -> None:
        """Called with every answered live query: one RNG draw decides; a
        sampled query costs one ranking extraction and an atomic append
        (drop-oldest when the scorer lags)."""
        if self.sample <= 0.0 or self._rng.random() >= self.sample:
            return
        if not isinstance(query, dict):
            return
        user = query.get("user")
        if user is None:
            return
        items = extract_ranking(prediction)
        if not items:
            return
        self._intake.append(_Sample(str(user), dict(query), items,
                                    time.time()))
        with self._offer_lock:
            self._sampled += 1
        _M_SAMPLES.inc()

    # -- bootstrap ----------------------------------------------------------
    def _arm(self, instance) -> bool:
        """Resolve the app and the events directory once (and again when
        the served instance's app changes). False = quality evaluation
        structurally unavailable here; the reason lands on /status."""
        le = self.storage.get_l_events()
        events_dir = getattr(le, "events_dir", None)
        if not events_dir:
            self._disabled = ("event store is not a JSONL event log "
                              "(the holdout tailer reads log "
                              "partitions; TYPE=JSONL)")
            return False
        app_name = ((instance.env or {}).get("appName")
                    or self._ds_params(instance).get("app_name")
                    or self._ds_params(instance).get("appName") or "")
        if not app_name:
            self._disabled = ("deployed instance names no app "
                              "(env.appName / data-source appName)")
            return False
        app = self.storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            self._disabled = f"app {app_name!r} is not registered"
            return False
        if self._app_id == app.id and self._tailer is not None:
            return True
        self._app_id, self._app_name = app.id, app_name
        # armed at the log end: everything already written predates the
        # queries this scorer grades
        self._tailer = HoldoutTailer(events_dir, app.id)
        self._disabled = None
        log.info("quality: holdout tailer armed for app %r at the current "
                 "log end", app_name)
        return True

    @staticmethod
    def _ds_params(instance) -> dict:
        try:
            doc = json.loads(instance.data_source_params or "{}")
            return doc if isinstance(doc, dict) else {}
        except ValueError:
            return {}

    # -- one tick -----------------------------------------------------------
    def run_once(self, deployment, instance, prev_deployment) -> dict:
        """One tick: poll labels → shadow-replay fresh samples → resolve
        aged ones → grade both windows → verdict. Returns the /status view
        (``"breach"`` True when this window crossed the threshold). Raises
        on tailer and storage faults: the loop retries next tick."""
        try:
            if not self._arm(instance):
                return self.view()
            if instance.id != self._instance_id:
                # a new model serves: the old samples graded a model that
                # no longer serves, and the windows compare per instance
                self._reset_window(instance.id)
            self._tailer.poll()
            now = time.time()
            while True:
                try:
                    s = self._intake.popleft()
                except IndexError:
                    break
                # replay NOW, while the last-good models are resident
                if prev_deployment is not None:
                    s.shadow = self._replay(prev_deployment, s.query)
                self._pending.append(s)
            self._resolve(now)
            breach = self._verdict()
            self._last_error = None
            out = self.view()
            out["breach"] = breach
            return out
        except Exception as e:
            self._last_error = str(e)
            raise

    def _reset_window(self, instance_id) -> None:
        dropped = len(self._pending)
        if dropped:
            self._expired += dropped
            _M_EXPIRED.inc(dropped)
        self._pending.clear()
        self._live.reset()
        self._shadow.reset()
        self._deltas = {"map": 0.0, "ndcg": 0.0, "auc": 0.0}
        self._breached = False
        self._instance_id = instance_id

    def _replay(self, deployment, query) -> Optional[list]:
        try:
            q = deployment.serving.supplement(dict(query))
            predictions = [
                algo.predict(model, q)
                for (_name, algo), model in zip(deployment.algo_list,
                                                deployment.models)
            ]
            return extract_ranking(deployment.serving.serve(q, predictions))
        except Exception:  # noqa: BLE001 — a failing shadow replay is not
            # a serving error; the sample just carries no shadow leg
            return None

    def _resolve(self, now: float) -> None:
        expire_s = self.resolve_s * self._EXPIRE_FACTOR
        live_lists, live_labels = [], []
        shadow_lists, shadow_labels = [], []
        keep: "deque[_Sample]" = deque()
        while self._pending:
            s = self._pending.popleft()
            age = now - s.t
            if age < self.resolve_s:
                keep.append(s)
                continue
            labels = self._tailer.labels_for(s.user)
            if not labels:
                if age >= expire_s:
                    self._expired += 1
                    _M_EXPIRED.inc()
                else:
                    keep.append(s)
                continue
            live_lists.append(s.live)
            live_labels.append(labels)
            if s.shadow:
                shadow_lists.append(s.shadow)
                shadow_labels.append(labels)
        self._pending = keep
        if not live_lists:
            return
        self._live.add(evalops.ranking_metrics(live_lists, live_labels,
                                               self.k, device=self.device))
        if shadow_lists:
            self._shadow.add(evalops.ranking_metrics(
                shadow_lists, shadow_labels, self.k, device=self.device))
        self._scored += len(live_lists)
        _M_SCORED.inc(len(live_lists))
        means = self._live.means()
        for m in ("map", "ndcg", "auc"):
            _M_METRIC.labels(m).set(round(means[m], 6))

    def _verdict(self) -> bool:
        breach, deltas = evalops.quality_verdict(
            self._live.means(), self._shadow.means(),
            min_samples=self.min_samples, max_drop=self.max_drop)
        self._deltas = deltas
        for m, d in deltas.items():
            _M_DELTA.labels(m).set(d)
        if breach and not self._breached:
            # latched: one breach verdict per window (the server rolls back
            # once, and the window resets with the swap)
            self._breached = True
            self._breaches += 1
            _M_BREACHES.inc()
            return True
        return False

    # -- status surface -----------------------------------------------------
    def view(self) -> dict:
        out = {
            "enabled": self._disabled is None,
            "disabledReason": self._disabled,
            "sample": self.sample,
            "k": self.k,
            "minSamples": self.min_samples,
            "maxDrop": self.max_drop,
            "resolveMs": self.resolve_s * 1e3,
            "app": self._app_name,
            "appId": self._app_id,
            "instance": self._instance_id,
            "sampled": self._sampled,
            "scored": self._scored,
            "expired": self._expired,
            "breaches": self._breaches,
            "pending": len(self._pending) + len(self._intake),
            "live": {k: round(v, 6) if isinstance(v, float) else v
                     for k, v in self._live.means().items()},
            "shadow": {k: round(v, 6) if isinstance(v, float) else v
                       for k, v in self._shadow.means().items()},
            "deltas": self._deltas,
            "breached": self._breached,
            "lastError": self._last_error,
        }
        if self._tailer is not None:
            out["holdout"] = self._tailer.view()
        return out
