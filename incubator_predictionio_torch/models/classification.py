"""Classification template (attribute-based classifier).

Port of ``incubator_predictionio_tpu/models/classification.py``: the
``$set`` events of "user" entities carry numeric attributes and a "plan"
label; their aggregated properties give a dense [N, D] feature matrix;
multinomial Naive Bayes (``naive``) or L2 logistic regression under L-BFGS
(``lr``) trains on ``ctx.device`` (:mod:`..ops.linear`), and a query is
answered on the host. Wire format (the template's)::

  query  {"attr0": 2, "attr1": 0, "attr2": 0}
  result {"label": 1.0}

The model persists as arrays and JSON (:func:`inner_to_persisted`), never
as a pickle. In a gang (``pio train --num-workers N``) both algorithms
train through ``ops.linear``'s process-local trainers: under the partition
feed each rank reads its strided slice of the entities
(``train_feed.partition_examples``); on the merged view (``--feed
merged``, a store that is not the JSONL log) each rank trains its
contiguous row block (``ops.linear.gang_rows``). In one process a large
input streams (``pipeline_of(ctx)``). Not ported: the placement cost model
(``stage_model``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Sequence

import numpy as np

from ..controller import (
    Algorithm, DataSource, Engine, EngineFactory, Params, SanityCheck,
)
from ..data.events import aggregate_properties
from ..data.store import PEventStore
from ..e2.cross_validation import k_fold_indices
from ..ops.linear import (
    LogisticRegressionModel, NaiveBayesModel, gang_rows, lr_sgd_steps,
    nb_fold_in, train_logistic_regression,
    train_logistic_regression_process_local, train_naive_bayes,
    train_naive_bayes_process_local,
)
from ..parallel.distributed import process_count
from ..workflow import train_feed
from ..workflow.input_pipeline import pipeline_of, stats_into

log = logging.getLogger("pio.torch.classification")


@dataclasses.dataclass
class TrainingData(SanityCheck):
    features: np.ndarray  # [N, D] f32
    labels: np.ndarray  # [N] int32
    attribute_names: Sequence[str]
    label_values: np.ndarray  # class index → original label value
    #: True when features/labels hold only this gang worker's strided
    #: entity slice (``train_feed.partition_examples``) while label_values
    #: is the gang's GLOBAL class vocabulary: the trainers all-reduce
    partition_local: bool = False
    #: the gang-wide labeled-entity count (len(features) when not
    #: partition-local)
    n_global: int = -1

    def sanity_check(self):
        n = self.n_global if self.partition_local else len(self.features)
        assert n > 0, "no labeled entities found"
        assert len(self.features) == len(self.labels)


PreparedData = TrainingData


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    entity_type: str = "user"
    attributes: Sequence[str] = ("attr0", "attr1", "attr2")
    label: str = "plan"


class ClassificationDataSource(DataSource):
    params_cls = DataSourceParams
    params_aliases = {"appName": "app_name", "entityType": "entity_type"}

    def read_training(self, ctx) -> TrainingData:
        """Every entity whose aggregated properties hold all the attributes
        and the label, in the aggregate's order: from ``ctx.events`` when
        the caller handed events over, else from the event store, or —
        with the partition feed armed — this gang worker's strided slice
        of the entities its partitions' replays agree on
        (``partition_local``; the label vocabulary is the gang's)."""
        p: DataSourceParams = self.params
        required = list(p.attributes) + [p.label]
        t0 = time.perf_counter()
        if ctx.events is None and train_feed.partition_feed_active(
                ctx.get_storage()):
            feats, y, label_values, n_global = train_feed.partition_examples(
                p.app_name or ctx.app_name, p.entity_type,
                list(p.attributes), p.label, storage=ctx.get_storage(),
                channel_name=ctx.channel_name, report=ctx.read_timings)
            ctx.record_read(time.perf_counter() - t0, len(feats))
            return TrainingData(
                features=feats, labels=y,
                attribute_names=tuple(p.attributes),
                label_values=label_values, partition_local=True,
                n_global=n_global)
        if ctx.events is not None:
            props = aggregate_properties(ctx.events, p.entity_type,
                                         required=required)
        else:
            props = PEventStore.aggregate_properties(
                p.app_name or ctx.app_name, p.entity_type,
                channel_name=ctx.channel_name, required=required,
                storage=ctx.get_storage())
        feats, labels = [], []
        for pm in props.values():  # every one holds the required keys
            feats.append([float(pm[a]) for a in p.attributes])
            labels.append(pm[p.label])
        label_values, y = np.unique(np.asarray(labels), return_inverse=True)
        ctx.record_read(time.perf_counter() - t0, len(feats))
        return TrainingData(
            features=np.asarray(feats, np.float32),
            labels=y.astype(np.int32),
            attribute_names=tuple(p.attributes),
            label_values=label_values,
        )

    def read_eval(self, ctx):
        """Three folds (seed 1); each held-out entity is a query of its
        attributes whose actual is its label."""
        td = self.read_training(ctx)
        folds = []
        for train_sel, test_sel in k_fold_indices(len(td.labels), k=3,
                                                  seed=1):
            train = TrainingData(
                td.features[train_sel], td.labels[train_sel],
                td.attribute_names, td.label_values)
            queries = [
                (dict(zip(td.attribute_names, td.features[j].tolist())),
                 {"label": float(td.label_values[td.labels[j]])})
                for j in np.nonzero(test_sel)[0]
            ]
            folds.append((train, None, queries))
        return folds


@dataclasses.dataclass
class ClassifierModel:
    inner: object  # NaiveBayesModel | LogisticRegressionModel
    attribute_names: Sequence[str]
    label_values: np.ndarray
    #: entityId → (features tuple, class index) of the example a fold-in
    #: last added for the entity, so a re-``$set`` replaces it in the NB
    #: statistics (None until the first fold-in; bounded by
    #: :data:`FOLDIN_SEEN_MAX`)
    foldin_seen: Optional[dict] = None

    def predict_label(self, features: np.ndarray) -> float:
        x = np.asarray(features, np.float32)[None, :]
        if isinstance(self.inner, NaiveBayesModel):
            scores = self.inner.predict_log_joint(x)[0]
        else:
            scores = self.inner.predict_logits(x)[0]
        return float(self.label_values[int(np.argmax(scores))])


#: cap on ``ClassifierModel.foldin_seen`` (the oldest-updated drop out)
FOLDIN_SEEN_MAX = 100_000


def _foldin_examples(events, data_source_params, model: ClassifierModel):
    """(entity ids, x, y) of the complete ``$set`` events (every attribute
    and a trained label in one event; the last per entity wins), read with
    the training's entity type, attributes and label; (None, None, None)
    when there is none."""
    dsp = dict(data_source_params or {})
    entity_type = dsp.get("entity_type", dsp.get("entityType", "user"))
    attrs = list(dsp.get("attributes") or model.attribute_names)
    label = dsp.get("label", "plan")
    label_of = {float(v): j for j, v in
                enumerate(np.asarray(model.label_values, np.float64))}
    latest: dict = {}
    for e in events:
        if not isinstance(e, dict) or e.get("event") != "$set":
            continue
        if e.get("entityType") != entity_type or not e.get("entityId"):
            continue
        props = e.get("properties") or {}
        try:
            x = [float(props[a]) for a in attrs]
            y = label_of[float(props[label])]
        except (KeyError, TypeError, ValueError):
            continue    # a partial $set or an untrained label
        latest[e["entityId"]] = (x, y)
    if not latest:
        return None, None, None
    ids = list(latest)
    xs = [latest[i][0] for i in ids]
    ys = [latest[i][1] for i in ids]
    return ids, np.asarray(xs, np.float32), np.asarray(ys, np.int64)


def inner_to_persisted(inner) -> dict:
    """A NaiveBayesModel or LogisticRegressionModel → arrays plus one JSON
    entry ``model`` (its kind and scalars)."""
    if isinstance(inner, NaiveBayesModel):
        out = {"model": {"kind": "naive_bayes", "n_classes": inner.n_classes,
                         "smoothing": inner.smoothing},
               "log_prior": inner.log_prior,
               "log_likelihood": inner.log_likelihood}
        if inner.feat_counts is not None:
            out["feat_counts"] = inner.feat_counts
            out["class_counts"] = inner.class_counts
        return out
    return {"model": {"kind": "logistic_regression",
                      "n_classes": inner.n_classes},
            "weights": inner.weights, "intercept": inner.intercept}


def inner_from_persisted(stored: dict):
    meta = stored["model"]
    if meta["kind"] == "naive_bayes":
        return NaiveBayesModel(
            log_prior=np.asarray(stored["log_prior"], np.float32),
            log_likelihood=np.asarray(stored["log_likelihood"], np.float32),
            n_classes=int(meta["n_classes"]),
            feat_counts=stored.get("feat_counts"),
            class_counts=stored.get("class_counts"),
            smoothing=float(meta["smoothing"]))
    return LogisticRegressionModel(
        weights=np.asarray(stored["weights"], np.float32),
        intercept=np.asarray(stored["intercept"], np.float32),
        n_classes=int(meta["n_classes"]))


def model_to_persisted(model: ClassifierModel) -> dict:
    seen = model.foldin_seen
    return {**inner_to_persisted(model.inner),
            "attribute_names": list(model.attribute_names),
            "label_values": np.asarray(model.label_values),
            "foldin_seen": (None if seen is None else
                            {k: [list(x), int(y)] for k, (x, y)
                             in seen.items()})}


def model_from_persisted(stored: dict) -> ClassifierModel:
    seen = stored.get("foldin_seen")
    return ClassifierModel(
        inner=inner_from_persisted(stored),
        attribute_names=tuple(stored["attribute_names"]),
        label_values=np.asarray(stored["label_values"]),
        foldin_seen=(None if seen is None else
                     {k: (tuple(float(v) for v in x), int(y))
                      for k, (x, y) in seen.items()}))


def _gang_block(pd: PreparedData):
    """(features, labels) this process trains on, or None outside a gang:
    a partition-local read's own block, else this rank's contiguous rows
    of the merged read."""
    if not pd.partition_local and process_count() == 1:
        return None
    if pd.partition_local:
        return pd.features, pd.labels
    lo, hi = gang_rows(len(pd.labels))
    return pd.features[lo:hi], pd.labels[lo:hi]


class _ClassifierAlgorithm(Algorithm):
    gang_capable = True

    def predict(self, model: ClassifierModel, query: dict) -> dict:
        x = np.asarray([float(query[a]) for a in model.attribute_names],
                       np.float32)
        return {"label": model.predict_label(x)}

    def prepare_model_for_persistence(self, model: ClassifierModel) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> ClassifierModel:
        return model_from_persisted(stored)


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    # MLlib NaiveBayes additive smoothing; engine.json {"lambda": 1.0}
    smoothing: float = 1.0


class NaiveBayesAlgorithm(_ClassifierAlgorithm):
    params_cls = NaiveBayesParams
    params_aliases = {"lambda": "smoothing"}

    def train(self, ctx, pd: PreparedData) -> ClassifierModel:
        block = _gang_block(pd)
        if block is not None:
            # the gang: the statistics summed over every rank
            model = train_naive_bayes_process_local(
                *block, n_classes=len(pd.label_values),
                smoothing=self.params.smoothing, device=ctx.device,
                timings=ctx.bench_timings)
        else:
            with stats_into(ctx.bench_timings) as streamed:
                model = train_naive_bayes(
                    pd.features, pd.labels, n_classes=len(pd.label_values),
                    smoothing=self.params.smoothing, device=ctx.device,
                    pipeline=pipeline_of(ctx), pipeline_stats=streamed)
        return ClassifierModel(model, pd.attribute_names, pd.label_values)

    def fold_in(self, model: ClassifierModel, events, ctx=None,
                data_source_params=None):
        """Exact incremental NB (:func:`..ops.linear.nb_fold_in`): an
        entity an earlier fold-in added is replaced (its old example
        taken out), not counted twice. None when no event folds in or
        the model keeps no statistics."""
        ids, x, y = _foldin_examples(events, data_source_params, model)
        if x is None:
            return None
        seen = dict(model.foldin_seen or {})
        x_rm, y_rm = [], []
        for eid in ids:
            prev = seen.get(eid)
            if prev is not None:
                x_rm.append(prev[0])
                y_rm.append(prev[1])
        inner = nb_fold_in(
            model.inner, x, y,
            x_remove=np.asarray(x_rm, np.float32) if x_rm else None,
            y_remove=np.asarray(y_rm, np.int64) if y_rm else None)
        if inner is None:
            log.warning("NB fold-in declined: the model carries no "
                        "sufficient statistics; retrain once to enable "
                        "online updates")
            return None
        for eid, xi, yi in zip(ids, x, y):
            seen.pop(eid, None)   # re-insert: the freshest goes last
            seen[eid] = (tuple(float(v) for v in xi), int(yi))
        while len(seen) > FOLDIN_SEEN_MAX:
            seen.pop(next(iter(seen)))
        return ClassifierModel(inner, model.attribute_names,
                               model.label_values, foldin_seen=seen)


@dataclasses.dataclass(frozen=True)
class LogisticRegressionParams(Params):
    reg: float = 0.0
    max_iters: int = 100


class LogisticRegressionAlgorithm(_ClassifierAlgorithm):
    params_cls = LogisticRegressionParams
    params_aliases = {"regParam": "reg", "maxIterations": "max_iters"}

    def train(self, ctx, pd: PreparedData) -> ClassifierModel:
        block = _gang_block(pd)
        if block is not None:
            # the gang: the gradient summed over every rank at every step
            model = train_logistic_regression_process_local(
                *block, n_classes=len(pd.label_values), reg=self.params.reg,
                max_iters=self.params.max_iters, device=ctx.device,
                stats=ctx.bench_timings)
        else:
            with stats_into(ctx.bench_timings) as streamed:
                model = train_logistic_regression(
                    pd.features, pd.labels, n_classes=len(pd.label_values),
                    reg=self.params.reg, max_iters=self.params.max_iters,
                    device=ctx.device, stats=ctx.bench_timings,
                    pipeline=pipeline_of(ctx), pipeline_stats=streamed)
        return ClassifierModel(model, pd.attribute_names, pd.label_values)

    def fold_in(self, model: ClassifierModel, events, ctx=None,
                data_source_params=None):
        """A few SGD steps over the new examples
        (:func:`..ops.linear.lr_sgd_steps`); None when none folds in."""
        _ids, x, y = _foldin_examples(events, data_source_params, model)
        if x is None:
            return None
        inner = lr_sgd_steps(model.inner, x, y, reg=self.params.reg)
        if inner is None:
            return None
        return ClassifierModel(inner, model.attribute_names,
                               model.label_values)


class ClassificationEngine(EngineFactory):
    """engine.json: "engineFactory":
    "incubator_predictionio_torch.models.classification.ClassificationEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=ClassificationDataSource,
            algorithm_class_map={
                "naive": NaiveBayesAlgorithm,
                "lr": LogisticRegressionAlgorithm,
                "": NaiveBayesAlgorithm,
            },
        )
