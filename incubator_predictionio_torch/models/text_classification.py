"""Text-Classification template (hashing TF-IDF + Naive Bayes or LR).

Port of ``incubator_predictionio_tpu/models/text_classification.py``:
"documents" events carry ``text`` and ``label`` properties; the preparator
fits the hashing TF-IDF (:mod:`..ops.tfidf`, the event codec's tokenizer)
as per-document COO term counts; Naive Bayes (``nb``) trains from the COO
with one ``index_add_`` on ``ctx.device`` and the idf as a column scale of
its statistics, and LR (``lr``) on the dense TF-IDF matrix under L-BFGS. A
query is answered on the host. Wire format (the template's)::

  query  {"text": "I like speed and fast motorcycles."}
  result {"category": "motorcycles", "confidence": 0.87}

Not ported: the streamed input pipeline (the preparator always fits the
COO at once) and the placement cost model (``stage_model``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from ..controller import (
    Algorithm, DataSource, Engine, EngineFactory, Params, Preparator,
    SanityCheck,
)
from ..data.events import event_time_us
from ..data.store import PEventStore
from ..e2.cross_validation import k_fold_indices
from ..ops.linear import (
    NaiveBayesModel, train_logistic_regression, train_naive_bayes,
    train_naive_bayes_coo,
)
from ..ops.tfidf import TfIdfVectorizer
from .classification import inner_from_persisted, inner_to_persisted


@dataclasses.dataclass
class TrainingData(SanityCheck):
    texts: list[str]
    labels: np.ndarray  # [N] int32
    label_values: np.ndarray

    def sanity_check(self):
        assert len(self.texts) > 0, "no documents found"


@dataclasses.dataclass
class PreparedData:
    features: Optional[np.ndarray]  # [N, D] raw tf, or None (COO)
    labels: np.ndarray
    label_values: np.ndarray
    vectorizer: TfIdfVectorizer
    #: ``features`` / ``coo`` hold raw term counts; the fitted idf is a
    #: column scale the trainer applies
    features_are_tf: bool = False
    #: (doc_ptr, feat, counts) of ``TfIdfVectorizer.fit_tf_coo``
    coo: Optional[tuple] = None

    def dense_tf(self) -> np.ndarray:
        """The raw term-frequency matrix, made from the COO (LR needs whole
        rows; NB never calls this)."""
        if self.features is not None:
            return self.features
        doc_ptr, feat, cnt = self.coo
        n, d = len(doc_ptr) - 1, self.vectorizer.n_features
        x = np.zeros((n, d), np.float32)
        rows = np.repeat(np.arange(n), np.diff(np.asarray(doc_ptr)))
        x[rows, feat] = cnt
        return x


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = ""
    event_names: Sequence[str] = ("documents",)
    entity_type: str = "content"
    text_property: str = "text"
    label_property: str = "label"


def _document_properties(events, event_names, entity_type):
    """The properties of the selected events in event-time order (stable),
    as the event store's scan gives them."""
    names = set(event_names)
    sel = [e for e in events if e.get("event") in names
           and e.get("entityType") == entity_type]
    sel.sort(key=lambda e: event_time_us(e.get("eventTime")))
    return [e.get("properties") or {} for e in sel]


class TextDataSource(DataSource):
    params_cls = DataSourceParams
    params_aliases = {"appName": "app_name", "eventNames": "event_names"}

    def read_training(self, ctx) -> TrainingData:
        """The text and label of every selected event that has both: from
        ``ctx.events`` when the caller handed events over, else a chunked
        scan of the event store."""
        p: DataSourceParams = self.params
        t0 = time.perf_counter()
        if ctx.events is not None:
            batches = [_document_properties(ctx.events, p.event_names,
                                            p.entity_type)]
        else:
            batches = (b.properties for b in PEventStore.find_batches(
                p.app_name or ctx.app_name,
                event_names=list(p.event_names),
                entity_type=p.entity_type,
                storage=ctx.get_storage(),
                channel_name=ctx.channel_name))
        texts, labels = [], []
        for batch in batches:
            for props in batch:
                if p.text_property in props and p.label_property in props:
                    texts.append(str(props[p.text_property]))
                    labels.append(props[p.label_property])
        label_values, y = np.unique(np.asarray(labels), return_inverse=True)
        ctx.record_read(time.perf_counter() - t0, len(texts))
        return TrainingData(texts, y.astype(np.int32), label_values)

    def read_eval(self, ctx):
        """Three folds (seed 2); each held-out document is a query whose
        actual is its category."""
        td = self.read_training(ctx)
        folds = []
        for train_sel, test_sel in k_fold_indices(len(td.texts), k=3,
                                                  seed=2):
            train = TrainingData(
                [td.texts[j] for j in np.nonzero(train_sel)[0]],
                td.labels[train_sel], td.label_values)
            queries = [
                ({"text": td.texts[j]},
                 {"category": str(td.label_values[td.labels[j]])})
                for j in np.nonzero(test_sel)[0]
            ]
            folds.append((train, None, queries))
        return folds


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    n_features: int = 4096
    ngram: int = 1


class TextPreparator(Preparator):
    """Fits the hashing TF-IDF: the raw term counts as COO and the idf."""

    params_cls = PreparatorParams
    params_aliases = {"numFeatures": "n_features", "nGram": "ngram"}

    def prepare(self, ctx, td: TrainingData) -> PreparedData:
        vec = TfIdfVectorizer(n_features=self.params.n_features,
                              ngram=self.params.ngram)
        coo = vec.fit_tf_coo(td.texts)
        return PreparedData(None, td.labels, td.label_values, vec,
                            features_are_tf=True, coo=coo)


@dataclasses.dataclass
class TextModel:
    inner: object
    vectorizer: TfIdfVectorizer
    label_values: np.ndarray

    def classify(self, text: str) -> tuple[str, float]:
        x = self.vectorizer.transform([text])
        if isinstance(self.inner, NaiveBayesModel):
            scores = self.inner.predict_log_joint(x)[0]
            z = scores - scores.max()
            probs = np.exp(z) / np.exp(z).sum()
        else:
            probs = self.inner.predict_proba(x)[0]
        c = int(np.argmax(probs))
        return str(self.label_values[c]), float(probs[c])


def model_to_persisted(model: TextModel) -> dict:
    """Arrays and JSON: the inner model's, the vectorizer's ``to_arrays``
    (prefixed ``vectorizer_``) and the labels (a ``<U`` array)."""
    vec = {f"vectorizer_{k}": np.asarray(v)
           for k, v in model.vectorizer.to_arrays().items()}
    return {**inner_to_persisted(model.inner), **vec,
            "label_values": np.asarray(model.label_values, str)}


def model_from_persisted(stored: dict) -> TextModel:
    vec = {k[len("vectorizer_"):]: v for k, v in stored.items()
           if k.startswith("vectorizer_")}
    return TextModel(inner=inner_from_persisted(stored),
                     vectorizer=TfIdfVectorizer.from_arrays(vec),
                     label_values=np.asarray(stored["label_values"], str))


@dataclasses.dataclass(frozen=True)
class TextAlgorithmParams(Params):
    smoothing: float = 1.0  # NB
    reg: float = 0.0  # LR
    max_iters: int = 100  # LR


class TextNBAlgorithm(Algorithm):
    params_cls = TextAlgorithmParams
    params_aliases = {"lambda": "smoothing", "regParam": "reg"}

    def train(self, ctx, pd: PreparedData) -> TextModel:
        scale = pd.vectorizer.idf if pd.features_are_tf else None
        if pd.coo is not None:
            doc_ptr, feat, cnt = pd.coo
            inner = train_naive_bayes_coo(
                doc_ptr, feat, cnt, pd.labels,
                n_classes=len(pd.label_values),
                n_features=pd.vectorizer.n_features,
                smoothing=self.params.smoothing, col_scale=scale,
                device=ctx.device)
        else:
            inner = train_naive_bayes(
                pd.features, pd.labels, len(pd.label_values),
                smoothing=self.params.smoothing, col_scale=scale,
                device=ctx.device)
        return TextModel(inner, pd.vectorizer, pd.label_values)

    def predict(self, model: TextModel, query: dict) -> dict:
        category, confidence = model.classify(str(query["text"]))
        return {"category": category, "confidence": confidence}

    def prepare_model_for_persistence(self, model: TextModel) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> TextModel:
        return model_from_persisted(stored)


class TextLRAlgorithm(TextNBAlgorithm):
    def train(self, ctx, pd: PreparedData) -> TextModel:
        features = pd.dense_tf()
        if pd.features_are_tf:
            # LR is not linear in x: the idf scales the matrix itself
            features = features * pd.vectorizer.idf
        inner = train_logistic_regression(
            features, pd.labels, len(pd.label_values),
            reg=self.params.reg, max_iters=self.params.max_iters,
            device=ctx.device)
        return TextModel(inner, pd.vectorizer, pd.label_values)


class TextClassificationEngine(EngineFactory):
    """engine.json: "engineFactory": "incubator_predictionio_torch.models.
    text_classification.TextClassificationEngine"
    """

    def apply(self) -> Engine:
        return Engine(
            data_source_class=TextDataSource,
            preparator_class=TextPreparator,
            algorithm_class_map={
                "nb": TextNBAlgorithm,
                "lr": TextLRAlgorithm,
                "": TextNBAlgorithm,
            },
        )
