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

With the input pipeline on (``pipeline_of(ctx)`` enables it for the
corpus, in ``chunk_docs`` documents), the preparator defers the
featurization and Naive Bayes streams it: tokenizer workers feed COO
blocks that are uploaded and scatter-added while the next block
tokenizes, and the idf is applied after the last one
(:meth:`TextNBAlgorithm._train_streamed`). In a gang every rank reads the
merged corpus and fits the same vectorizer (the template has no partition
branch, as the reference's); NB scatter-adds each rank's contiguous block
of documents and all-reduces the [C·D] sums, LR trains data-parallel on
the ranks' row blocks (``ops.linear``'s process-local trainers). Not
ported: the placement cost model (``stage_model``).
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
    NaiveBayesModel, gang_rows, train_logistic_regression,
    train_logistic_regression_process_local, train_naive_bayes,
    train_naive_bayes_coo, train_naive_bayes_coo_process_local,
    train_naive_bayes_coo_stream,
)
from ..ops.tfidf import TfIdfVectorizer
from ..parallel.distributed import process_count
from ..workflow.input_pipeline import (
    PipelineConfig, chunk_ranges, pipeline_of, prefetch, stats_into,
)
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
    #: the streaming preparation: the featurization is deferred (``coo`` is
    #: None) and the corpus rides along, so NB tokenizes, uploads and
    #: scatter-adds it chunk by chunk; a consumer that needs every
    #: document at once fits the same vectorizer in one go (:meth:`ensure_coo`)
    texts: Optional[list] = None

    def ensure_coo(self):
        """The one-shot COO of a deferred (streaming) preparation."""
        if self.coo is None and self.texts is not None:
            self.coo = self.vectorizer.fit_tf_coo(self.texts)
        return self.coo

    def dense_tf(self, rows: Optional[tuple] = None) -> np.ndarray:
        """The raw term-frequency matrix, made from the COO (LR needs whole
        rows; NB never calls this); ``rows`` = (lo, hi) makes only those
        documents' rows."""
        if self.features is not None:
            return (self.features if rows is None
                    else self.features[rows[0]:rows[1]])
        doc_ptr, feat, cnt = self.ensure_coo()
        doc_ptr = np.asarray(doc_ptr)
        lo, hi = (0, len(doc_ptr) - 1) if rows is None else rows
        a, b = int(doc_ptr[lo]), int(doc_ptr[hi])
        x = np.zeros((hi - lo, self.vectorizer.n_features), np.float32)
        x[np.repeat(np.arange(hi - lo), np.diff(doc_ptr[lo:hi + 1])),
          feat[a:b]] = cnt[a:b]
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
        cfg = pipeline_of(ctx)
        if cfg is not None and cfg.enabled_for(
                len(td.texts), chunk=cfg.chunk_docs, device=ctx.device):
            # tokenizing here would run the template's largest host cost
            # ahead of the upload and the statistics: defer it to the stream
            return PreparedData(None, td.labels, td.label_values, vec,
                                features_are_tf=True, texts=list(td.texts))
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

    gang_capable = True

    def train(self, ctx, pd: PreparedData) -> TextModel:
        cfg = pipeline_of(ctx)
        if pd.coo is None and pd.texts is not None:
            inner = self._train_streamed(ctx, pd, cfg)
            return TextModel(inner, pd.vectorizer, pd.label_values)
        scale = pd.vectorizer.idf if pd.features_are_tf else None
        if pd.coo is not None:
            doc_ptr, feat, cnt = pd.coo
            args = (doc_ptr, feat, cnt, pd.labels, len(pd.label_values),
                    pd.vectorizer.n_features, self.params.smoothing, scale)
            if process_count() > 1:
                # the gang: each rank's documents, the sums all-reduced
                inner = train_naive_bayes_coo_process_local(
                    *args, device=ctx.device, timings=ctx.bench_timings)
            else:
                with stats_into(ctx.bench_timings) as streamed:
                    inner = train_naive_bayes_coo(
                        *args, device=ctx.device, pipeline=cfg,
                        pipeline_stats=streamed)
        else:
            with stats_into(ctx.bench_timings) as streamed:
                inner = train_naive_bayes(
                    pd.features, pd.labels, len(pd.label_values),
                    smoothing=self.params.smoothing, col_scale=scale,
                    device=ctx.device, pipeline=cfg, pipeline_stats=streamed)
        return TextModel(inner, pd.vectorizer, pd.label_values)

    def _train_streamed(self, ctx, pd: PreparedData,
                        cfg: Optional[PipelineConfig]) -> NaiveBayesModel:
        """The overlapped text path (``_train_streamed`` :242): tokenizer
        workers featurize document chunk N+2 while chunk N+1 uploads and
        chunk N scatter-adds into the statistics on the card. The document
        frequencies accumulate on the consumer, in corpus order, and the
        idf is fitted from them after the last chunk: the one-shot
        prepare + train's model, bit for bit."""
        cfg = cfg or PipelineConfig.from_env()
        vec, texts, labels = pd.vectorizer, pd.texts, pd.labels
        n_docs = len(texts)
        df_acc = np.zeros(vec.n_features, np.int64)

        def featurize(rng):
            s, e = rng
            doc_ptr, feat, cnt, df = vec.tf_coo_block(texts[s:e])
            return (np.repeat(labels[s:e], np.diff(np.asarray(doc_ptr))),
                    feat, cnt, df)

        with stats_into(ctx.bench_timings) as streamed:
            def blocks():
                # the workers stay pure: df is summed here (int64, exact)
                for cls, feat, cnt, df in prefetch(
                        chunk_ranges(n_docs, cfg.chunk_docs), featurize,
                        workers=cfg.workers, lookahead=cfg.depth + 1,
                        stats=streamed):
                    np.add(df_acc, df, out=df_acc)
                    yield cls, feat, cnt

            return train_naive_bayes_coo_stream(
                blocks(), labels, n_classes=len(pd.label_values),
                n_features=vec.n_features, smoothing=self.params.smoothing,
                col_scale=((lambda: vec.set_idf_from_df(df_acc, n_docs))
                           if pd.features_are_tf else None),
                device=ctx.device, pipeline=cfg, pipeline_stats=streamed)

    def predict(self, model: TextModel, query: dict) -> dict:
        category, confidence = model.classify(str(query["text"]))
        return {"category": category, "confidence": confidence}

    def prepare_model_for_persistence(self, model: TextModel) -> dict:
        return model_to_persisted(model)

    def restore_model(self, stored, ctx) -> TextModel:
        return model_from_persisted(stored)


class TextLRAlgorithm(TextNBAlgorithm):
    def train(self, ctx, pd: PreparedData) -> TextModel:
        gang = process_count() > 1
        rows = gang_rows(len(pd.labels)) if gang else None
        features = pd.dense_tf(rows)
        if pd.features_are_tf:
            # LR is not linear in x: the idf scales the matrix itself
            features = features * pd.vectorizer.idf
        if gang:
            # the gang: this rank's documents, the gradient all-reduced
            inner = train_logistic_regression_process_local(
                features, pd.labels[rows[0]:rows[1]], len(pd.label_values),
                reg=self.params.reg, max_iters=self.params.max_iters,
                device=ctx.device, stats=ctx.bench_timings)
        else:
            with stats_into(ctx.bench_timings) as streamed:
                inner = train_logistic_regression(
                    features, pd.labels, len(pd.label_values),
                    reg=self.params.reg, max_iters=self.params.max_iters,
                    device=ctx.device, stats=ctx.bench_timings,
                    pipeline=pipeline_of(ctx), pipeline_stats=streamed)
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
