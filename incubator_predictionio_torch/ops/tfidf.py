"""Hashing TF-IDF for the Text-Classification template (host numpy).

Port of ``incubator_predictionio_tpu/ops/tfidf.py``: the tokenizer
(``[A-Za-z0-9']+``, lower-cased, optional n-grams), the FNV-1a bucket hash
(:func:`_hash_token`), MLlib's idf ``log((n + 1) / (df + 1))`` and the
``to_arrays`` / ``from_arrays`` persistence are the reference's, so the
hashed buckets, the counts and the idf are bit for bit the same.

A batch of documents goes through the event codec's tokenizer
(``native.tfidf_tf`` / ``native.tfidf_tf_coo``, bit-identical to the
Python loop). That is the only batch path: when the codec cannot be built
the call raises :class:`..native.NativeUnavailable` (the reference falls
back to Python there). Two explicit choices keep the Python loop: up to
four documents per call (a serving query's ``transform``), and
``use_native=False``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z0-9']+")

#: a call with at most this many documents stays in the Python loop (the
#: memoized hash cache beats the ctypes call for a serving query)
_PYTHON_DOCS_MAX = 4


def tokenize(text: str, ngram: int = 1) -> list[str]:
    toks = [t.lower() for t in _TOKEN_RE.findall(text)]
    if ngram <= 1:
        return toks
    out = list(toks)
    for n in range(2, ngram + 1):
        out += [" ".join(toks[j:j + n]) for j in range(len(toks) - n + 1)]
    return out


def _hash_token(tok: str, n_features: int) -> int:
    """FNV-1a over the token's UTF-8 bytes, modulo ``n_features``: the
    same bucket in every process, so a model survives a restart."""
    h = 2166136261
    for b in tok.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % n_features


@dataclasses.dataclass
class TfIdfVectorizer:
    n_features: int = 4096
    ngram: int = 1
    idf: Optional[np.ndarray] = None  # [D], set by a fit
    #: token → bucket, memoized per distinct token (capped: ``transform``
    #: runs per query on arbitrary text)
    _hash_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def _doc_hashed_indices(self, doc: str) -> Optional[np.ndarray]:
        """The bucket of every token occurrence of one document (None when
        it has no token): the one Python tokenizer loop."""
        toks = tokenize(doc, self.ngram)
        if not toks:
            return None
        cache = self._hash_cache
        idxs = np.empty(len(toks), np.int64)
        for j, tok in enumerate(toks):
            h = cache.get(tok)
            if h is None:
                h = _hash_token(tok, self.n_features)
                if len(cache) < 1_000_000:
                    cache[tok] = h
            idxs[j] = h
        return idxs

    def term_frequencies(self, docs: Sequence[str],
                         use_native: Optional[bool] = None,
                         want_df: bool = False):
        """[N, D] counts (with ``want_df``: ``(tf, df)``, df the number of
        documents each bucket occurs in). More than four documents go
        through the codec unless ``use_native`` is False."""
        D = self.n_features
        if use_native is True or (use_native is None
                                  and len(docs) > _PYTHON_DOCS_MAX):
            from ..native import tfidf_tf

            return tfidf_tf(docs, D, self.ngram, want_df=want_df)
        x = np.zeros((len(docs), D), np.float32)
        for row, doc in enumerate(docs):
            idxs = self._doc_hashed_indices(doc)
            if idxs is not None:
                x[row] = np.bincount(idxs, minlength=D)
        if want_df:
            return x, np.count_nonzero(x, axis=0).astype(np.int64)
        return x

    def tf_coo_block(self, docs: Sequence[str],
                     use_native: Optional[bool] = None):
        """``(doc_ptr [N+1] int64, feat [nnz] int32, counts [nnz] float32,
        df [D] int64)`` of a block of documents, each document's entries
        in ascending bucket id, without touching the fit. Through the
        codec unless ``use_native`` is False."""
        D = self.n_features
        if use_native is not False:
            from ..native import tfidf_tf_coo

            return tfidf_tf_coo(docs, D, self.ngram, want_df=True)
        doc_ptr = np.zeros(len(docs) + 1, np.int64)
        feats, cnts = [], []
        df = np.zeros(D, np.int64)
        for row, doc in enumerate(docs):
            idxs = self._doc_hashed_indices(doc)
            added = 0
            if idxs is not None:
                nz, nz_counts = np.unique(idxs, return_counts=True)
                feats.append(nz.astype(np.int32))
                cnts.append(nz_counts.astype(np.float32))
                df[nz] += 1
                added = len(nz)
            doc_ptr[row + 1] = doc_ptr[row] + added
        feat = np.concatenate(feats) if feats else np.empty(0, np.int32)
        counts = np.concatenate(cnts) if cnts else np.empty(0, np.float32)
        return doc_ptr, feat, counts, df

    def set_idf_from_df(self, df: np.ndarray, n_docs: int) -> np.ndarray:
        """MLlib's idf, ``log((n + 1) / (df + 1))``, from the document
        frequencies."""
        self.idf = np.log((n_docs + 1.0) / (df + 1.0)).astype(np.float32)
        return self.idf

    def fit_tf_coo(self, docs: Sequence[str],
                   use_native: Optional[bool] = None):
        """Fit the idf and return ``(doc_ptr, feat, counts)``, the raw
        term counts as COO: the dense matrix is never made."""
        doc_ptr, feat, counts, df = self.tf_coo_block(docs, use_native)
        self.set_idf_from_df(df, len(docs))
        return doc_ptr, feat, counts

    def fit_tf(self, docs: Sequence[str]) -> np.ndarray:
        """Fit the idf and return the raw term-frequency matrix."""
        tf, df = self.term_frequencies(docs, want_df=True)
        self.set_idf_from_df(df, len(docs))
        return tf

    def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
        return self.fit_tf(docs) * self.idf

    def transform(self, docs: Sequence[str]) -> np.ndarray:
        if self.idf is None:
            raise ValueError("vectorizer is not fitted")
        return self.term_frequencies(docs) * self.idf

    def to_arrays(self) -> dict:
        return {
            "idf": self.idf,
            "n_features": np.asarray(self.n_features),
            "ngram": np.asarray(self.ngram),
        }

    @classmethod
    def from_arrays(cls, arrays: dict) -> "TfIdfVectorizer":
        return cls(
            n_features=int(arrays["n_features"]),
            ngram=int(arrays["ngram"]),
            idf=np.asarray(arrays["idf"], np.float32),
        )
