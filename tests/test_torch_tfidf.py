"""The port's hashing TF-IDF (``incubator_predictionio_torch/ops/tfidf.py``)
and its tokenizer bindings (``native.tfidf_tf`` / ``tfidf_tf_coo``, built
from the same ``native/src/event_codec.cc``) on the CPU against the
reference (``incubator_predictionio_tpu/ops/tfidf.py`` and its native
module), on the same documents:

- the tokenizer and the FNV-1a buckets;
- the codec's dense and COO passes, and the Python loop: counts, buckets
  and document frequencies identical, unigrams and bigrams, odd text
  included (lone surrogates, non-ASCII, empty documents);
- the fitted idf and ``to_arrays`` / ``from_arrays``;
- the no-fallback rule: a batch raises ``NativeUnavailable`` when the
  codec cannot be loaded, while up to four documents (a query's
  ``transform``) and ``use_native=False`` stay in Python.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from incubator_predictionio_tpu import native as ref_native  # noqa: E402
from incubator_predictionio_tpu.ops import tfidf as ref  # noqa: E402
from incubator_predictionio_torch import native  # noqa: E402
from incubator_predictionio_torch.ops import tfidf as port  # noqa: E402


def _docs(n=60, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{j}" for j in range(300)] + [
        "Don't", "naïve", "café", "I", "x" * 40, "a1b2", "it's"]
    docs = [" ".join(rng.choice(words, rng.integers(0, 30)))
            for _ in range(n)]
    docs += ["", "   ", "\ud800lone surrogate\udfff here", "Ünïcödé wörds",
             "punct,,,separated!!!words??", "MiXeD CaSe mixed case"]
    return docs


@pytest.mark.parametrize("ngram", [1, 2])
def test_tokenizer_and_buckets_are_the_references(ngram):
    for doc in _docs(20):
        assert port.tokenize(doc, ngram) == ref.tokenize(doc, ngram)
        for tok in port.tokenize(doc, ngram):
            assert port._hash_token(tok, 4096) == ref._hash_token(tok, 4096)


@pytest.mark.parametrize("ngram,d", [(1, 4096), (2, 257)])
def test_codec_passes_equal_the_reference_and_the_python_loop(ngram, d):
    docs = _docs()
    tf, df = native.tfidf_tf(docs, d, ngram, want_df=True)
    rtf, rdf = ref_native.tfidf_tf(docs, d, ngram, want_df=True)
    assert tf.dtype == np.float32 and np.array_equal(tf, rtf)
    assert np.array_equal(df, rdf)
    coo = native.tfidf_tf_coo(docs, d, ngram, want_df=True)
    rcoo = ref_native.tfidf_tf_coo(docs, d, ngram, want_df=True)
    for a, b in zip(coo, rcoo):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    vec = port.TfIdfVectorizer(n_features=d, ngram=ngram)
    assert np.array_equal(vec.term_frequencies(docs, use_native=False), tf)
    py = vec.tf_coo_block(docs, use_native=False)
    for a, b in zip(py, coo):
        assert np.array_equal(a, b)


def test_fit_idf_and_persistence_are_the_references():
    docs = _docs(80, seed=1)
    vec = port.TfIdfVectorizer(n_features=512)
    rvec = ref.TfIdfVectorizer(n_features=512)
    got = vec.fit_tf_coo(docs)
    want = rvec.fit_tf_coo(docs)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert vec.idf.dtype == np.float32 and np.array_equal(vec.idf, rvec.idf)
    assert np.array_equal(port.TfIdfVectorizer(n_features=512).fit_tf(docs),
                          rvec.fit_tf(docs))
    queries = ["w1 w2 w3", "café Don't", "", "unseen words only"]
    assert np.array_equal(vec.transform(queries), rvec.transform(queries))
    assert np.array_equal(vec.transform(docs), rvec.transform(docs))
    back = port.TfIdfVectorizer.from_arrays(vec.to_arrays())
    assert (back.n_features, back.ngram) == (512, 1)
    assert np.array_equal(back.idf, rvec.idf)
    assert np.array_equal(back.transform(docs), rvec.transform(docs))
    ref_back = ref.TfIdfVectorizer.from_arrays(vec.to_arrays())
    assert np.array_equal(ref_back.idf, vec.idf)
    with pytest.raises(ValueError, match="not fitted"):
        port.TfIdfVectorizer().transform(["x"])


def test_a_batch_needs_the_codec_and_a_query_does_not(monkeypatch):
    def broken():
        raise native.NativeUnavailable("no compiler")

    monkeypatch.setattr(native, "load", broken)
    vec = port.TfIdfVectorizer(n_features=64)
    vec.idf = np.ones(64, np.float32)
    docs = _docs(10)
    with pytest.raises(native.NativeUnavailable):
        vec.term_frequencies(docs)
    with pytest.raises(native.NativeUnavailable):
        vec.tf_coo_block(docs)
    with pytest.raises(native.NativeUnavailable):
        vec.fit_tf_coo(docs)
    # up to four documents, or use_native=False: the Python loop
    rvec = ref.TfIdfVectorizer(n_features=64)
    assert np.array_equal(vec.transform(docs[:4]),
                          rvec.term_frequencies(docs[:4], use_native=False))
    assert np.array_equal(vec.term_frequencies(docs, use_native=False),
                          rvec.term_frequencies(docs, use_native=False))
    for a, b in zip(vec.tf_coo_block(docs, use_native=False),
                    rvec.tf_coo_block(docs, use_native=False)):
        assert np.array_equal(a, b)
