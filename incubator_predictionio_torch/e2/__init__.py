"""ML helper library: k-fold splitting for ``read_eval``, and the e2
engine helpers (categorical Naive Bayes, the binary vectorizer, Markov
chains)."""

from .cross_validation import k_fold_indices
from .engine import BinaryVectorizer, CategoricalNaiveBayes, markov_chain

__all__ = [
    "BinaryVectorizer", "CategoricalNaiveBayes", "k_fold_indices",
    "markov_chain",
]
