"""Small ML helpers of the e2 library.

Port of ``incubator_predictionio_tpu/e2/engine.py`` (reference:
e2/src/main/scala/.../e2/engine/{CategoricalNaiveBayes,BinaryVectorizer,
MarkovChain}.scala), host Python and numpy as there.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CategoricalNaiveBayesModel:
    """Naive Bayes over categorical string features: log priors and, per
    label, per feature position, the log likelihood of each value."""

    log_priors: dict[str, float]
    log_likelihoods: dict[str, list[dict[str, float]]]
    default_log_likelihood: float

    def log_score(self, features: Sequence[str],
                  label: str) -> Optional[float]:
        if label not in self.log_priors:
            return None
        ll = self.log_likelihoods[label]
        total = self.log_priors[label]
        for pos, value in enumerate(features):
            total += ll[pos].get(value, self.default_log_likelihood)
        return total

    def predict(self, features: Sequence[str]) -> str:
        return max(self.log_priors,
                   key=lambda lab: self.log_score(features, lab))


class CategoricalNaiveBayes:
    """Train from (label, [categorical features...]) points."""

    @staticmethod
    def train(points: Iterable[tuple[str, Sequence[str]]],
              default_log_likelihood: float = math.log(1e-9)
              ) -> CategoricalNaiveBayesModel:
        points = list(points)
        if not points:
            raise ValueError("no labeled points")
        n_positions = len(points[0][1])
        label_counts: dict[str, int] = defaultdict(int)
        value_counts: dict[str, list[dict[str, int]]] = {}
        for label, feats in points:
            label_counts[label] += 1
            if label not in value_counts:
                value_counts[label] = [defaultdict(int)
                                       for _ in range(n_positions)]
            for pos, v in enumerate(feats):
                value_counts[label][pos][v] += 1
        total = sum(label_counts.values())
        log_priors = {lab: math.log(c / total)
                      for lab, c in label_counts.items()}
        log_likelihoods = {
            lab: [{v: math.log(c / label_counts[lab])
                   for v, c in pos_counts.items()}
                  for pos_counts in value_counts[lab]]
            for lab in label_counts
        }
        return CategoricalNaiveBayesModel(log_priors, log_likelihoods,
                                          default_log_likelihood)


class BinaryVectorizer:
    """Categorical (position, value) pairs → binary vectors."""

    def __init__(self, index: Mapping[tuple[int, str], int]):
        self.index = dict(index)

    @staticmethod
    def fit(points: Iterable[Sequence[str]]) -> "BinaryVectorizer":
        index: dict[tuple[int, str], int] = {}
        for feats in points:
            for pos, v in enumerate(feats):
                if (pos, v) not in index:
                    index[(pos, v)] = len(index)
        return BinaryVectorizer(index)

    @property
    def n_features(self) -> int:
        return len(self.index)

    def transform(self, feats: Sequence[str]) -> np.ndarray:
        x = np.zeros(len(self.index), np.float32)
        for pos, v in enumerate(feats):
            j = self.index.get((pos, v))
            if j is not None:
                x[j] = 1.0
        return x


def markov_chain(matrix_counts: np.ndarray,
                 top_k: int) -> list[list[tuple[int, float]]]:
    """Row-normalized transition probabilities, the top-k per state."""
    counts = np.asarray(matrix_counts, np.float64)
    out = []
    for row in counts:
        total = row.sum()
        if total <= 0:
            out.append([])
            continue
        probs = row / total
        idx = np.argsort(-probs)[:top_k]
        out.append([(int(j), float(probs[j])) for j in idx if probs[j] > 0])
    return out
