"""K-fold splitting.

The port's own copy of ``incubator_predictionio_tpu/e2/cross_validation.py``
(reference: e2/.../evaluation/CrossValidation.scala): the same seed gives
the same folds in both packages.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def k_fold_indices(
    n: int, k: int, seed: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (train_mask, test_mask) boolean pairs for k folds."""
    rng = np.random.default_rng(seed)
    fold = rng.integers(0, k, n)
    for f in range(k):
        test = fold == f
        yield ~test, test
