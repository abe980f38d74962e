"""ML helper library: k-fold splitting for ``read_eval``."""

from .cross_validation import k_fold_indices

__all__ = ["k_fold_indices"]
