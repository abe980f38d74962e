"""PredictionIO on PyTorch and CUDA (NVIDIA Hopper).

The second package of the repository, beside ``incubator_predictionio_tpu``
(the JAX reference). It imports ``torch``, ``numpy`` and the standard
library only — never ``jax`` and nothing of the JAX package.

Every entry point takes ``device=`` and defaults to ``"cuda"``; asking for
CUDA on a host without a card raises (``device.resolve_device``). The CPU
runs only when the caller asks for it, and then every kernel runs its
plain PyTorch version.

What is ported so far: the storage layer (``data/storage``: SQLite, the
default, with the reference's schema; memory; localfs; the JSONL event
log with its columnar compaction, generations and training windows, read
through the C++ event codec of ``native/``), the event stores
(``data/store``), the event server (``data/api``), the train/deploy
workflow over engine-instance rows and checksummed model artifacts
(``workflow``), the ``pio`` verbs (``tools/console.py``), and the
Recommendation and Similar-Product templates (ALS with the Gauss-Jordan
SPD solve as hand-written CUDA kernels, ``ops/csrc/gauss_jordan.cu``).
"""

__version__ = "0.1.0"
