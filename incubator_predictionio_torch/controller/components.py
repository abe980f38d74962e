"""The DASE component bases: DataSource, Preparator, Algorithm, Serving.

Port of ``incubator_predictionio_tpu/controller/{datasource,preparator,
algorithm,serving}.py``. The reference's P/L names (``PDataSource``,
``P2LAlgorithm``, ...) say where a Spark component's data lives; here they
are aliases of the one base class, so template code reads as upstream.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence, Tuple

from .base import AbstractDoer
from .persistent_model import PersistentModel


class DataSource(AbstractDoer):
    """``read_training(ctx)`` feeds ``pio train``; ``read_eval(ctx)`` gives
    the folds of ``pio eval``: [(training data, eval info, [(query,
    actual), ...]), ...]. ``partition_feed``: with the partition feed
    armed the source reads only a gang worker's event-log partitions
    (``workflow/train_feed.py``), and marks its training data
    ``partition_local`` for the data-parallel trainer."""

    partition_feed = False

    def read_training(self, ctx) -> Any:
        raise NotImplementedError

    def read_eval(self, ctx) -> Sequence[Tuple[Any, Any, Iterable]]:
        """No eval folds unless the template defines them."""
        return []


class Preparator(AbstractDoer):
    def prepare(self, ctx, training_data) -> Any:
        raise NotImplementedError


class IdentityPreparator(Preparator):
    """Pass-through."""

    def prepare(self, ctx, training_data):
        return training_data


class Algorithm(AbstractDoer):
    """``gang_capable``: the algorithm trains in a gang, so ``pio train
    --num-workers N`` may run it: through ``ops.als`` (the slab gang on a
    merged read, the data-parallel trainer on a partition-local one),
    through the linear trainers' process-local forms (``ops.linear``) or
    through the CCO counts split over the ranks (``ops.llr``)."""

    gang_capable = False

    def train(self, ctx, prepared_data) -> Any:
        raise NotImplementedError

    def predict(self, model, query) -> Any:
        raise NotImplementedError

    def batch_predict(self, model, queries: Sequence) -> list:
        """Default: loop over predict."""
        return [self.predict(model, q) for q in queries]

    def prepare_model_for_persistence(self, model) -> Any:
        """Model → a dict of host (numpy / JSON-able) values."""
        raise NotImplementedError

    def restore_model(self, stored, ctx) -> Any:
        """Inverse of prepare_model_for_persistence, onto ``ctx.device``.
        A self-persisted model (a PersistentModel its class loaded) is
        served as loaded."""
        if isinstance(stored, PersistentModel):
            return stored
        raise NotImplementedError


class Serving(AbstractDoer):
    def serve(self, query, predictions: Sequence) -> Any:
        raise NotImplementedError

    def supplement(self, query):
        """Pre-predict query enrichment hook."""
        return query


class FirstServing(Serving):
    """Single-algorithm passthrough."""

    def serve(self, query, predictions):
        return predictions[0]


class AverageServing(Serving):
    """Numeric mean of the algorithms' predictions."""

    def serve(self, query, predictions):
        return sum(predictions) / len(predictions)


PDataSource = LDataSource = DataSource
PPreparator = LPreparator = Preparator
PIdentityPreparator = IdentityPreparator
PAlgorithm = P2LAlgorithm = LAlgorithm = Algorithm
LServing = Serving
