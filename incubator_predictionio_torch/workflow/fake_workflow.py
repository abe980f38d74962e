"""FakeWorkflow — a minimal in-process engine for workflow tests.

Port of ``incubator_predictionio_tpu/workflow/fake_workflow.py``
(reference: core/.../workflow/FakeWorkflow.scala): an engine whose data
source yields a few numbers and whose model is their sum, run through the
port's own :func:`.core_workflow.run_train`. With the memory storage
backend it makes a workflow test hermetic.
"""

from __future__ import annotations

import dataclasses
from ..controller import (
    Algorithm, DataSource, Engine, FirstServing, IdentityPreparator,
)


@dataclasses.dataclass
class FakeTrainingData:
    values: list


class FakeDataSource(DataSource):
    """Yields the values it was constructed with; counts its reads."""

    def __init__(self, params=None):
        super().__init__(params)
        self.read_count = 0
        self.values = ((params or {}).get("values", [1, 2, 3])
                       if isinstance(params, dict) else [1, 2, 3])

    def read_training(self, ctx) -> FakeTrainingData:
        self.read_count += 1
        return FakeTrainingData(list(self.values))

    def read_eval(self, ctx):
        td = self.read_training(ctx)
        qa = [({"q": v}, {"a": v}) for v in td.values]
        return [(td, None, qa)]


class FakeAlgorithm(Algorithm):
    """The model is the sum of the values; predict echoes the query and
    the model."""

    def train(self, ctx, pd: FakeTrainingData):
        return {"total": sum(pd.values)}

    def predict(self, model, query):
        return {"echo": query.get("q"), "total": model["total"]}

    def prepare_model_for_persistence(self, model) -> dict:
        return dict(model)

    def restore_model(self, stored, ctx):
        return dict(stored)


def fake_engine() -> Engine:
    return Engine(
        data_source_class=FakeDataSource,
        preparator_class=IdentityPreparator,
        algorithm_class_map={"": FakeAlgorithm},
        serving_class=FirstServing,
    )


def fake_run(ctx=None):
    """One train of :func:`fake_engine` through ``run_train`` (reference:
    FakeRun); returns the engine-instance id. ``ctx`` defaults to a
    context on the card."""
    from ..controller.engine import EngineParams
    from .context import WorkflowContext
    from .core_workflow import run_train

    engine = fake_engine()
    ctx = ctx or WorkflowContext()
    return run_train(engine, EngineParams(), ctx, engine_factory_name="fake")
