"""The port's NaN guard (``common/nan_guard.py``, ``train_als(nan_guard=)``,
``Engine.train`` under ``WorkflowParams.nan_guard``) on the CPU, mirroring
``tests/test_nan_guard.py``: the same messages as the reference's
``check_finite`` for numpy arrays, and for torch tensors too; ALS names the
iteration; every DASE stage is guarded.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from incubator_predictionio_tpu.common import nan_guard as ref_guard  # noqa: E402
from incubator_predictionio_tpu.ops import als as ref_als  # noqa: E402
from incubator_predictionio_torch.common.nan_guard import (  # noqa: E402
    NaNGuardError, check_finite,
)
from incubator_predictionio_torch.controller import (  # noqa: E402
    Algorithm, DataSource, Engine, EngineParams,
)
from incubator_predictionio_torch.ops import als as port_als  # noqa: E402
from incubator_predictionio_torch.workflow.context import WorkflowContext  # noqa: E402
from incubator_predictionio_torch.workflow.workflow_params import WorkflowParams  # noqa: E402


def _message(fn, obj, stage="algorithm[x]"):
    with pytest.raises(Exception) as e:
        fn(obj, stage)
    return str(e.value)


@dataclasses.dataclass
class FakeModel:
    weights: object
    _cache: object = None  # underscore fields are skipped


@pytest.mark.parametrize("obj", [
    FakeModel(np.array([1.0, np.nan, np.inf], np.float32)),
    {"outer": [{"inner": np.array([np.nan])}]},
    {"loss": np.float32(np.nan)},
    {"lvl": {"lvl": {"lvl": {"lvl": {"lvl": {"lvl": {"lvl": {
        "lvl": np.array([1.0], np.float32)}}}}}}}},
], ids=["dataclass", "nested", "scalar", "too-deep"])
def test_check_finite_messages_match_reference(obj):
    assert _message(check_finite, obj) == _message(ref_guard.check_finite, obj)


def test_check_finite_names_stage_and_field():
    ok = FakeModel(np.ones((3, 3), np.float32),
                   _cache=np.array([np.nan], np.float32))
    check_finite(ok, "algorithm[x]")  # no raise: the cache is not state
    bad = FakeModel(np.array([1.0, np.nan, np.inf], np.float32))
    with pytest.raises(NaNGuardError, match=r"stage: algorithm\[x\]") as e:
        check_finite(bad, "algorithm[x]")
    assert "weights" in str(e.value) and "2/3" in str(e.value)
    check_finite({"idx": np.array([1, 2, 3]), "n": np.int64(7)}, "s")


def test_check_finite_takes_torch_tensors():
    """A tensor is checked where it lives, with the numpy message."""
    t = torch.tensor([1.0, float("nan"), float("inf"), 2.0])
    assert _message(check_finite, FakeModel(t)) == _message(
        ref_guard.check_finite, FakeModel(t.numpy()))
    check_finite({"w": torch.ones(4), "idx": torch.arange(3),
                  "empty": torch.empty(0)}, "s")
    with pytest.raises(NaNGuardError, match=r"inner \(1/1 elements\)"):
        check_finite({"outer": ({"inner": torch.tensor([float("inf")])},)},
                     "s")


def _poisoned():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 30, 300).astype(np.int32)
    i = rng.integers(0, 20, 300).astype(np.int32)
    r = rng.random(300).astype(np.float32)
    r[17] = np.nan  # poisoned input → first solve already non-finite
    return u, i, r


def test_als_nan_guard_names_iteration():
    u, i, r = _poisoned()
    params = port_als.ALSParams(rank=4, num_iterations=3)
    with pytest.raises(NaNGuardError) as e:
        port_als.train_als(u, i, r, 30, 20, params, device="cpu",
                           nan_guard=True)
    with pytest.raises(ref_guard.NaNGuardError) as e_ref:
        ref_als.train_als(u, i, r, 30, 20, ref_als.ALSParams(rank=4,
                                                             num_iterations=3),
                          nan_guard=True)
    assert str(e.value) == str(e_ref.value)
    assert "stage: algorithm[als], iteration 1: non-finite factors" in str(
        e.value)
    with pytest.raises(NaNGuardError, match=r"stage: algorithm\[b\], "
                                            r"iteration 1"):
        port_als.train_als(u, i, r, 30, 20, params, device="cpu",
                           nan_guard=True, nan_guard_stage="algorithm[b]")
    # guard off: the old behavior (garbage model, no raise)
    out = port_als.train_als(u, i, r, 30, 20, params, device="cpu")
    assert out.user_factors.shape == (30, 4)


def test_als_nan_guard_reads_one_scalar_per_iteration(monkeypatch):
    """Clean ratings: the guarded train runs one iteration at a time, reads
    one finiteness scalar per iteration, and gives the unguarded factors."""
    u, i, r = _poisoned()
    r[17] = 0.5
    params = port_als.ALSParams(rank=4, num_iterations=3)
    plain = port_als.train_als(u, i, r, 30, 20, params, device="cpu")
    steps, probes = [], []
    real_iterate = port_als.ALSTrainer.iterate
    real_finite = port_als.ALSTrainer.finite
    monkeypatch.setattr(port_als.ALSTrainer, "iterate",
                        lambda self, n: (steps.append(n),
                                         real_iterate(self, n)))
    monkeypatch.setattr(port_als.ALSTrainer, "finite",
                        lambda self: (probes.append(1), real_finite(self))[1])
    guarded = port_als.train_als(u, i, r, 30, 20, params, device="cpu",
                                 nan_guard=True)
    assert steps == [1, 1, 1] and len(probes) == 3
    np.testing.assert_array_equal(guarded.user_factors, plain.user_factors)
    np.testing.assert_array_equal(guarded.item_factors, plain.item_factors)


def test_engine_train_guards_every_stage():
    """An algorithm that emits NaN fails at algorithm[name]; poisoned
    source data fails at datasource — each with stage attribution."""

    class DS(DataSource):
        poisoned = False

        def read_training(self, ctx):
            return {"x": np.array([np.nan if self.poisoned else 1.0],
                                  np.float32)}

    class NaNAlgo(Algorithm):
        def train(self, ctx, pd):
            assert ctx.stage_label == "algorithm[bad]"
            return {"weights": torch.tensor([float("nan")])}

        def predict(self, model, q):
            return {}

    engine = Engine(DS, algorithm_class_map={"bad": NaNAlgo})
    ctx = WorkflowContext(events=[], device="cpu")
    ep = EngineParams(algorithm_params_list=[("bad", {})])

    with pytest.raises(NaNGuardError, match=r"stage: algorithm\[bad\]"):
        engine.train(ctx, ep, WorkflowParams(nan_guard=True))
    assert ctx.workflow_params.nan_guard
    # guard off: trains fine (old behavior)
    models = engine.train(ctx, ep, WorkflowParams())
    assert len(models) == 1
    # halted before the algorithm: nothing is trained, nothing guarded
    assert engine.train(ctx, ep, WorkflowParams(
        nan_guard=True, stop_after_prepare=True)) == []

    DS.poisoned = True
    with pytest.raises(NaNGuardError, match="stage: datasource"):
        engine.train(ctx, ep, WorkflowParams(nan_guard=True))
    assert engine.train(ctx, ep, WorkflowParams(stop_after_read=True)) == []


def test_engine_train_skips_sanity_checks_on_request():
    from incubator_predictionio_torch.models import recommendation as rec

    engine = rec.RecommendationEngine()()
    ep = EngineParams.from_json({"algorithms": [{"name": "als", "params": {}}]})
    ctx = WorkflowContext(events=[], device="cpu")
    with pytest.raises(ValueError, match="no rating events"):
        engine.train(ctx, ep, WorkflowParams(stop_after_read=True))
    assert engine.train(ctx, ep, WorkflowParams(
        skip_sanity_check=True, stop_after_read=True)) == []
