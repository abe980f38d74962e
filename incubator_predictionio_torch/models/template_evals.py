"""Evaluation and parameter tuning for the E-Commerce and Complementary
Purchase templates.

Port of ``incubator_predictionio_tpu/models/template_evals.py``: NDCG@k
over the held-out (query, actual) folds of each template's ``read_eval``,
computed by ``ops/eval.ranking_metrics`` on the evaluation's device (one
call per query), and a sweep per template: rank × lambda for E-Commerce,
correlator budget × LLR floor for Complementary Purchase::

    pio eval incubator_predictionio_torch.models.template_evals.ECommerceEvaluation \\
             incubator_predictionio_torch.models.template_evals.ECommerceParamsList
    pio eval incubator_predictionio_torch.models.template_evals.ComplementaryEvaluation \\
             incubator_predictionio_torch.models.template_evals.ComplementaryParamsList
"""

from __future__ import annotations

from ..controller import (
    EngineParams, EngineParamsGenerator, Evaluation, OptionAverageMetric,
)
from ..ops import eval as evalops
from .complementary_purchase import ComplementaryPurchaseEngine
from .ecommerce import ECommerceEngine


class NDCGAtK(OptionAverageMetric):
    """NDCG@k of the predicted ranking against the fold's held-out item,
    on ``device``. None (left out) when the engine returned no ranking
    for the query (an unknown user)."""

    def __init__(self, k: int = 10, device="cuda"):
        self.k = k
        self.device = device

    def header(self) -> str:
        return f"NDCG@{self.k}"

    def calculate_unit(self, q, p, a):
        items = [str(s["item"]) for s in p.get("itemScores", [])]
        if not items:
            return None
        label = a.get("item")
        if label is None:
            return None
        m = evalops.ranking_metrics([items], [{str(label)}], self.k,
                                    device=self.device)
        return float(m["ndcg"]) if m["n"] else None


class ECommerceEvaluation(Evaluation):
    """K-fold NDCG@k: held-out (user → item) interactions must rank high
    for that user. ``device``: where the metric runs (``pio eval
    --device``)."""

    def __init__(self, device="cuda"):
        self.engine = ECommerceEngine()()
        self.metric = NDCGAtK(k=10, device=device)
        self.metrics = (NDCGAtK(k=5, device=device),)


class ECommerceParamsList(EngineParamsGenerator):
    """Rank × lambda sweep (implicit ALS): 4 candidates."""

    def __init__(self, app_name: str = ""):
        ds = {"params": ({"appName": app_name} if app_name else {})}
        self.engine_params_list = [
            EngineParams.from_json({
                "datasource": ds,
                "algorithms": [{"name": "ecomm", "params": {
                    "appName": app_name, "rank": r,
                    "numIterations": 10, "lambda": lam,
                }}],
            })
            for r in (8, 16)
            for lam in (0.01, 0.1)
        ]


class ComplementaryEvaluation(Evaluation):
    """K-fold NDCG@k for basket completion: the held-out item of each
    shopper's basket must surface from the basket's other items.
    ``device``: where the metric runs (``pio eval --device``)."""

    def __init__(self, device="cuda"):
        self.engine = ComplementaryPurchaseEngine()()
        self.metric = NDCGAtK(k=10, device=device)
        self.metrics = (NDCGAtK(k=5, device=device),)


class ComplementaryParamsList(EngineParamsGenerator):
    """Correlator budget × LLR floor sweep: 4 candidates."""

    def __init__(self, app_name: str = ""):
        ds = {"params": ({"appName": app_name} if app_name else {})}
        self.engine_params_list = [
            EngineParams.from_json({
                "datasource": ds,
                "algorithms": [{"name": "cooccurrence", "params": {
                    "maxCorrelatorsPerItem": mc, "minLLR": llr,
                }}],
            })
            for mc in (10, 20)
            for llr in (0.0, 1.0)
        ]
