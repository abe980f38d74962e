"""Evaluation and parameter tuning for the Recommendation template.

Port of ``incubator_predictionio_tpu/models/recommendation_eval.py``
(reference: the template's Evaluation.scala + ParamsList.scala): the
k-fold ``read_eval`` of ``models/recommendation.py``, a hit-rate metric,
and a rank × lambda sweep. ``pio eval`` ranks the candidates and persists
the leaderboard::

    pio eval incubator_predictionio_torch.models.recommendation_eval.RecommendationEvaluation \\
             incubator_predictionio_torch.models.recommendation_eval.ParamsList
"""

from __future__ import annotations

from ..controller import (
    EngineParams, EngineParamsGenerator, Evaluation, OptionAverageMetric,
)
from .recommendation import RecommendationEngine


class HitRateAtK(OptionAverageMetric):
    """Fraction of held-out (user, item) pairs whose item is in the user's
    top k. None (left out) when the actual rating is under the threshold
    or the user got no answer (unknown in the fold)."""

    def __init__(self, k: int = 10, rating_threshold: float = 0.0):
        self.k = k
        self.rating_threshold = rating_threshold

    def header(self) -> str:
        return f"HitRate@{self.k}"

    def calculate_unit(self, q, p, a):
        if a.get("rating", 0.0) < self.rating_threshold:
            return None
        items = [s["item"] for s in p.get("itemScores", [])[: self.k]]
        if not items:
            return None
        return 1.0 if a["item"] in items else 0.0


class RecommendationEvaluation(Evaluation):
    def __init__(self):
        self.engine = RecommendationEngine()()
        self.metric = HitRateAtK(k=10, rating_threshold=2.0)
        self.metrics = (HitRateAtK(k=5), HitRateAtK(k=20))


class ParamsList(EngineParamsGenerator):
    """Rank × regularization sweep: 4 candidates."""

    def __init__(self, app_name: str = ""):
        base = {"datasource": {"params": ({"appName": app_name} if app_name else {})}}
        self.engine_params_list = [
            EngineParams.from_json(
                {**base, "algorithms": [
                    {"name": "als",
                     "params": {"rank": r, "numIterations": 10, "lambda": lam}}
                ]}
            )
            for r in (8, 16)
            for lam in (0.01, 0.1)
        ]
