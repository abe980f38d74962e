"""MetricEvaluator — rank candidate EngineParams by a metric.

The port's own copy of ``incubator_predictionio_tpu/controller/
metric_evaluator.py`` (reference: core/.../controller/
MetricEvaluator.scala): the leaderboard text and the best params as JSON,
ready to paste into engine.json. Both are byte for byte the reference's
for the same inputs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence

from .engine import EngineParams
from .metric import Metric


@dataclasses.dataclass
class MetricEvaluatorResult:
    best_score: float
    best_engine_params: EngineParams
    best_index: int
    metric_header: str
    other_metric_headers: Sequence[str]
    all_results: Sequence[tuple[EngineParams, float, Sequence[float]]]

    def to_json(self) -> str:
        return json.dumps(
            {
                "bestScore": self.best_score,
                "bestIndex": self.best_index,
                "metricHeader": self.metric_header,
                "bestEngineParams": self.best_engine_params.to_json(),
                "results": [
                    {"engineParams": ep.to_json(), "score": s, "others": list(o)}
                    for ep, s, o in self.all_results
                ],
            },
            indent=2,
        )

    def pretty(self) -> str:
        lines = [
            "[MetricEvaluator] candidates ranked by " + self.metric_header,
        ]
        ranked = sorted(
            enumerate(self.all_results), key=lambda t: t[1][1], reverse=True
        )
        for i, (ep, score, others) in ranked:
            mark = "★" if i == self.best_index else " "
            lines.append(f"  {mark} [{i}] {self.metric_header}={score:.6f} "
                         + " ".join(f"{h}={v:.6f}" for h, v in zip(self.other_metric_headers, others)))
        lines.append("[MetricEvaluator] best engine params:")
        lines.append(json.dumps(self.best_engine_params.to_json(), indent=2))
        return "\n".join(lines)


class MetricEvaluator:
    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = ()):
        self.metric = metric
        self.other_metrics = tuple(other_metrics)

    def evaluate_candidates(
        self, candidates: Sequence[tuple[EngineParams, Any]]
    ) -> MetricEvaluatorResult:
        """candidates: [(engine_params, eval_data)], eval_data being
        ``Engine.eval``'s output for those params."""
        results = []
        for ep, eval_data in candidates:
            eval_data = list(eval_data)
            score = self.metric.calculate(eval_data)
            others = [m.calculate(eval_data) for m in self.other_metrics]
            results.append((ep, score, others))
        best_index = 0
        for i, (_, score, _) in enumerate(results):
            if self.metric.compare(score, results[best_index][1]) > 0:
                best_index = i
        best = results[best_index]
        return MetricEvaluatorResult(
            best_score=best[1],
            best_engine_params=best[0],
            best_index=best_index,
            metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            all_results=results,
        )
