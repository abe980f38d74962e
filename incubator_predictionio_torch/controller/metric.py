"""Metrics of an evaluation: Metric, AverageMetric, OptionAverageMetric,
SumMetric, ZeroMetric.

The port's own copy of ``incubator_predictionio_tpu/controller/metric.py``
(reference: core/.../controller/Metric.scala). ``calculate`` consumes the
output of ``Engine.eval``: [(eval_info, [(query, predicted, actual), ...]),
...], one entry per fold.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple


class Metric:
    #: larger is better unless a subclass says otherwise
    higher_is_better: bool = True

    def header(self) -> str:
        return type(self).__name__

    def calculate(self, eval_data: Iterable[Tuple[object, list]]) -> float:
        raise NotImplementedError

    def compare(self, a: float, b: float) -> int:
        if a == b:
            return 0
        better = a > b if self.higher_is_better else a < b
        return 1 if better else -1


class AverageMetric(Metric):
    """Mean of the per-(query, predicted, actual) scores over all folds."""

    def calculate_unit(self, q, p, a) -> float:
        raise NotImplementedError

    def calculate(self, eval_data) -> float:
        total, n = 0.0, 0
        for _info, qpa in eval_data:
            for q, p, a in qpa:
                total += self.calculate_unit(q, p, a)
                n += 1
        return total / n if n else float("nan")


class OptionAverageMetric(AverageMetric):
    """Mean over the units that return a value; None units are left out."""

    def calculate_unit(self, q, p, a) -> Optional[float]:  # type: ignore[override]
        raise NotImplementedError

    def calculate(self, eval_data) -> float:
        total, n = 0.0, 0
        for _info, qpa in eval_data:
            for q, p, a in qpa:
                u = self.calculate_unit(q, p, a)
                if u is not None:
                    total += u
                    n += 1
        return total / n if n else float("nan")


class SumMetric(Metric):
    """Sum of the per-unit scores."""

    def calculate_unit(self, q, p, a) -> float:
        raise NotImplementedError

    def calculate(self, eval_data) -> float:
        return sum(self.calculate_unit(q, p, a)
                   for _info, qpa in eval_data for q, p, a in qpa)


class ZeroMetric(Metric):
    """Always 0 (an evaluation run for its side effects)."""

    def calculate(self, eval_data) -> float:
        return 0.0
