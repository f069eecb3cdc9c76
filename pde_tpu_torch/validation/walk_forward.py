"""Standalone walk-forward optimization + purged K-fold + OOS validation.

Plain copy of ``pde_tpu/validation/walk_forward.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference validation/walk_forward.py: window generation for
rolling/anchored schemes (:99-196), the optimize->evaluate runner (:197-306),
PurgedKFold with embargo (after Lopez de Prado; :307-377) and the
out-of-sample validator (:378-524).  The generic (model-agnostic) sibling of
pde_tpu_torch.backtest.analysis.WalkForwardAnalysis.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "WalkForwardType",
    "WalkForwardWindow",
    "WalkForwardResult",
    "WalkForwardReport",
    "WalkForwardOptimizer",
    "PurgedKFold",
    "OutOfSampleValidator",
]


class WalkForwardType(str, enum.Enum):
    ROLLING = "rolling"
    ANCHORED = "anchored"


@dataclass
class WalkForwardWindow:
    window_id: int
    train_start: int
    train_end: int
    test_start: int
    test_end: int

    @property
    def train_size(self) -> int:
        return self.train_end - self.train_start

    @property
    def test_size(self) -> int:
        return self.test_end - self.test_start


@dataclass
class WalkForwardResult:
    window: WalkForwardWindow
    best_params: Dict[str, Any]
    train_metric: float
    test_metric: float


@dataclass
class WalkForwardReport:
    results: List[WalkForwardResult] = field(default_factory=list)
    avg_train_metric: float = 0.0
    avg_test_metric: float = 0.0
    metric_decay: float = 0.0
    param_stability: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n_windows": len(self.results),
            "avg_train_metric": self.avg_train_metric,
            "avg_test_metric": self.avg_test_metric,
            "metric_decay": self.metric_decay,
            "param_stability": self.param_stability,
        }


class WalkForwardOptimizer:
    """Model-agnostic walk-forward: supply ``evaluate(data_slice, params) ->
    metric`` and a parameter list (walk_forward.py:99-306)."""

    def __init__(
        self,
        train_size: int = 252,
        test_size: int = 63,
        step_size: Optional[int] = None,
        scheme: WalkForwardType = WalkForwardType.ROLLING,
    ):
        self.train_size = train_size
        self.test_size = test_size
        self.step_size = step_size or test_size
        self.scheme = WalkForwardType(scheme)

    def generate_windows(self, n_observations: int) -> List[WalkForwardWindow]:
        windows = []
        start, wid = 0, 0
        while start + self.train_size + self.test_size <= n_observations:
            train_start = 0 if self.scheme == WalkForwardType.ANCHORED else start
            train_end = start + self.train_size
            windows.append(
                WalkForwardWindow(
                    window_id=wid,
                    train_start=train_start,
                    train_end=train_end,
                    test_start=train_end,
                    test_end=min(train_end + self.test_size, n_observations),
                )
            )
            wid += 1
            start += self.step_size
        return windows

    def run(
        self,
        data: np.ndarray,
        evaluate: Callable[[np.ndarray, Dict[str, Any]], float],
        param_candidates: Sequence[Dict[str, Any]],
    ) -> WalkForwardReport:
        results: List[WalkForwardResult] = []
        for w in self.generate_windows(len(data)):
            train = data[w.train_start : w.train_end]
            test = data[w.test_start : w.test_end]
            scored = [(evaluate(train, p), p) for p in param_candidates]
            train_metric, best = max(scored, key=lambda sp: sp[0])
            test_metric = evaluate(test, best)
            results.append(WalkForwardResult(w, best, train_metric, test_metric))

        report = WalkForwardReport(results=results)
        if results:
            report.avg_train_metric = float(np.mean([r.train_metric for r in results]))
            report.avg_test_metric = float(np.mean([r.test_metric for r in results]))
            report.metric_decay = (
                1.0 - report.avg_test_metric / report.avg_train_metric
                if report.avg_train_metric != 0
                else 0.0
            )
            # parameter stability: fraction of windows choosing the modal value
            keys = results[0].best_params.keys()
            for k in keys:
                values = [r.best_params[k] for r in results]
                _, counts = np.unique([str(v) for v in values], return_counts=True)
                report.param_stability[k] = float(counts.max() / len(values))
        return report


class PurgedKFold:
    """K-fold CV with purging + embargo for overlapping labels
    (walk_forward.py:307-377, after Lopez de Prado 2018 ch.7)."""

    def __init__(self, n_splits: int = 5, purge_gap: int = 5, embargo_pct: float = 0.01):
        if n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        self.n_splits = n_splits
        self.purge_gap = purge_gap
        self.embargo_pct = embargo_pct

    def split(self, n_observations: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        indices = np.arange(n_observations)
        embargo = int(n_observations * self.embargo_pct)
        fold_bounds = np.linspace(0, n_observations, self.n_splits + 1, dtype=int)
        for k in range(self.n_splits):
            t0, t1 = fold_bounds[k], fold_bounds[k + 1]
            test = indices[t0:t1]
            train_mask = np.ones(n_observations, dtype=bool)
            lo = max(0, t0 - self.purge_gap)
            hi = min(n_observations, t1 + self.purge_gap + embargo)
            train_mask[lo:hi] = False
            yield indices[train_mask], test


class OutOfSampleValidator:
    """Holdout OOS validation with degradation gates
    (walk_forward.py:378-524)."""

    def __init__(self, oos_fraction: float = 0.3, max_metric_decay: float = 0.5):
        if not 0 < oos_fraction < 1:
            raise ValueError("oos_fraction must be in (0, 1)")
        self.oos_fraction = oos_fraction
        self.max_metric_decay = max_metric_decay

    def split(self, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = len(data)
        cut = int(n * (1 - self.oos_fraction))
        return data[:cut], data[cut:]

    def validate(
        self,
        data: np.ndarray,
        evaluate: Callable[[np.ndarray], float],
    ) -> Dict[str, Any]:
        ins, oos = self.split(np.asarray(data))
        m_is = evaluate(ins)
        m_oos = evaluate(oos)
        # sign-safe: degradation measured against |IS| so a negative IS
        # metric cannot flip the gate open for a worse OOS metric
        decay = (m_is - m_oos) / max(abs(m_is), 1e-12)
        return {
            "in_sample_metric": float(m_is),
            "oos_metric": float(m_oos),
            "metric_decay": float(decay),
            "passed": decay <= self.max_metric_decay,
        }
