"""Epoch metrics accumulated on the host (port of the JAX package's
``train/metrics.py``): per-class average precision and thresholded binary
accuracy, each giving a mean plus per-class entries.

``average_precision`` computes what ``sklearn.metrics.average_precision_score``
does, in numpy, since the machine with the card has no scikit-learn."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = Σ_k (R_k − R_{k−1})·P_k over the distinct score thresholds in
    descending order (sklearn's step-wise definition, no interpolation)."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    # the last index of each run of equal scores
    last = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[last]
    fps = 1 + last - tps
    if tps[-1] == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


class PerClassMetric:
    name: str = ""

    def __init__(self, classes: Sequence[str]):
        self.classes = list(classes)
        self.reset()

    def reset(self) -> None:
        self.predictions: list[np.ndarray] = []
        self.targets: list[np.ndarray] = []

    def update(self, step_output: dict) -> None:
        self.predictions.append(np.asarray(step_output["prediction"]))
        self.targets.append(np.asarray(step_output["target"]))

    def compute(self) -> list[float]:
        raise NotImplementedError

    def results(self, prefix: str = "") -> dict[str, float]:
        scores = self.compute()
        out = {f"{prefix}{self.name}": float(np.mean(scores))}
        for i, cls in enumerate(self.classes):
            out[f"{prefix}{self.name}_{cls.lower()}"] = float(scores[i])
        return out


class AveragePrecision(PerClassMetric):
    name = "average_precision"

    def compute(self) -> list[float]:
        y_true = np.concatenate(self.targets, axis=0)
        y_pred = np.concatenate(self.predictions, axis=0)
        # a class absent from the split scores 0, as sklearn's does
        return [average_precision(y_true[:, c], y_pred[:, c])
                if (y_true[:, c] > 0).any() else 0.0
                for c in range(y_true.shape[1])]


class Accuracy(PerClassMetric):
    name = "binary_accuracy"

    def __init__(self, classes: Sequence[str], threshold: float = 0.5):
        super().__init__(classes)
        self.threshold = threshold

    def compute(self) -> list[float]:
        y_true = np.concatenate(self.targets, axis=0) > self.threshold
        y_pred = np.concatenate(self.predictions, axis=0) > self.threshold
        return [float((y_true[:, c] == y_pred[:, c]).mean()) for c in range(y_true.shape[1])]
