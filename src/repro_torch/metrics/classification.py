"""Classification metrics with 95% Wald confidence intervals (paper §6).

Macro-averaged one-vs-all Precision / Recall / F1 / FPR, matching the
paper's tables (metric ± Wald CI over the test set size).

A copy of ``repro.metrics.classification``, which is numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class ClassifierReport:
    accuracy: float
    precision: float
    recall: float
    f1: float
    fpr: float
    ci_accuracy: float
    n: int

    def row(self) -> Dict[str, float]:
        return {"accuracy": self.accuracy, "precision": self.precision,
                "recall": self.recall, "f1": self.f1, "fpr": self.fpr,
                "ci": self.ci_accuracy, "n": self.n}

    def __str__(self):
        pm = self.ci_accuracy * 100
        return (f"acc={self.accuracy*100:.2f}%±{pm:.2f} "
                f"prec={self.precision*100:.2f}% rec={self.recall*100:.2f}% "
                f"f1={self.f1*100:.2f}% fpr={self.fpr*100:.2f}%")


def wald_ci(p: float, n: int, z: float = 1.96) -> float:
    return z * np.sqrt(max(p * (1 - p), 0.0) / max(n, 1))


def evaluate(y_true: np.ndarray, y_pred: np.ndarray,
             num_classes: int = 10) -> ClassifierReport:
    n = y_true.shape[0]
    acc = float((y_true == y_pred).mean())
    precs, recs, f1s, fprs = [], [], [], []
    for c in range(num_classes):
        tp = float(np.sum((y_pred == c) & (y_true == c)))
        fp = float(np.sum((y_pred == c) & (y_true != c)))
        fn = float(np.sum((y_pred != c) & (y_true == c)))
        tn = float(np.sum((y_pred != c) & (y_true != c)))
        if tp + fn == 0:  # class absent from test set
            continue
        prec = tp / (tp + fp) if tp + fp > 0 else 0.0
        rec = tp / (tp + fn)
        f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
        fpr = fp / (fp + tn) if fp + tn > 0 else 0.0
        precs.append(prec); recs.append(rec); f1s.append(f1); fprs.append(fpr)
    return ClassifierReport(
        accuracy=acc, precision=float(np.mean(precs)), recall=float(np.mean(recs)),
        f1=float(np.mean(f1s)), fpr=float(np.mean(fprs)),
        ci_accuracy=wald_ci(acc, n), n=n)
