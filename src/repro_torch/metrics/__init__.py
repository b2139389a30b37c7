from repro_torch.metrics.scores import dataset_score, fid
from repro_torch.metrics.classification import ClassifierReport, evaluate, wald_ci

__all__ = ["dataset_score", "fid", "ClassifierReport", "evaluate", "wald_ci"]
