"""Evaluation statistics (pure numpy and scipy; no sklearn dependency).

The port's own copy of `stgcma_tpu/metrics/stats.py` (`calculate_stats`,
`avqa_type_accuracy`, `AverageMeter`), so that the port imports nothing of
the JAX package. Replaces utilities/stats.py:6-68 (per-class AP/AUC + global argmax accuracy,
d_prime) and AVQA's 9-question-type accuracy breakdown
(AVQA/traintest_adapt_avqa.py:289-373).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy import stats as _sstats


def d_prime(auc: float) -> float:
    return _sstats.norm().ppf(auc) * np.sqrt(2.0)


def _average_precision(target: np.ndarray, score: np.ndarray) -> float:
    """sklearn-equivalent average_precision_score (step interpolation)."""
    order = np.argsort(-score, kind="mergesort")
    t = target[order]
    tp = np.cumsum(t)
    fp = np.cumsum(1 - t)
    n_pos = t.sum()
    if n_pos == 0:
        return float("nan")
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / n_pos
    # sum over points where recall increases
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_recall) * precision))


def _roc_auc(target: np.ndarray, score: np.ndarray) -> float:
    """Mann-Whitney U formulation with tie handling."""
    pos = score[target == 1]
    neg = score[target == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    ranks = _sstats.rankdata(np.concatenate([pos, neg]))
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def _clf_curve(target: np.ndarray, score: np.ndarray):
    """Cumulative (fps, tps, thresholds) at distinct descending score values —
    sklearn's _binary_clf_curve, as numpy."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, target = score[order], target[order]
    distinct = np.where(np.diff(score))[0]
    idx = np.r_[distinct, target.size - 1]
    tps = np.cumsum(target)[idx]
    fps = 1 + idx - tps
    return fps, tps, score[idx]


def _pr_curve(target: np.ndarray, score: np.ndarray):
    """sklearn precision_recall_curve (drop_intermediate=False): (precision,
    recall), recall decreasing, trailing (1, 0) sentinel."""
    fps, tps, _ = _clf_curve(target, score)
    precision = tps / np.maximum(tps + fps, 1)
    recall = (tps / tps[-1]) if tps[-1] > 0 else np.ones_like(tps, float)
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0])


def _roc_points(target: np.ndarray, score: np.ndarray):
    """sklearn roc_curve(drop_intermediate=True): (fpr, tpr) with the (0,0)
    origin prepended and collinear interior points dropped."""
    fps, tps, _ = _clf_curve(target, score)
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fps = np.r_[0, fps]
    tps = np.r_[0, tps]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan, float)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan, float)
    return fpr, tpr


# Sample the stored curve arrays to bound the stats pickle size, the same
# stride the reference uses (utilities/stats.py:46).
SAVE_EVERY_STEPS = 1000


def calculate_stats(output: np.ndarray, target: np.ndarray) -> List[Dict]:
    """Per-class AP/AUC + sampled PR/ROC curve arrays + global argmax
    accuracy, same report schema as the reference (utilities/stats.py:11-68):
    each class dict carries precisions/recalls/AP/fpr/fnr/auc/acc, with the
    curve arrays subsampled at stride SAVE_EVERY_STEPS and -1 placeholders
    when the class has no positive (or no negative) samples."""
    classes_num = target.shape[-1]
    acc = float(np.mean(np.argmax(output, 1) == np.argmax(target, 1)))
    out = []
    for k in range(classes_num):
        t, s = target[:, k], output[:, k]
        ap = _average_precision(t, s)
        auc = _roc_auc(t, s)
        if np.isnan(auc):
            # degenerate class (single label value) — the reference's except
            # branch stores -1 placeholders for every curve field
            out.append({"precisions": -1, "recalls": -1, "AP": ap,
                        "fpr": -1, "fnr": -1, "auc": auc, "acc": acc})
            continue
        precisions, recalls = _pr_curve(t, s)
        fpr, tpr = _roc_points(t, s)
        out.append({"precisions": precisions[0::SAVE_EVERY_STEPS],
                    "recalls": recalls[0::SAVE_EVERY_STEPS],
                    "AP": ap,
                    "fpr": fpr[0::SAVE_EVERY_STEPS],
                    "fnr": 1.0 - tpr[0::SAVE_EVERY_STEPS],
                    "auc": auc, "acc": acc})
    return out


# ---------------------------------------------------------------------------
# AVQA 9-type accuracy (Audio/Visual/AV x question templates)
# ---------------------------------------------------------------------------

AVQA_TYPE_KEYS = [
    ("Audio", "Counting"), ("Audio", "Comparative"),
    ("Visual", "Counting"), ("Visual", "Location"),
    ("Audio-Visual", "Existential"), ("Audio-Visual", "Counting"),
    ("Audio-Visual", "Location"), ("Audio-Visual", "Comparative"),
    ("Audio-Visual", "Temporal"),
]


def avqa_type_accuracy(predictions: Sequence[int], answers: Sequence[int],
                       types: Sequence[Sequence[str]]) -> Dict[str, float]:
    """Per-question-type accuracies as in AVQA/traintest_adapt_avqa.py:289-373.
    `types[i]` is the parsed json 'type' field, e.g. ['Audio', 'Counting']."""
    buckets: Dict[str, List[int]] = {f"{m} {t}": [] for m, t in AVQA_TYPE_KEYS}
    total = []
    for p, a, ty in zip(predictions, answers, types):
        correct = int(p == a)
        total.append(correct)
        key = f"{ty[0]} {ty[1]}"
        if key in buckets:
            buckets[key].append(correct)
    report = {k: (float(np.mean(v)) * 100 if v else float("nan"))
              for k, v in buckets.items()}
    report["Overall"] = float(np.mean(total)) * 100 if total else float("nan")
    for modality in ("Audio", "Visual", "Audio-Visual"):
        vals = [c for (m, t) in AVQA_TYPE_KEYS if m == modality
                for c in buckets[f"{m} {t}"]]
        report[modality] = float(np.mean(vals)) * 100 if vals else float("nan")
    return report


class AverageMeter:
    """Running average (utilities/util.py AverageMeter equivalent)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)
