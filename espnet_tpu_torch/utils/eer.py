"""EER and minDCF of verification scores (counterpart of
espnet_tpu/utils/eer.py), in numpy: the same descending ``argsort``, so
tied scores fall in the same order and give the same figures."""

from __future__ import annotations

import numpy as np


def _error_rates(scores, labels):
    """-> (false accepts, false rejects) at each score taken as the
    threshold, highest first, and the scores in that order."""
    order = np.argsort(scores)[::-1]
    labels = np.asarray(labels)[order]
    n_target = max(labels.sum(), 1)
    n_non = max(len(labels) - labels.sum(), 1)
    fa = np.cumsum(1 - labels) / n_non
    fr = 1.0 - np.cumsum(labels) / n_target
    return fa, fr, np.asarray(scores)[order]


def _eer_index(fa, fr):
    return np.nanargmin(np.abs(fa - fr))


def _dcf(fa, fr, p_target, c_miss=1.0, c_fa=1.0):
    return c_miss * fr * p_target + c_fa * fa * (1 - p_target)


def compute_eer(scores: np.ndarray, labels: np.ndarray):
    """scores: similarities; labels: 1 target, 0 non-target ->
    (EER, its threshold)."""
    fa, fr, scores = _error_rates(scores, labels)
    idx = _eer_index(fa, fr)
    return float((fa[idx] + fr[idx]) / 2.0), float(scores[idx])


def compute_min_dcf(scores, labels, p_target: float = 0.05,
                    c_miss: float = 1.0, c_fa: float = 1.0) -> float:
    """The least detection cost over thresholds, over the cost of
    always rejecting or always accepting, whichever is lower."""
    fa, fr, _ = _error_rates(scores, labels)
    dcf = _dcf(fa, fr, p_target, c_miss, c_fa)
    return float(dcf.min() / min(c_miss * p_target, c_fa * (1 - p_target)))


def operating_points(scores, labels, p_target: float = 0.05):
    """The thresholds of ``compute_eer`` and ``compute_min_dcf``, each
    midway between the score that it takes and the next lower one (a
    threshold equal to a trial's score would leave that trial's side to
    rounding) -> (EER threshold, minDCF threshold)."""
    fa, fr, ranked = _error_rates(scores, labels)
    ranked = np.append(ranked, -np.inf)
    return tuple(float((ranked[i] + ranked[i + 1]) / 2) for i in (
        _eer_index(fa, fr), np.argmin(_dcf(fa, fr, p_target))))
