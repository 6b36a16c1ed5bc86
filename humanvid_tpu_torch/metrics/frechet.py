"""Fréchet distance machinery shared by FID and FVD (numpy float64, SciPy).

The counterpart of ``humanvid_tpu/metrics/frechet.py`` (pytorch-fid's
formulation): activation statistics, then
``||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))`` with ``scipy.linalg.sqrtm``,
retried with ``eps`` on the diagonals where the square root is not finite,
and a raise where it keeps a large imaginary part.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import scipy.linalg


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, d) features -> (mu (d,), sigma (d, d))."""
    features = np.asarray(features, dtype=np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("sqrtm produced significant imaginary component")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def frechet_from_features(feats_a: Iterable[np.ndarray], feats_b: Iterable[np.ndarray]) -> float:
    a = np.concatenate([np.asarray(f) for f in feats_a], axis=0)
    b = np.concatenate([np.asarray(f) for f in feats_b], axis=0)
    return frechet_distance(*activation_statistics(a), *activation_statistics(b))
