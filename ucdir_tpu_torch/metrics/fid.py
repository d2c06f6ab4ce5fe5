"""FID / KID / IS math and the feature extractor. Counterpart of
`ucdir_tpu/metrics/fid.py` (reference: clean-fid over 256-px patch
decompositions, the reference's eval1.py:222-250).

The Frechet and MMD math is the JAX package's numpy and scipy code, kept
here as the port's own copy; the pool3 features come from the port's
InceptionV3 (`metrics/inception.py`), on weights the user supplies
(`UCDIR_TPU_INCEPTION_NPZ` or the `weights` argument).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (Heusel et al. 2017)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # no `disp`: SciPy 1.18 removed it, and without it every version returns
    # the root alone
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = feats1.mean(0), np.cov(feats1, rowvar=False)
    mu2, s2 = feats2.mean(0), np.cov(feats2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def kid_from_features(feats1: np.ndarray, feats2: np.ndarray,
                      num_subsets: int = 100, max_subset_size: int = 1000,
                      seed: int = 0) -> float:
    """Unbiased MMD^2 with the cubic polynomial kernel (Binkowski et al.),
    clean-fid's estimator."""
    n = feats1.shape[1]
    m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def patch_decompose(img: np.ndarray, ps: int = 256) -> np.ndarray:
    """HWC -> (n, ps, ps, C) non-overlapping patch grid (eval1.py:236-241)."""
    h, w = img.shape[:2]
    c = img.shape[-1]
    hs, ws = h // ps * ps, w // ps * ps
    img = img[:hs, :ws]
    # explicit channel count: images smaller than ps yield an empty (0,...)
    # patch set, where -1 reshapes are ambiguous
    return img.reshape(hs // ps, ps, ws // ps, ps, c) \
        .swapaxes(1, 2).reshape(-1, ps, ps, c)


def inception_score(probs: np.ndarray, splits: int = 10) -> tuple:
    """IS from softmax class probabilities (N, 1000): exp(mean KL(p(y|x)||p(y)))
    per split (reference eval1.py:74-130, defined but unused in its main)."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


def inception_features(images, weights: Optional[str] = None,
                       batch_size: int = 64, device=None) -> np.ndarray:
    """InceptionV3 pool3 features (N, 2048) of NHWC images through the
    port's Inception (`metrics/inception.py`) on `device`, CUDA unless
    named; requires weights (UCDIR_TPU_INCEPTION_NPZ or a path)."""
    from ucdir_tpu_torch.metrics.inception import make_feature_fn
    return make_feature_fn(weights, batch_size, device)(images)
