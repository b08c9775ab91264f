"""FVD (Fréchet Video Distance, Unterthiner et al. 2018).

A copy of moca_tpu/eval/fvd.py. The reference defers FVD to the
`common_metrics_on_video_quality` git submodule (.gitmodules:1-3), whose
`calculate_fvd` fits Gaussians to I3D features of the two video sets and
reports the Fréchet distance. Here the math is native and the feature
extractor is supplied by the caller: `eval/i3d.py` is the submodule's
InceptionI3d (`i3d_feature_fn(convert_i3d_weights(state_dict))` is the
reference-equivalent `feature_fn`), or any extractor works.

All statistics run in numpy float64: FVD is an offline metric over a few
hundred feature vectors, and the matrix square root is numerically
delicate in float32. The square root of the (non-symmetric) product
Σ1·Σ2 is computed via the standard PSD similarity transform
sqrtm(Σ1·Σ2) ~ sqrtm(A·Σ2·A) with A = sqrtm(Σ1), which needs only
symmetric eigendecompositions.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def _psd_sqrt(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition (clipping the tiny
    negative eigenvalues that finite-sample covariances produce)."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of a feature matrix [N, D] (rowvar=False,
    unbiased — matching scipy/torch Fréchet implementations)."""
    feats = np.asarray(features, dtype=np.float64)
    if feats.ndim != 2:
        raise ValueError(f"features must be [N, D], got {feats.shape}")
    if feats.shape[0] < 2:
        raise ValueError("need ≥2 feature vectors to fit a covariance "
                         f"(got {feats.shape[0]})")
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """d² between N(mu1, Σ1) and N(mu2, Σ2):

        ||μ1−μ2||² + tr(Σ1 + Σ2 − 2·sqrtm(Σ1·Σ2))

    tr(sqrtm(Σ1·Σ2)) is evaluated as Σ√λ_i of the symmetric PSD matrix
    A·Σ2·A (A = sqrtm(Σ1)), which has the same eigenvalues as Σ1·Σ2.
    """
    mu1 = np.asarray(mu1, np.float64).ravel()
    mu2 = np.asarray(mu2, np.float64).ravel()
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    a = _psd_sqrt(sigma1)
    inner = a @ ((sigma2 + sigma2.T) / 2.0) @ a
    vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sum(np.sqrt(np.clip(vals, 0.0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_sqrt)


def fvd_from_features(features_a: np.ndarray,
                      features_b: np.ndarray) -> float:
    """FVD given per-video feature vectors [N, D] for each set."""
    mu_a, sigma_a = gaussian_stats(features_a)
    mu_b, sigma_b = gaussian_stats(features_b)
    return frechet_distance(mu_a, sigma_a, mu_b, sigma_b)


class StreamingFVD:
    """Incremental FVD over paired video streams without holding videos.

    For long sweeps (cli/eval_sweep.py): extracts the [1, D] feature
    row for each (edited, source) pair AS IT ARRIVES and keeps only the
    rows — not the decoded float videos (hundreds of MB/side over a long
    sweep). The submodule's `calculate_fvd` uses one uniform clip length
    per set; a streaming extractor cannot retro-truncate already-extracted
    features, so the length is the MINIMUM over the first `warmup_pairs`
    raw pairs (buffered, bounding memory at `warmup_pairs` videos/side)
    or an explicit `clip_len`. Later pairs shorter than the established
    length are skipped and counted — if a sweep's lengths genuinely vary,
    pass `clip_len` up front. Pairs shorter than `min_frames` (the I3D
    temporal floor) are always skipped.
    """

    def __init__(self, feature_fn: Callable[[np.ndarray], np.ndarray],
                 min_frames: int = 9, warmup_pairs: int = 4,
                 clip_len: Optional[int] = None):
        self.feature_fn = feature_fn
        self.min_frames = min_frames
        self.warmup_pairs = warmup_pairs
        self.clip_len = clip_len
        self.skipped = 0
        self._warmup: list = []  # raw pairs until clip_len establishes
        self._a: list = []
        self._b: list = []

    def _extract(self, video_a, video_b) -> None:
        self._a.append(np.asarray(
            self.feature_fn(np.asarray(video_a[: self.clip_len])[None])))
        self._b.append(np.asarray(
            self.feature_fn(np.asarray(video_b[: self.clip_len])[None])))

    def _establish(self) -> None:
        self.clip_len = min(
            min(len(a), len(b)) for a, b in self._warmup)
        for a, b in self._warmup:
            self._extract(a, b)
        self._warmup.clear()

    def add(self, video_a: np.ndarray, video_b: np.ndarray) -> bool:
        """Add one [T, H, W, C] pair in [0, 1]; False if skipped (shorter
        than `min_frames` or than the established clip length)."""
        n = min(len(video_a), len(video_b))
        if n < self.min_frames:
            self.skipped += 1
            return False
        if self.clip_len is None:
            self._warmup.append((np.asarray(video_a), np.asarray(video_b)))
            if len(self._warmup) >= self.warmup_pairs:
                self._establish()
            return True
        if n < self.clip_len:
            self.skipped += 1
            return False
        self._extract(video_a, video_b)
        return True

    def result(self) -> Optional[float]:
        """FVD(set_a, set_b), or None with < 2 accumulated pairs.
        Flushes a partial warmup buffer first (callable repeatedly)."""
        if self.clip_len is None and len(self._warmup) >= 1:
            self._establish()
        if len(self._a) < 2:
            return None
        return fvd_from_features(np.concatenate(self._a, axis=0),
                                 np.concatenate(self._b, axis=0))


def fvd(videos_a: np.ndarray, videos_b: np.ndarray,
        feature_fn: Callable[[np.ndarray], np.ndarray],
        batch_size: int = 8) -> float:
    """FVD between two video sets [N, T, H, W, C] in [0, 1].

    Output-contract divergence from the submodule (deliberate): the
    submodule's `calculate_fvd` (videogpt method) reports one FVD per
    clip-length prefix from 10 frames up to T; this returns a SINGLE
    full-length number, and accepts T ≥ 9 (the I3D temporal floor)
    rather than the submodule's ≥ 10 loop start. Callers wanting the
    per-prefix curve can loop `fvd(videos_a[:, :t], videos_b[:, :t], …)`.

    `feature_fn` maps a video batch [B, T, H, W, C] → [B, D] — use
    `eval.i3d.i3d_feature_fn(convert_i3d_weights(sd))` for the reference's
    I3D-400 logits features. Batched on the host (`batch_size` videos a
    call; the ragged tail goes as it is, there is no compiled shape to
    keep); features are concatenated before the Gaussian fit.
    """

    def extract(videos):
        videos = np.asarray(videos)
        if videos.ndim != 5:
            raise ValueError(f"videos must be [N,T,H,W,C], got {videos.shape}")
        return np.concatenate([np.asarray(feature_fn(videos[i:i + batch_size]))
                               for i in range(0, videos.shape[0], batch_size)], axis=0)

    return fvd_from_features(extract(videos_a), extract(videos_b))
