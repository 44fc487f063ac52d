"""Trajectory alignment and absolute trajectory error (numpy).

Counterpart of ``slam_robot_tpu/utils/dump.py``'s ``align_umeyama`` and
``ate_aligned``, with one deliberate difference: the reflection fix. The
JAX package's ``np.sign(det)`` is 0 for a rank-deficient covariance and
then yields a projection instead of a rotation; here the correction is -1
exactly when det(U) det(V) < 0 and +1 otherwise (Umeyama 1991, eq. 39).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, true: np.ndarray, with_scale: bool = True):
    """Closed-form Sim(3) (or SE(3)) fit mapping ``est`` onto ``true``.
    Returns ``(s, R, t)`` with ``aligned = s * est @ R.T + t``. Fewer than
    3 points or zero spread give the identity."""
    n = min(len(est), len(true))
    est = np.asarray(est[:n], np.float64)
    true = np.asarray(true[:n], np.float64)
    if n < 3:
        return 1.0, np.eye(3), np.zeros(3)
    mu_e = est.mean(0)
    mu_t = true.mean(0)
    ec = est - mu_e
    tc = true - mu_t
    var_e = float((ec * ec).sum()) / n
    if var_e < 1e-12:
        return 1.0, np.eye(3), mu_t - mu_e
    cov = tc.T @ ec / n                      # Sigma_xy with x = true, y = est
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S)) / var_e if with_scale else 1.0
    t = mu_t - s * (R @ mu_e)
    return s, R, t


def ate_aligned(est: np.ndarray, true: np.ndarray, with_scale: bool = True) -> float:
    """Mean Euclidean position error after an Umeyama Sim(3) (or SE(3)) fit."""
    n = min(len(est), len(true))
    s, R, t = align_umeyama(est, true, with_scale=with_scale)
    a = s * (np.asarray(est[:n], np.float64) @ R.T) + t
    d = a - np.asarray(true[:n], np.float64)
    return float(np.sqrt((d * d).sum(axis=1)).mean())
