"""Map dumps, trajectories and trajectory errors (numpy on the host).

Counterpart of ``slam_robot_tpu/utils/dump.py``. ``dump_map`` writes the
reference's /tmp/z gnuplot format (main.cpp:47-73): even-camera frame
positions, a blank line, odd-camera frame positions, a blank line, then the
slam-usable point positions (norm < 4000) as isolated pairs; its bytes equal
the JAX package's for the same state. ``trajectory`` and ``ate`` (raw RMSE,
no alignment) are as there.

``align_umeyama`` and ``ate_aligned`` differ from the JAX package's in one
deliberate way: the reflection fix. The JAX package's ``np.sign(det)`` is
0 for a rank-deficient covariance and then yields a projection instead of
a rotation; here the correction is -1 exactly when det(U) det(V) < 0 and
+1 otherwise (Umeyama 1991, eq. 39).
"""

from __future__ import annotations

import numpy as np

from slam_robot_tpu_torch.models import localmap as lm


def dump_map(state: lm.MapState, path: str) -> None:
    """Write ``state``'s frames and usable points to ``path``."""
    n_frames = int(state.n_frames)
    trans = state.frame_trans[:n_frames].cpu().numpy()
    usable = (lm.slam_usable(state.point_flags) & state.point_mask).cpu().numpy()
    pos = state.point_position().cpu().numpy()
    with open(path, "w") as out:
        for parity in (0, 1):
            for fid in range(n_frames):
                if (fid & 1) != parity:
                    continue
                p = trans[fid]
                out.write(f"{p[0]:f}  {p[1]:f}  {p[2]:f}\n")
            out.write("\n")
        for i in range(int(state.n_points)):
            if not usable[i]:
                continue
            if np.linalg.norm(pos[i]) > 4000:
                continue
            out.write(f"{pos[i,0]:f} {pos[i,1]:f} {pos[i,2]:f}\n\n")


def trajectory(state: lm.MapState) -> np.ndarray:
    """[N,3] frame positions (for ATE comparisons)."""
    return state.frame_trans[: int(state.n_frames)].cpu().numpy()


def ate(traj_a: np.ndarray, traj_b: np.ndarray) -> float:
    """Absolute trajectory error: RMSE of positions, no alignment (both
    trajectories are already anchored by Normalize)."""
    n = min(len(traj_a), len(traj_b))
    d = traj_a[:n] - traj_b[:n]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def reflection_sign(U: np.ndarray, Vt: np.ndarray) -> float:
    """The last diagonal entry that makes ``U diag(1, 1, d) Vt`` (or its
    transpose) a rotation: -1 exactly when det(U) det(Vt) < 0, else +1."""
    return -1.0 if np.linalg.det(U) * np.linalg.det(Vt) < 0 else 1.0


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
    S[2, 2] = reflection_sign(U, Vt)
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
