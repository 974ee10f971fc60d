"""Port of ``g2o_tpu/utils/metrics.py`` (plain Python, as there).

Trajectory evaluation metrics (ATE / RPE) — the BASELINE.md parity
metrics ("trajectory ATE parity ... manhattanOlson3500, sphere2500").

ATE: align the estimated trajectory to ground truth with the closed-form
Umeyama similarity (or rigid) transform, then RMS the translational
residuals.  RPE: RMS error of relative transforms over a fixed step.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform mapping src -> dst, both (N, d).
    Returns (R, t, s)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(cov.shape[0])
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def _positions(traj):
    traj = np.asarray(traj)
    if traj.shape[1] == 3 and traj.ndim == 2:   # SE2 (x, y, theta)
        return traj[:, :2]
    return traj[:, :3]                           # SE3 (t, q) or points


def ate(estimated, ground_truth, *, align: bool = True,
        with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of aligned positions)."""
    p_est = _positions(estimated)
    p_gt = _positions(ground_truth)
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt, with_scale=with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    d = p_est - p_gt
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def rpe(estimated, ground_truth, *, delta: int = 1) -> float:
    """Relative pose error: RMSE of the per-pair relative-translation
    ERROR VECTOR over ``delta`` steps — ``||trans(P_i^-1 P_{i+d}) −
    trans(Q_i^-1 Q_{i+d})||`` (evo-style; a difference-of-norms would
    report zero for pure direction/rotation drift)."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)

    def rel_trans(traj):
        if traj.ndim == 2 and traj.shape[1] == 3:      # SE2 (x, y, theta)
            th = traj[:-delta, 2]
            d = traj[delta:, :2] - traj[:-delta, :2]
            c, s = np.cos(th), np.sin(th)
            return np.stack([c * d[:, 0] + s * d[:, 1],
                             -s * d[:, 0] + c * d[:, 1]], axis=1)
        if traj.ndim == 2 and traj.shape[1] >= 7:      # SE3 [t, q(xyzw)]
            d = traj[delta:, :3] - traj[:-delta, :3]
            u = -traj[:-delta, 3:6]                    # conjugate vec part
            w = traj[:-delta, 6:7]
            return d + 2.0 * np.cross(u, np.cross(u, d) + w * d)
        return traj[delta:] - traj[:-delta]            # raw points
    d = np.linalg.norm(rel_trans(est) - rel_trans(gt), axis=1)
    return float(np.sqrt((d ** 2).mean()))
