"""SE(2), SO(3)/SE(3) and Sim(3) primitives on tensors — port of
``g2o_tpu/ops/lie.py``.

Every function works on the *last* axis, so it applies unchanged to a
single pose ``(7,)`` or to a batch ``(E, 7)``, and it is traceable by
``torch.func`` (no in-place writes).  Conventions match the JAX package
and the reference framework:

* SE2 state is ``(x, y, theta)``; composition is the planar rigid-body
  rule and every angle is wrapped to ``[-pi, pi)`` by the floor form of
  :func:`normalize_angle` (its ``floor`` has a zero derivative, so the
  wrap stays out of the Jacobians).
* SE3 state is ``(tx, ty, tz, qx, qy, qz, qw)``: translation, then a unit
  quaternion in Eigen coefficient order (x, y, z, w).
* The 6-dof error/update vector is the "MQT" parameterisation
  ``[t, q.vec]`` with ``q`` normalized to ``w > 0``.
* The SE3 vertex update is a right multiplication
  ``X <- X * fromVectorMQT(delta)``.
* Sim3 state is ``(tx, ty, tz, qx, qy, qz, qw, s)``; its tangent is
  ``[omega, upsilon, sigma]`` (``g2o/types/sim3/sim3.h``).

Double-``where`` guards: reverse-mode autodiff SUMS cotangents over both
branches of a ``torch.where``, so a ``sqrt``/``arctan2`` evaluated at 0 in
the unselected branch contributes ``0 * inf = NaN`` to the Jacobian even
though the forward value discards it.  The linearization differentiates
exactly at zero perturbation, so every such argument is where-guarded.
"""

from __future__ import annotations

import math

import torch

_PI = math.pi


# --------------------------------------------------------------------------- #
# scalars / SO(2)
# --------------------------------------------------------------------------- #

def normalize_angle(theta):
    """Wrap angle(s) to [-pi, pi)."""
    return theta - 2.0 * _PI * torch.floor((theta + _PI) / (2.0 * _PI))


# --------------------------------------------------------------------------- #
# SE(2) — state vector (x, y, theta)
# --------------------------------------------------------------------------- #

def se2_compose(a, b):
    """a * b for SE2 vectors (..., 3)."""
    xa, ya, ta = a[..., 0], a[..., 1], a[..., 2]
    xb, yb, tb = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(ta), torch.sin(ta)
    return torch.stack([xa + c * xb - s * yb, ya + s * xb + c * yb,
                        normalize_angle(ta + tb)], dim=-1)


def se2_inverse(a):
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack([-(c * x + s * y), -(-s * x + c * y),
                        normalize_angle(-t)], dim=-1)


def se2_act(a, p):
    """Apply SE2 transform a (..., 3) to 2D point p (..., 2)."""
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    px, py = p[..., 0], p[..., 1]
    return torch.stack([x + c * px - s * py, y + s * px + c * py], dim=-1)


def se2_oplus(x, delta):
    """Reference VertexSE2 update: additive with angle renormalisation
    (``g2o/types/slam2d/vertex_se2.h:51-58``)."""
    return torch.stack([x[..., 0] + delta[..., 0], x[..., 1] + delta[..., 1],
                        normalize_angle(x[..., 2] + delta[..., 2])], dim=-1)


# --------------------------------------------------------------------------- #
# quaternions — coefficient order (x, y, z, w)
# --------------------------------------------------------------------------- #

def quat_identity(shape=(), dtype=torch.float64, device=None):
    q = torch.zeros(shape + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_positive(q):
    """Flip sign so the scalar part is >= 0 (reference ``internal::normalized``)."""
    return torch.where(q[..., 3:4] < 0.0, -q, q)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(R):
    """Rotation matrix -> quaternion (x, y, z, w), w >= 0.

    Branchless Shepperd-style construction.  The sqrt ARGUMENTS of the
    unselected branches are where-guarded to 1.0 (double-where, see the
    module docstring)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    cond_w = tr > 0.0
    cond_x = (m00 >= m11) & (m00 >= m22)
    cond_y = m11 >= m22
    sel_w = cond_w
    sel_x = ~cond_w & cond_x
    sel_y = ~cond_w & ~cond_x & cond_y
    sel_z = ~cond_w & ~cond_x & ~cond_y

    def _sel_sqrt(x, sel):
        return torch.sqrt(torch.where(sel, torch.clamp_min(x, 1e-24), 1.0))

    def _cand(vals, s):
        return torch.stack(vals, dim=-1) / torch.clamp_min(4.0 * s, 1e-12)[..., None]

    qw_w = _sel_sqrt(1.0 + tr, sel_w) / 2.0
    q_w = _cand([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw_w * qw_w], qw_w)
    qx_x = _sel_sqrt(1.0 + m00 - m11 - m22, sel_x) / 2.0
    q_x = _cand([4.0 * qx_x * qx_x, m01 + m10, m02 + m20, m21 - m12], qx_x)
    qy_y = _sel_sqrt(1.0 - m00 + m11 - m22, sel_y) / 2.0
    q_y = _cand([m01 + m10, 4.0 * qy_y * qy_y, m12 + m21, m02 - m20], qy_y)
    qz_z = _sel_sqrt(1.0 - m00 - m11 + m22, sel_z) / 2.0
    q_z = _cand([m02 + m20, m12 + m21, 4.0 * qz_z * qz_z, m10 - m01], qz_z)
    q = torch.where(
        cond_w[..., None], q_w,
        torch.where(cond_x[..., None], q_x,
                    torch.where(cond_y[..., None], q_y, q_z)))
    return quat_positive(quat_normalize(q))


def quat_to_compact(q):
    """(x,y,z,w) -> (x,y,z) of the w>0-normalized quaternion
    (reference ``toCompactQuaternion``)."""
    return quat_positive(quat_normalize(q))[..., :3]


def quat_from_compact(v):
    """(x,y,z) -> full quaternion with w = sqrt(1 - |v|^2); identity when
    |v|^2 > 1 (reference ``fromCompactQuaternion``)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    bad = n2 > 1.0
    w = torch.sqrt(torch.where(bad, 1.0, torch.clamp_min(1.0 - n2, 1e-24)))
    q = torch.cat([v, w], dim=-1)
    ident = torch.cat([torch.zeros_like(v), torch.ones_like(w)], dim=-1)
    return torch.where(bad, ident, q)


def so3_exp(omega):
    """Axis-angle (..., 3) -> quaternion (x, y, z, w), Taylor-safe at 0
    including derivatives."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([omega * k, w], dim=-1)


def so3_log(q):
    """Quaternion -> axis-angle (..., 3), Taylor-safe at identity including
    reverse-mode derivatives (the norm's argument is where-guarded)."""
    q = quat_positive(quat_normalize(q))
    vec = q[..., :3]
    w = q[..., 3:4]
    n2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = n2 < 1e-18
    n = torch.sqrt(torch.where(small, 1.0, n2))
    angle = 2.0 * torch.atan2(torch.where(small, 0.0, n), w)
    k = torch.where(small, 2.0 / torch.clamp_min(w, 1e-12), angle / n)
    return vec * k


def so3_hat(omega):
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    x, y, z = omega[..., 0], omega[..., 1], omega[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# --------------------------------------------------------------------------- #
# SE(3) — state vector (tx, ty, tz, qx, qy, qz, qw)
# --------------------------------------------------------------------------- #

def se3_identity(shape=(), dtype=torch.float64, device=None):
    x = torch.zeros(shape + (7,), dtype=dtype, device=device)
    x[..., 6] = 1.0
    return x


def se3_t(x):
    return x[..., :3]


def se3_q(x):
    return x[..., 3:7]


def se3_make(t, q):
    return torch.cat([t, q], dim=-1)


def se3_compose(a, b):
    """a * b."""
    return se3_make(
        se3_t(a) + quat_rotate(se3_q(a), se3_t(b)),
        quat_mul(se3_q(a), se3_q(b)),
    )


def se3_inverse(a):
    qi = quat_conj(se3_q(a))
    return se3_make(-quat_rotate(qi, se3_t(a)), qi)


def se3_act(a, p):
    return se3_t(a) + quat_rotate(se3_q(a), p)


def se3_normalize(x):
    return se3_make(se3_t(x), quat_normalize(se3_q(x)))


def se3_to_mqt(x):
    """SE3 -> 6-vector [t, compact-quat] (reference ``toVectorMQT``)."""
    return torch.cat([se3_t(x), quat_to_compact(se3_q(x))], dim=-1)


def se3_from_mqt(v):
    """6-vector [t, compact-quat] -> SE3 (reference ``fromVectorMQT``)."""
    return se3_make(v[..., :3], quat_from_compact(v[..., 3:6]))


def se3_oplus(x, delta):
    """Reference VertexSE3 update: X <- X * fromVectorMQT(delta), with
    quaternion renormalisation standing in for re-orthogonalisation."""
    return se3_normalize(se3_compose(x, se3_from_mqt(delta)))


# --- SE3Quat exp/log ------------------------------------------------------- #

def _so3_left_jacobian(omega):
    """V matrix of the SE3 exponential: V = I + B*hat + C*hat^2."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-10
    safe = torch.sqrt(torch.where(small, 1.0, theta2))
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    O = so3_hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(O.shape)
    return eye + B[..., None, None] * O + C[..., None, None] * (O @ O)


def _so3_left_jacobian_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-10
    safe = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * safe
    cot = half * torch.cos(half) / torch.sin(torch.where(small, 1.0, half))
    A = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot) / (safe * safe))
    O = so3_hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(O.shape)
    return eye - 0.5 * O + A[..., None, None] * (O @ O)


def se3quat_exp(xi):
    """SE3Quat::exp — xi = [omega(3), upsilon(3)] -> SE3 state vector."""
    omega, upsilon = xi[..., :3], xi[..., 3:6]
    q = so3_exp(omega)
    V = _so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, upsilon)
    return se3_make(t, q)


def se3quat_log(x):
    """Inverse of :func:`se3quat_exp` -> [omega, upsilon]."""
    omega = so3_log(se3_q(x))
    Vinv = _so3_left_jacobian_inv(omega)
    upsilon = torch.einsum("...ij,...j->...i", Vinv, se3_t(x))
    return torch.cat([omega, upsilon], dim=-1)


# --------------------------------------------------------------------------- #
# Sim(3) — state vector (tx, ty, tz, qx, qy, qz, qw, s)
# --------------------------------------------------------------------------- #

def sim3_identity(shape=(), dtype=torch.float64, device=None):
    x = torch.zeros(shape + (8,), dtype=dtype, device=device)
    x[..., 6] = 1.0
    x[..., 7] = 1.0
    return x


def sim3_t(x):
    return x[..., :3]


def sim3_q(x):
    return x[..., 3:7]


def sim3_s(x):
    return x[..., 7]


def sim3_make(t, q, s):
    return torch.cat([t, q, s[..., None]], dim=-1)


def sim3_compose(a, b):
    """a * b: (R_a s_a, t_a) ∘ (R_b s_b, t_b)."""
    s = sim3_s(a) * sim3_s(b)
    q = quat_mul(sim3_q(a), sim3_q(b))
    t = sim3_s(a)[..., None] * quat_rotate(sim3_q(a), sim3_t(b)) + sim3_t(a)
    return sim3_make(t, q, s)


def sim3_inverse(a):
    qi = quat_conj(sim3_q(a))
    si = 1.0 / sim3_s(a)
    t = -si[..., None] * quat_rotate(qi, sim3_t(a))
    return sim3_make(t, qi, si)


def sim3_act(a, p):
    return sim3_s(a)[..., None] * quat_rotate(sim3_q(a), p) + sim3_t(a)


def _sim3_W(omega, sigma, s):
    """W = integral_0^1 e^{u sigma} R(u theta) du, the Sim3 translation
    mixing matrix (reference ``g2o/types/sim3/sim3.h:75-160``), as
    A*I + B*hat + C*hat^2 with hat = hat(omega) unnormalized:

        A = (e^s - 1)/s
        B = (e^s(s sin t - t cos t) + t) / (t (s^2 + t^2))
        C = (A - (e^s(s cos t + t sin t) - s)/(s^2 + t^2)) / t^2

    with the limits B -> (e^s(s-1)+1)/s^2, C -> (e^s(s^2/2-s+1)-1)/s^3 as
    theta -> 0, and B -> 1/2, C -> 1/6 as both go to 0.  The small
    branches keep their sigma-linear terms, so d/dsigma inside them is
    exact to first order (a constant-only branch zeroes the
    scale-translation coupling near convergence).  Every small-value guard
    is a double ``where``."""
    theta2 = torch.sum(omega * omega, dim=-1)
    O = so3_hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(O.shape)

    eps = 1e-7
    sigma_small = torch.abs(sigma) < eps
    theta_small = theta2 < eps * eps
    safe_sigma = torch.where(sigma_small, 1.0, sigma)
    safe_theta = torch.sqrt(torch.where(theta_small, 1.0, theta2))

    # case 1: sigma ~ 0, theta ~ 0 (theta-quadratic terms omitted: their
    # omega-derivatives carry a factor omega and vanish in the branch)
    A1 = 1.0 + 0.5 * sigma
    B1 = 0.5 + sigma / 3.0
    C1 = 1.0 / 6.0 + sigma / 8.0
    # case 2: sigma ~ 0, theta != 0 (the SE3 V matrix at sigma = 0)
    st_, ct_ = torch.sin(safe_theta), torch.cos(safe_theta)
    A2 = 1.0 + 0.5 * sigma
    B2 = (1.0 - ct_) / (safe_theta * safe_theta) \
        + sigma * (st_ - safe_theta * ct_) / (safe_theta ** 3)
    C2 = (safe_theta - st_) / (safe_theta ** 3) \
        + sigma * (0.5 - (safe_theta * st_ + ct_ - 1.0)
                   / (safe_theta * safe_theta)) / (safe_theta * safe_theta)
    # case 3: sigma != 0, theta ~ 0
    A3 = (s - 1.0) / safe_sigma
    B3 = (s * (safe_sigma - 1.0) + 1.0) / (safe_sigma * safe_sigma)
    C3 = (s * (0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0)
          - 1.0) / (safe_sigma ** 3)
    # case 4: general
    a_ = s * torch.sin(safe_theta)
    b_ = s * torch.cos(safe_theta)
    c_ = safe_theta * safe_theta + safe_sigma * safe_sigma
    A4 = (s - 1.0) / safe_sigma
    B4 = (a_ * safe_sigma + (1.0 - b_) * safe_theta) / (safe_theta * c_)
    C4 = (A4 - ((b_ - 1.0) * safe_sigma + a_ * safe_theta) / c_) / (
        safe_theta * safe_theta)

    def pick(x1, x2, x3, x4):
        return torch.where(sigma_small, torch.where(theta_small, x1, x2),
                           torch.where(theta_small, x3, x4))

    A = pick(A1, A2, A3, A4)
    B = pick(B1, B2, B3, B4)
    C = pick(C1, C2, C3, C4)
    return (A[..., None, None] * eye + B[..., None, None] * O
            + C[..., None, None] * (O @ O))


def _inv3(M):
    """Closed-form 3x3 inverse (adjugate over determinant), so that the
    Jacobians through it are the JAX package's."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b * B_ + c * C_
    adj = torch.stack([
        torch.stack([A_, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C_, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def sim3_exp(xi):
    """Sim3 exponential, xi = [omega(3), upsilon(3), sigma] -> state vector
    (the reference ``Sim3(const Vector7&)``, ``g2o/types/sim3/sim3.h:75-160``:
    rotation, translation, log-scale)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    q = so3_exp(omega)
    W = _sim3_W(omega, sigma, s)
    t = torch.einsum("...ij,...j->...i", W, upsilon)
    return sim3_make(t, q, s)


def sim3_log(x):
    """Inverse of :func:`sim3_exp` (the same W, the closed-form inverse)."""
    omega = so3_log(sim3_q(x))
    sigma = torch.log(sim3_s(x))
    s = sim3_s(x)
    W = _sim3_W(omega, sigma, s)
    upsilon = torch.einsum("...ij,...j->...i", _inv3(W), sim3_t(x))
    return torch.cat([omega, upsilon, sigma[..., None]], dim=-1)
