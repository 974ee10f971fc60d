"""SO(3)/SE(3) primitives on tensors — port of ``g2o_tpu/ops/lie.py``.

Every function works on the *last* axis, so it applies unchanged to a
single pose ``(7,)`` or to a batch ``(E, 7)``, and it is traceable by
``torch.func`` (no in-place writes).  Conventions match the JAX package
and the reference framework:

* SE3 state is ``(tx, ty, tz, qx, qy, qz, qw)``: translation, then a unit
  quaternion in Eigen coefficient order (x, y, z, w).
* The 6-dof error/update vector is the "MQT" parameterisation
  ``[t, q.vec]`` with ``q`` normalized to ``w > 0``.
* The SE3 vertex update is a right multiplication
  ``X <- X * fromVectorMQT(delta)``.

Double-``where`` guards: reverse-mode autodiff SUMS cotangents over both
branches of a ``torch.where``, so a ``sqrt``/``arctan2`` evaluated at 0 in
the unselected branch contributes ``0 * inf = NaN`` to the Jacobian even
though the forward value discards it.  The linearization differentiates
exactly at zero perturbation, so every such argument is where-guarded.
"""

from __future__ import annotations

import torch


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
