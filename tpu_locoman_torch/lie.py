"""Lie-group operations for the floating-base configuration manifold.

PyTorch counterpart of ``tpu_locoman/lie.py``. Same conventions (Pinocchio):
quaternions ``(x, y, z, w)``, free-flyer ``[p (3), quat (4)]`` with the LOCAL
tangent ``[v_lin, omega]``, ``integrate(q, u) = q * exp6(u)`` and
``difference(q0, q1) = log6(q0^-1 q1)``.

Every function takes tensors with any number of leading batch dimensions
(the component axis is last) and is written without data-dependent Python
control flow, so it also runs under ``torch.func`` transforms.
"""

import torch

# Small-angle branch threshold on theta^2 — large in f32 on purpose: the
# exact expressions cancel catastrophically near zero, the 2-term Taylor
# branches are accurate to ~3e-7 relative at theta^2 = 1e-2.
_EPS = 1e-2


def _dot(a, b):
    return (a * b).sum(-1)


def quat_mul(q1, q2):
    """Hamilton product q1 * q2, both (..., 4) in (x, y, z, w) order."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q):
    """(..., 3, 3) rotation R with world_v = R @ body_v."""
    x, y, z, w = q.unbind(-1)
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    rows = [
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_rotate(q, v):
    return (quat_to_matrix(q) @ v.unsqueeze(-1)).squeeze(-1)


def _safe(theta2, exact_fn, taylor):
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(small, taylor, exact_fn(theta2_safe))


def _sinc(theta2):
    """sin(t)/t with t = sqrt(theta2)."""
    return _safe(theta2, lambda t2: torch.sin(torch.sqrt(t2)) / torch.sqrt(t2),
                 1.0 - theta2 / 6.0)


def _cosc(theta2):
    """(1 - cos(t)) / t^2."""
    return _safe(theta2, lambda t2: (1.0 - torch.cos(torch.sqrt(t2))) / t2,
                 0.5 - theta2 / 24.0)


def _sincc(theta2):
    """(t - sin(t)) / t^3."""
    return _safe(
        theta2,
        lambda t2: (torch.sqrt(t2) - torch.sin(torch.sqrt(t2)))
        / (t2 * torch.sqrt(t2)),
        1.0 / 6.0 - theta2 / 120.0)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp_quat(omega):
    theta2 = _dot(omega, omega)
    half_sinc = _safe(
        theta2, lambda t2: torch.sin(0.5 * torch.sqrt(t2)) / torch.sqrt(t2),
        0.5 - theta2 / 48.0)
    w = _safe(theta2, lambda t2: torch.cos(0.5 * torch.sqrt(t2)),
              1.0 - theta2 / 8.0)
    return torch.cat([half_sinc[..., None] * omega, w[..., None]], dim=-1)


def quat_log(q):
    """Log map of a unit quaternion to a rotation vector (Pinocchio log3)."""
    w = q[..., 3]
    sign = torch.where(w < 0.0, -torch.ones_like(w), torch.ones_like(w))
    xyz = q[..., :3] * sign[..., None]
    w = w * sign
    s2 = _dot(xyz, xyz)
    s = torch.sqrt(torch.clamp(s2, min=1e-30))
    half_theta = torch.atan2(s, w)
    small = s2 < _EPS
    scale = torch.where(
        small, 2.0 + s2 / 3.0,
        2.0 * half_theta / torch.where(small, torch.ones_like(s), s))
    return scale[..., None] * xyz


def se3_exp(u):
    """exp6 of u = [v, omega] (..., 6) -> (p (..., 3), quat (..., 4))."""
    v, omega = u[..., :3], u[..., 3:]
    theta2 = _dot(omega, omega)
    W = skew(omega)
    V = (_eye3(u) + _cosc(theta2)[..., None, None] * W
         + _sincc(theta2)[..., None, None] * (W @ W))
    p = (V @ v.unsqueeze(-1)).squeeze(-1)
    return p, so3_exp_quat(omega)


def se3_log(p, quat):
    """log6 of an SE(3) element -> (..., 6) motion vector [v, omega]."""
    omega = quat_log(quat)
    theta2 = _dot(omega, omega)
    W = skew(omega)
    coeff = _safe(
        theta2, lambda t2: (1.0 / t2) * (1.0 - _sinc(t2) / (2.0 * _cosc(t2))),
        1.0 / 12.0 + theta2 / 720.0)
    Vinv = _eye3(p) - 0.5 * W + coeff[..., None, None] * (W @ W)
    v = (Vinv @ p.unsqueeze(-1)).squeeze(-1)
    return torch.cat([v, omega], dim=-1)


def freeflyer_integrate(q_ff, u):
    p, quat = q_ff[..., :3], q_ff[..., 3:7]
    dp, dquat = se3_exp(u)
    p_next = p + quat_rotate(quat, dp)
    quat_next = quat_normalize(quat_mul(quat, dquat))
    return torch.cat([p_next, quat_next], dim=-1)


def freeflyer_difference(q0, q1):
    p0, quat0 = q0[..., :3], q0[..., 3:7]
    p1, quat1 = q1[..., :3], q1[..., 3:7]
    dq = quat_mul(quat_conj(quat0), quat1)
    dp = quat_rotate(quat_conj(quat0), p1 - p0)
    return se3_log(dp, dq)


def integrate_q(q, dq):
    """q (..., 7+nj), dq (..., 6+nj) -> q_next (..., 7+nj)."""
    ff = freeflyer_integrate(q[..., :7], dq[..., :6])
    return torch.cat([ff, q[..., 7:] + dq[..., 6:]], dim=-1)


def difference_q(q0, q1):
    """Tangent dq with integrate_q(q0, dq) == q1."""
    ff = freeflyer_difference(q0[..., :7], q1[..., :7])
    return torch.cat([ff, q1[..., 7:] - q0[..., 7:]], dim=-1)


# ---------------------------------------------------------------------------
# Euler-ZYX base chart (use_quaternion=False): q_base = [p (world),
# rz ry rx], a vector space, so integrate and difference are additions.
# ---------------------------------------------------------------------------

def euler_zyx_to_matrix(e):
    """(..., 3) -> (..., 3, 3): R = Rz(e0) @ Ry(e1) @ Rx(e2)."""
    cz, sz = torch.cos(e[..., 0]), torch.sin(e[..., 0])
    cy, sy = torch.cos(e[..., 1]), torch.sin(e[..., 1])
    cx, sx = torch.cos(e[..., 2]), torch.sin(e[..., 2])
    one, zero = torch.ones_like(cz), torch.zeros_like(cz)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    return Rz @ Ry @ Rx


def matrix_to_euler_zyx(R):
    """Inverse of euler_zyx_to_matrix (gimbal-safe for |pitch| < pi/2)."""
    ry = torch.asin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    rz = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    rx = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([rz, ry, rx], dim=-1)


def quat_to_euler_zyx(q):
    return matrix_to_euler_zyx(quat_to_matrix(q))


def integrate_q_euler(q, dq):
    """Vector-space base: plain addition on [p, euler, joints]."""
    return q + dq


def difference_q_euler(q0, q1):
    return q1 - q0
