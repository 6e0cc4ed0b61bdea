"""Rigid-body dynamics on tensors with explicit leading batch dimensions.

PyTorch counterpart of ``tpu_locoman/rbda.py``: forward kinematics,
frame placements, velocities and Jacobians, RNEA with external frame
forces, the world-frame machinery (ancestry mask, world motion axes and
inertias) and the world-frame variants ``rnea_wf``, ``crba_wf`` and
``ccrba_wf``, the analytic frame-kinematics Jacobians, the chart maps,
CRBA, the nonlinear effects, ABA with its analytic derivatives, the centre
of mass and the centroidal map with its time derivative. The analytic RNEA
derivatives live in ``rnea_derivs.py`` beside their CUDA kernel;
``rnea_ad`` and ``frame_kin_ad`` carry them into ``torch.func`` transforms
as custom forward-mode rules.

Spatial vectors are ordered [linear, angular] as in the JAX package. The
kinematic tree is static, so the recursions are Python loops over links,
each step a batched tensor op over every leading dimension. Both base
charts of the JAX package: the free-flyer (quaternion) base and the
Euler-ZYX base, whose chart velocities map to the local twist through the
6x6 ``_base_jac`` (the recursions work with the local twist).
"""

import torch

from . import lie
from .lie import integrate_q, skew  # noqa: F401  (re-exported)
from .model import GRAVITY  # noqa: F401  (re-exported)
from .model import device_consts
from .solver.chol_base import chol_inv


def mv(M, x):
    """Batched matrix-vector product M (..., a, b) @ x (..., b)."""
    return (M @ x.unsqueeze(-1)).squeeze(-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def motion_act_inv(R, p, m):
    """Express motion m (in A) in frame B, T_AB = (R, p)."""
    Rt = R.transpose(-1, -2)
    w = mv(Rt, m[..., 3:])
    v = mv(Rt, m[..., :3] - cross(p, m[..., 3:]))
    return torch.cat([v, w], dim=-1)


def force_act(R, p, f):
    fl = mv(R, f[..., :3])
    tau = mv(R, f[..., 3:]) + cross(p, fl)
    return torch.cat([fl, tau], dim=-1)


def motion_cross(m1, m2):
    v1, w1 = m1[..., :3], m1[..., 3:]
    v2, w2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w1, v2) + cross(v1, w2), cross(w1, w2)], dim=-1)


def motion_cross_star(m, f):
    v, w = m[..., :3], m[..., 3:]
    fl, tau = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fl), cross(w, tau) + cross(v, fl)], dim=-1)


def inertia_apply(m, c, Ic, mot):
    """h = I * motion for the spatial inertia (mass m, com c, Ic)."""
    v, w = mot[..., :3], mot[..., 3:]
    cw = cross(c, w)
    h_lin = m * v - m * cw
    h_ang = mv(Ic, w) - m * cross(c, cw) + m * cross(c, v)
    return torch.cat([h_lin, h_ang], dim=-1)


def _joint_transforms(model, q):
    """(R_li (..., n-1, 3, 3), p_li (n-1, 3)): placement of each revolute
    joint frame in its parent's frame at the joint angle."""
    T = model.tensors(q.device)
    ang = q[..., model.base_nq:]
    s = torch.sin(ang)[..., None, None]
    c = torch.cos(ang)[..., None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    Rj = eye + s * T["axis_skew"][1:] + (1.0 - c) * T["axis_skew2"][1:]
    return T["R_tree"][1:] @ Rj, T["p_tree"][1:]


# ---------------------------------------------------------------------------
# Base chart. "freeflyer": q_base = [p, quat], v_base = the local twist.
# "euler_zyx": q_base = [p (world), rz ry rx], v_base = [pdot (world),
# Euler rates], a vector space. With R = Rz Ry Rx the local twist is
# [R^T pdot, E(e) edot], E the ZYX rate map to body angular velocity.
# ---------------------------------------------------------------------------

def _euler(model):
    return model.base_type == "euler_zyx"


def _mat3(rows):
    """(..., 3, 3) from three rows of three (...) tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _euler_rate_map(e):
    """(..., 3, 3) E with omega_local = E(e) edot, for e = [rz, ry, rx]."""
    _, ry, rx = e.unbind(-1)
    cy, sy, cx, sx = torch.cos(ry), torch.sin(ry), torch.cos(rx), torch.sin(rx)
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    return _mat3([[-sy, zero, one], [cy * sx, cx, zero], [cy * cx, -sx, zero]])


def _base_R(model, q):
    if _euler(model):
        return lie.euler_zyx_to_matrix(q[..., 3:6])
    return lie.quat_to_matrix(q[..., 3:7])


def _base_vloc(model, q, v):
    """Local spatial twist of the base (..., 6) from the chart velocities."""
    if not _euler(model):
        return v[..., :6]
    R = lie.euler_zyx_to_matrix(q[..., 3:6])
    E = _euler_rate_map(q[..., 3:6])
    return torch.cat([mv(R.transpose(-1, -2), v[..., :3]),
                      mv(E, v[..., 3:6])], -1)


def _base_aloc(model, q, v, a):
    """Derivative of the base's local twist along (qdot = v, vdot = a)."""
    if not _euler(model):
        return a[..., :6]
    R = lie.euler_zyx_to_matrix(q[..., 3:6])
    E = _euler_rate_map(q[..., 3:6])
    _, ry, rx = q[..., 3:6].unbind(-1)
    _, dy, dx = v[..., 3:6].unbind(-1)
    cy, sy, cx, sx = torch.cos(ry), torch.sin(ry), torch.cos(rx), torch.sin(rx)
    zero = torch.zeros_like(cy)
    # dE/dt = dy dE/dry + dx dE/drx (E does not depend on rz)
    dE = _mat3([[-cy * dy, zero, zero],
              [-sy * sx * dy + cy * cx * dx, -sx * dx, zero],
              [-sy * cx * dy - cy * sx * dx, -cx * dx, zero]])
    w = mv(E, v[..., 3:6])
    v_loc = mv(R.transpose(-1, -2), v[..., :3])
    # d/dt (R^T pdot) = R^T pddot - omega x (R^T pdot)
    lin = mv(R.transpose(-1, -2), a[..., :3]) - cross(w, v_loc)
    ang = mv(E, a[..., 3:6]) + mv(dE, v[..., 3:6])
    return torch.cat([lin, ang], -1)


def _base_jac(model, q):
    """(..., 6, 6) J: chart base velocity -> local twist, on the Euler
    base (the free-flyer's is the identity)."""
    R = lie.euler_zyx_to_matrix(q[..., 3:6])
    E = _euler_rate_map(q[..., 3:6])
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R.transpose(-1, -2), Z], -1),
                      torch.cat([Z, E], -1)], -2)


def _chart_T(model, q):
    """(..., nv, nv) block-diag(J, I) on the Euler base: chart velocities
    -> (local twist, joint rates)."""
    nj = model.nj
    J = _base_jac(model, q)
    lead = q.shape[:-1]
    Z = q.new_zeros(lead + (6, nj))
    eye = torch.eye(nj, dtype=q.dtype, device=q.device).expand(lead + (nj, nj))
    return torch.cat([torch.cat([J, Z], -1),
                      torch.cat([Z.transpose(-1, -2), eye], -1)], -2)


def fk(model, q):
    """World placements of every joint frame: R_w (..., n, 3, 3) and
    p_w (..., n, 3)."""
    R_li, p_li = _joint_transforms(model, q)
    R_w = [_base_R(model, q)]
    p_w = [q[..., :3]]
    for i in range(1, model.n_links):
        lam = model.parent[i]
        R_w.append(R_w[lam] @ R_li[..., i - 1, :, :])
        p_w.append(mv(R_w[lam], p_li[i - 1]) + p_w[lam])
    return torch.stack(R_w, dim=-3), torch.stack(p_w, dim=-2)


def fk_vel(model, q, v):
    """FK plus per-joint LOCAL spatial velocities v_loc (..., n, 6)."""
    R_w, p_w = fk(model, q)
    T = model.tensors(q.device)
    R_li, p_li = _joint_transforms(model, q)
    zeros3 = torch.zeros_like(v[..., :3])
    v_loc = [_base_vloc(model, q, v)]
    for i in range(1, model.n_links):
        lam = model.parent[i]
        vi = motion_act_inv(R_li[..., i - 1, :, :], p_li[i - 1], v_loc[lam])
        vJ = torch.cat([zeros3, T["axis"][i] * v[..., 6 + i - 1, None]], -1)
        v_loc.append(vi + vJ)
    return R_w, p_w, torch.stack(v_loc, dim=-2)


def _frame_consts(model, frame_name, device):
    """(parent joint, the frame's placement (R, p) on ``device``)."""
    fr = model.frames[frame_name]
    return fr.parent_joint, device_consts(
        model, ("frame", frame_name), lambda dev: tuple(
            torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (fr.R, fr.p)), device)


def frame_placement(model, frame_name, R_w, p_w):
    j, (fR, fp) = _frame_consts(model, frame_name, R_w.device)
    Rj = R_w[..., j, :, :]
    return Rj @ fR, mv(Rj, fp) + p_w[..., j, :]


def frame_position(model, frame_name, q):
    """World position of a frame (..., 3)."""
    return frame_placement(model, frame_name, *fk(model, q))[1]


def frame_velocity_lwa_from(model, frame_name, R_w, p_w, v_loc):
    j, (fR, fp) = _frame_consts(model, frame_name, R_w.device)
    v_f = motion_act_inv(fR, fp, v_loc[..., j, :])
    R_wf = R_w[..., j, :, :] @ fR
    return torch.cat([mv(R_wf, v_f[..., :3]), mv(R_wf, v_f[..., 3:])], -1)


def frame_velocity_lwa(model, frame_name, q, v):
    """Frame spatial velocity (..., 6) in LOCAL_WORLD_ALIGNED coordinates,
    as pin.getFrameVelocity(..., LOCAL_WORLD_ALIGNED) gives it."""
    return frame_velocity_lwa_from(model, frame_name, *fk_vel(model, q, v))


def frame_velocity_from(model, frame_name, R_w, p_w, v_loc,
                        relative_to_base=False, base_frame="base_link"):
    """Reference-parity frame velocity from precomputed kinematics;
    relative_to_base subtracts the base motion and rotates x/y into the
    base frame (z components stay global)."""
    vel = frame_velocity_lwa_from(model, frame_name, R_w, p_w, v_loc)
    if not relative_to_base:
        return vel
    base_vel = frame_velocity_lwa_from(model, base_frame, R_w, p_w, v_loc)
    _, p_f = frame_placement(model, frame_name, R_w, p_w)
    R_b, p_b = frame_placement(model, base_frame, R_w, p_w)
    correction = cross(base_vel[..., 3:], p_f - p_b)
    rel_lin = vel[..., :3] - base_vel[..., :3] - correction
    rel_ang = vel[..., 3:] - base_vel[..., 3:]
    Rbt = R_b.transpose(-1, -2)
    rel_lin_b = mv(Rbt, rel_lin)
    rel_ang_b = mv(Rbt, rel_ang)
    return torch.cat([rel_lin_b[..., :2], vel[..., 2:3], rel_ang_b[..., :2],
                      vel[..., 5:6]], -1)


def frame_velocity(model, frame_name, q, v, relative_to_base=False,
                   base_frame="base_link"):
    return frame_velocity_from(model, frame_name, *fk_vel(model, q, v),
                               relative_to_base, base_frame)


def external_joint_forces(model, ee_frames, forces_world, R_w):
    """Per-frame world 3-forces (..., 3 * len(ee_frames)) -> {joint index:
    local spatial force (..., 6)} at the frames' parent joints, summed per
    joint; R_w is the list of the joints' world rotations."""
    f_ext = {}
    for idx, fname in enumerate(ee_frames):
        jid, (_, fp) = _frame_consts(model, fname, forces_world.device)
        f_lin = mv(R_w[jid].transpose(-1, -2),
                   forces_world[..., 3 * idx:3 * idx + 3])
        fe = torch.cat([f_lin, cross(fp, f_lin)], -1)
        f_ext[jid] = f_ext[jid] + fe if jid in f_ext else fe
    return f_ext


def rnea(model, q, v, a, ee_frames=(), forces_world=None):
    """Whole-body torques tau(q, v, a, f_ext) (..., nv): the local-frame
    two-pass recursion, with world-frame linear forces applied at the
    given frames. On the Euler base the base rows are J^T times the local
    base wrench (the chart's generalized forces)."""
    T = model.tensors(q.device)
    n = model.n_links
    R_li, p_li = _joint_transforms(model, q)
    zeros3 = torch.zeros_like(v[..., :3])
    R0 = _base_R(model, q)
    g = T["g_spatial"][:3]
    R_w = [R0]
    v_loc = [_base_vloc(model, q, v)]
    a_loc = [torch.cat([mv(R0.transpose(-1, -2), g), zeros3], -1)
             + _base_aloc(model, q, v, a)]
    for i in range(1, n):
        lam = model.parent[i]
        R, p = R_li[..., i - 1, :, :], p_li[i - 1]
        R_w.append(R_w[lam] @ R)
        S = T["axis"][i]
        vJ = torch.cat([zeros3, S * v[..., 6 + i - 1, None]], -1)
        vi = motion_act_inv(R, p, v_loc[lam]) + vJ
        ai = (motion_act_inv(R, p, a_loc[lam])
              + torch.cat([zeros3, S * a[..., 6 + i - 1, None]], -1)
              + motion_cross(vi, vJ))
        v_loc.append(vi)
        a_loc.append(ai)

    f_ext = ({} if forces_world is None
             else external_joint_forces(model, ee_frames, forces_world, R_w))

    f = []
    for i in range(n):
        m, c, Ic = T["mass"][i], T["com"][i], T["inertia"][i]
        fi = inertia_apply(m, c, Ic, a_loc[i]) + motion_cross_star(
            v_loc[i], inertia_apply(m, c, Ic, v_loc[i]))
        if i in f_ext:
            fi = fi - f_ext[i]
        f.append(fi)

    tau_j = [None] * n
    for i in range(n - 1, 0, -1):
        tau_j[i] = (T["axis"][i] * f[i][..., 3:]).sum(-1, keepdim=True)
        lam = model.parent[i]
        f[lam] = f[lam] + force_act(R_li[..., i - 1, :, :], p_li[i - 1], f[i])
    tau_base = f[0]
    if _euler(model):
        tau_base = mv(_base_jac(model, q).transpose(-1, -2), tau_base)
    return torch.cat([tau_base] + tau_j[1:], dim=-1)


# ---------------------------------------------------------------------------
# World-frame machinery (all spatial quantities at the world origin).
# ---------------------------------------------------------------------------

def world_motion_axes(model, R_w, p_w):
    """S_w (..., nv, 6): world-origin spatial axis of every dof."""
    T = model.tensors(R_w.device)
    R0, p0 = R_w[..., 0, :, :], p_w[..., 0, :]
    cols = R0.transpose(-1, -2)  # (..., 3, 3): row k = column k of R0
    zeros = torch.zeros_like(cols)
    base_lin = torch.cat([cols, zeros], -1)
    # columns of the base motion transform [[R, P R], [0, R]], as rows
    base_ang = torch.cat([(lie.skew(p0) @ R0).transpose(-1, -2), cols], -1)
    w = mv(R_w[..., 1:, :, :], T["axis"][1:])
    rev = torch.cat([cross(p_w[..., 1:, :], w), w], -1)
    return torch.cat([base_lin, base_ang, rev], dim=-2)


def _world_kinematics(model, q, v):
    """Shared world-frame data: R_w, p_w, the ancestry mask anc (n, nv),
    S_w (..., nv, 6), the per-dof twists sv, the link twists V (..., n, 6)
    and sdot = v_(j) x s_j (..., nv, 6)."""
    T = model.tensors(q.device)
    R_w, p_w = fk(model, q)
    anc = T["anc"]
    Sw = world_motion_axes(model, R_w, p_w)
    sv = Sw * v[..., None]
    V = torch.einsum("nm,...md->...nd", anc, sv)
    sdot = motion_cross(V[..., T["dof_link"], :], Sw)
    return R_w, p_w, anc, Sw, sv, V, sdot


def rnea_wf(model, q, v, a, ee_frames=(), forces_world=None):
    """Whole-body torques (..., nv) by the world-frame masked sums: link
    twists and accelerations as ancestry-masked sums of the dof axes, body
    forces at the world origin, tau_j = s_j . (subtree force sum).
    Free-flyer base only."""
    T = model.tensors(q.device)
    R_w, p_w, anc, Sw, _, V, sdot = _world_kinematics(model, q, v)
    I_w = world_inertias(model, R_w, p_w)
    sa = Sw * a[..., None] + sdot * v[..., None]
    A = torch.einsum("nm,...md->...nd", anc, sa) + T["g_spatial"]
    Iv = mv(I_w, V)
    f = mv(I_w, A) + motion_cross_star(V, Iv)
    if forces_world is not None and len(ee_frames) > 0:
        ext = [torch.zeros_like(f[..., 0, :]) for _ in range(model.n_links)]
        for idx, fname in enumerate(ee_frames):
            jid, (_, fp) = _frame_consts(model, fname, q.device)
            fw = forces_world[..., 3 * idx:3 * idx + 3]
            p_f = mv(R_w[..., jid, :, :], fp) + p_w[..., jid, :]
            ext[jid] = ext[jid] + torch.cat([fw, cross(p_f, fw)], -1)
        f = f - torch.stack(ext, dim=-2)
    F = torch.einsum("nm,...nd->...md", anc, f)
    return (Sw * F).sum(-1)


def _link_jacobians(model, q):
    """(world inertias (..., n, 6, 6), J (..., n, nv, 6) = anc * S_w, R_w,
    p_w)."""
    R_w, p_w = fk(model, q)
    anc = model.tensors(q.device)["anc"]
    Sw = world_motion_axes(model, R_w, p_w)
    return world_inertias(model, R_w, p_w), anc[:, :, None] * Sw[..., None, :, :], R_w, p_w


def crba_wf(model, q):
    """Mass matrix (..., nv, nv) by the world-frame masked formulation:
    M = sum_i J_i^T I_i^w J_i."""
    I_w, J, _, _ = _link_jacobians(model, q)
    IJ = torch.einsum("...ikl,...ivl->...ikv", I_w, J)
    return torch.einsum("...ivk,...ikw->...vw", J, IJ)


def ccrba_wf(model, q):
    """Centroidal momentum matrix (..., 6, nv) by the world-frame masked
    formulation: A_O = sum_i I_i^w J_i at the world origin, moved to the
    centre of mass."""
    I_w, J, R_w, p_w = _link_jacobians(model, q)
    A_O = torch.einsum("...ikl,...ivl->...kv", I_w, J)
    com = _com_from(model, R_w, p_w)
    A_ang = A_O[..., 3:, :] - lie.skew(com) @ A_O[..., :3, :]
    return torch.cat([A_O[..., :3, :], A_ang], -2)


def _motion_transform(R, p):
    P = lie.skew(p)
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, P @ R], -1), torch.cat([Z, R], -1)], -2)


def _force_transform(R, p):
    P = lie.skew(p)
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, Z], -1), torch.cat([P @ R, R], -1)], -2)


def local_inertias(model, device):
    """(n, 6, 6) spatial inertias in the joint frames, [lin, ang] (made
    once per device)."""
    def build(device):
        T = model.tensors(device)
        m = T["mass"][:, None, None]
        C = lie.skew(T["com"])
        eye = torch.eye(3, device=device)
        top = torch.cat([m * eye, -m * C], -1)
        bot = torch.cat([m * C, T["inertia"] - m * (C @ C)], -1)
        return torch.cat([top, bot], -2)

    return device_consts(model, "local_inertias", build, device)


def world_inertias(model, R_w, p_w):
    """(..., n, 6, 6) world-origin spatial inertias."""
    I_loc = local_inertias(model, R_w.device)
    Rt = R_w.transpose(-1, -2)
    XF = _force_transform(R_w, p_w)
    XM_inv = _motion_transform(Rt, -mv(Rt, p_w))
    return XF @ I_loc @ XM_inv


def frame_jacobian_lwa(model, frame_name, q):
    """LOCAL_WORLD_ALIGNED frame Jacobian J(q) (..., 6, nv) with v_frame =
    J @ v: the Jv_vel of ``frame_kin_jac`` (the JAX package takes it by
    jacfwd of the frame velocity, which is linear in v)."""
    v0 = q.new_zeros(q.shape[:-1] + (model.nv,))
    J = frame_kin_jac(model, (frame_name,), q, v0)["Jv_vel"][..., 0, :, :]
    return J @ _chart_T(model, q) if _euler(model) else J


def nonlinear_effects(model, q, v):
    """Coriolis and gravity torques (..., nv): rnea at zero acceleration."""
    return rnea(model, q, v, torch.zeros_like(v))


# ---------------------------------------------------------------------------
# CRBA, ABA and the centroidal map.
# ---------------------------------------------------------------------------

def _composite_inertias(model, q):
    """Per-link subtree composite spatial inertias in the local joint
    frames (a list of (..., 6, 6)), and the joint transforms R_li
    (..., n-1, 3, 3), p_li (n-1, 3). Shared by crba and ccrba."""
    R_li, p_li = _joint_transforms(model, q)
    I_loc = local_inertias(model, q.device)
    lead = q.shape[:-1]
    Ic = [I_loc[i].expand(lead + (6, 6)) for i in range(model.n_links)]
    for i in range(model.n_links - 1, 0, -1):
        R, p = R_li[..., i - 1, :, :], p_li[i - 1]
        Rt = R.transpose(-1, -2)
        XF = _force_transform(R, p.expand(lead + (3,)))
        XM_inv = _motion_transform(Rt, -mv(Rt, p))
        lam = model.parent[i]
        Ic[lam] = Ic[lam] + XF @ Ic[i] @ XM_inv
    return Ic, R_li, p_li


def crba(model, q):
    """Mass matrix M(q) (..., nv, nv): the composite-rigid-body
    recursion."""
    T = model.tensors(q.device)
    Ic, R_li, p_li = _composite_inertias(model, q)
    M = q.new_zeros(q.shape[:-1] + (model.nv, model.nv))
    M[..., :6, :6] = Ic[0]
    for i in range(1, model.n_links):
        F = mv(Ic[i][..., :, 3:], T["axis"][i])
        col = 6 + i - 1
        M[..., col, col] = (T["axis"][i] * F[..., 3:]).sum(-1)
        j = i
        while True:
            lam = model.parent[j]
            F = force_act(R_li[..., j - 1, :, :], p_li[j - 1], F)
            if lam == 0:
                M[..., :6, col] = F
                M[..., col, :6] = F
                break
            val = (T["axis"][lam] * F[..., 3:]).sum(-1)
            M[..., 6 + lam - 1, col] = val
            M[..., col, 6 + lam - 1] = val
            j = lam
    if _euler(model):
        Tc = _chart_T(model, q)
        M = Tc.transpose(-1, -2) @ M @ Tc
    return M


def _mass_factor(M):
    """Linv (..., nv, nv) with Linv^T Linv = (M + 1e-6 I)^-1: one
    ``solver.chol_base.chol_inv`` over the whole flat batch, so one launch
    of kernel K1 on a CUDA tensor. The jitter is the JAX package's: the
    explicit-inverse solve loses ~cond(M)^2 in f32 near singular
    configurations."""
    nv = M.shape[-1]
    eye = torch.eye(nv, dtype=M.dtype, device=M.device)
    S = (M + 1e-6 * eye).reshape(-1, nv, nv)
    return chol_inv(S, 16, "kernel")[1].reshape(M.shape)


def _aba_solve(model, q, v, tau, ee_frames, forces_world):
    """(a, Linv): M a = tau - rnea(q, v, 0, f) through the factor of M."""
    M = crba(model, q)
    bias = rnea(model, q, v, torch.zeros_like(v), ee_frames, forces_world)
    Linv = _mass_factor(M)
    Lt = Linv.transpose(-1, -2)
    return mv(Lt, mv(Linv, tau - bias)), Linv


def aba(model, q, v, tau, ee_frames=(), forces_world=None):
    """Forward dynamics a = aba(q, v, tau, f_ext) (..., nv): solves
    M a = tau - rnea(q, v, 0, f_ext) with the inverse Cholesky factor of
    M + 1e-6 I."""
    return _aba_solve(model, q, v, tau, ee_frames, forces_world)[0]


def aba_derivatives(model, q, v, tau, ee_frames=(), forces_world=None):
    """(a, da/dq, da/dv, da/dtau, da/df) of ``aba`` (..., nv[, k]), dq the
    local tangent (the chart coordinates on the Euler base), da/df None
    without forces.

    The implicit rule of the JAX package's ``_aba_cjvp_rule``: M(q) a =
    tau - bias(q, v, f) gives da/d(q, v, f) = -M^-1 dtau/d(q, v, f), with
    dtau the RNEA derivatives at (q, v, a, f), and da/dtau = M^-1. One
    factor of M (one launch of kernel K1 on a CUDA tensor) serves the
    solve and M^-1 = Linv^T Linv; one ``rnea_jacobians`` call on the flat
    batch gives every dtau block (one launch of kernel K2 on the
    quaternion base; forward-mode AD over the plain recursion on the Euler
    base, as the JAX package takes it)."""
    a, Linv = _aba_solve(model, q, v, tau, ee_frames, forces_world)
    with_f = forces_world is not None and len(ee_frames) > 0
    dtau_dq, dtau_dv, _, *dtau_df = rnea_jacobians(
        model, q, v, a, ee_frames, forces_world if with_f else None)
    Minv = Linv.transpose(-1, -2) @ Linv

    def solve(d):  # -M^-1 dtau
        return -(Minv @ d)

    return (a, solve(dtau_dq), solve(dtau_dv), Minv,
            solve(dtau_df[0]) if with_f else None)


def _com_from(model, R_w, p_w):
    T = model.tensors(R_w.device)
    pos = mv(R_w, T["com"]) + p_w  # (..., n, 3)
    return (T["mass"][:, None] * pos).sum(-2) / model.total_mass


def center_of_mass(model, q):
    """World centre of mass (..., 3)."""
    return _com_from(model, *fk(model, q))


def ccrba(model, q):
    """Centroidal momentum matrix A(q) (..., 6, nv), h = A v, [lin, ang]
    about the centre of mass in world-aligned axes: the composite-inertia
    recursion."""
    T = model.tensors(q.device)
    Ic, _, _ = _composite_inertias(model, q)
    R_w, p_w = fk(model, q)
    com = _com_from(model, R_w, p_w)
    cols = [_force_transform(R_w[..., 0, :, :], p_w[..., 0, :] - com) @ Ic[0]]
    for i in range(1, model.n_links):
        F = mv(Ic[i][..., :, 3:], T["axis"][i])
        cols.append(force_act(R_w[..., i, :, :], p_w[..., i, :] - com,
                              F)[..., None])
    A = torch.cat(cols, -1)
    return A @ _chart_T(model, q) if _euler(model) else A


def dccrba(model, q, v):
    """Time derivative of the centroidal map along v (..., 6, nv): the
    directional derivative of A through the manifold integrate, by
    forward-mode AD as the JAX package takes it with jax.jvp."""
    _, Adot = torch.func.jvp(
        lambda dq: ccrba(model, model_integrate(model, q, dq)),
        (torch.zeros_like(v),), (v,))
    return Adot


# ---------------------------------------------------------------------------
# Chart maps.
# ---------------------------------------------------------------------------

def model_integrate(model, q, dq):
    """Configuration integrate in the model's base chart."""
    if _euler(model):
        return lie.integrate_q_euler(q, dq)
    return lie.integrate_q(q, dq)


def model_difference(model, q0, q1):
    if _euler(model):
        return lie.difference_q_euler(q0, q1)
    return lie.difference_q(q0, q1)


def coord_to_tangent(q, dq_coords):
    """Map configuration-coordinate tangents (..., nq[, k]) at q to the
    local tangent (..., nv[, k]). A trailing column axis k is allowed when
    dq_coords has one more dimension than q. Quaternion base only."""
    cols = dq_coords.dim() > q.dim()
    if not cols:
        dq_coords = dq_coords.unsqueeze(-1)
    R0 = lie.quat_to_matrix(q[..., 3:7])
    dp_t = R0.transpose(-1, -2) @ dq_coords[..., :3, :]
    qc = lie.quat_conj(q[..., 3:7])[..., None, :]
    dw = 2.0 * lie.quat_mul(qc, dq_coords[..., 3:7, :].transpose(-1, -2))[
        ..., :3].transpose(-1, -2)
    out = torch.cat([dp_t, dw, dq_coords[..., 7:, :]], dim=-2)
    return out if cols else out.squeeze(-1)


def integrate_tangent_map(q0, dq):
    """(..., 6, 6) base block of d(local tangent at q)/d(dq) for
    q = integrate_q(q0, dq): forward-mode AD through the free-flyer
    integrate (cheap algebra, six basis tangents), then coord_to_tangent.
    The joint block of the map is the identity."""
    lead = dq.shape[:-1]
    qf = q0[..., :7].reshape(-1, 7)
    uf = dq[..., :6].reshape(-1, 6)
    nb = uf.shape[0]
    eye = torch.eye(6, dtype=dq.dtype, device=dq.device)
    q_rep = qf.repeat_interleave(6, dim=0)
    u_rep = uf.repeat_interleave(6, dim=0)
    tang = eye.repeat(nb, 1)
    qn, dqn = torch.func.jvp(
        lambda u: lie.freeflyer_integrate(q_rep, u), (u_rep,), (tang,))
    J = dqn.reshape(nb, 6, 7).transpose(-1, -2)  # (nb, 7, 6) coords x basis
    qn = qn.reshape(nb, 6, 7)[:, 0]
    Tm = coord_to_tangent(qn, J)
    return Tm.reshape(lead + (6, 6))


# ---------------------------------------------------------------------------
# Frame kinematics with analytic Jacobians (LOCAL q tangent).
# ---------------------------------------------------------------------------

def frame_kin_jac(model, frame_names, q, v, jacobians=True):
    """Per frame the LWA velocity (6,), world position (3,), rotation
    (3, 3) and their Jacobians wrt the local q tangent and v, stacked over
    frames: vel (..., F, 6), pos (..., F, 3), R (..., F, 3, 3),
    Jq_vel/Jv_vel (..., F, 6, nv), Jq_pos (..., F, 3, nv),
    Jq_R (..., F, 3, 3, nv); the first three only with
    ``jacobians=False``."""
    T = model.tensors(q.device)
    R_w, p_w = fk(model, q)
    anc = T["anc"]
    Sw = world_motion_axes(model, R_w, p_w)
    sv = Sw * v[..., None]
    DM = anc[T["dof_link"]]
    out = {k: [] for k in ("vel", "pos", "R", "Jq_vel", "Jv_vel", "Jq_pos",
                           "Jq_R")}
    S_lin, S_ang = Sw[..., :3], Sw[..., 3:]
    for fname in frame_names:
        R_f, p_f = frame_placement(model, fname, R_w, p_w)
        lf = model.frames[fname].parent_joint
        a_row = anc[lf]
        V = torch.einsum("j,...jd->...d", a_row, sv)
        vel = torch.cat([V[..., :3] + cross(V[..., 3:], p_f), V[..., 3:]], -1)
        out["vel"].append(vel)
        out["pos"].append(p_f)
        out["R"].append(R_f)
        if not jacobians:
            continue
        arm = a_row[:, None] * (S_lin + cross(S_ang, p_f[..., None, :]))
        Jv = torch.cat([arm.transpose(-1, -2),
                        (a_row[:, None] * S_ang).transpose(-1, -2)], -2)
        M = a_row[:, None] * DM
        Vt = torch.einsum("mj,...md->...jd", M, sv)
        dV = torch.cat([cross(S_ang, Vt[..., :3]) + cross(S_lin, Vt[..., 3:]),
                        cross(S_ang, Vt[..., 3:])], -1)
        dpt = (dV[..., :3] + cross(dV[..., 3:], p_f[..., None, :])
               + cross(V[..., None, 3:], arm))
        Jq = torch.cat([dpt.transpose(-1, -2),
                        dV[..., 3:].transpose(-1, -2)], -2)
        Jq_R = torch.einsum("...jab,...bc->...acj",
                            a_row[:, None, None] * lie.skew(S_ang), R_f)
        out["Jq_vel"].append(Jq)
        out["Jv_vel"].append(Jv)
        out["Jq_pos"].append(arm.transpose(-1, -2))
        out["Jq_R"].append(Jq_R)
    return {k: torch.stack(vs, dim=q.dim() - 1) for k, vs in out.items()
            if vs}


# ---------------------------------------------------------------------------
# RNEA and frame kinematics with analytic forward-mode rules.
# ---------------------------------------------------------------------------

def _rnea_jacobians_ad(model, q, v, a, ee_frames, forces_world):
    """dtau/d(q, v, a[, f]) (..., nv, nq | nv | nv | nf) by forward-mode AD
    over the plain recursion, mapped over the flattened leading dims."""
    lead = q.shape[:-1]
    with_f = forces_world is not None
    args = [x.reshape((-1,) + x.shape[len(lead):])
            for x in ((q, v, a, forces_world) if with_f else (q, v, a))]

    def one(q_, v_, a_, f_=None):
        return rnea(model, q_, v_, a_, ee_frames, f_)

    jac = torch.func.vmap(torch.func.jacfwd(one, argnums=tuple(
        range(len(args)))))(*args)
    return [j.reshape(lead + j.shape[1:]) for j in jac]


def rnea_jacobians(model, q, v, a, ee_frames=(), forces_world=None):
    """[dtau/dq, dtau/dv, dtau/da(, dtau/df)] at (q, v, a, f) with leading
    dims (...): dq the local tangent on the quaternion base, from one
    ``rnea_derivs.rnea_derivatives`` call on the flat batch (one launch of
    kernel K2 on a CUDA tensor); the chart coordinates on the Euler base,
    from forward-mode AD over the plain recursion (the JAX package's
    analytic derivatives are for the quaternion base only)."""
    from . import rnea_derivs

    with_f = forces_world is not None and len(ee_frames) > 0
    ee = tuple(ee_frames) if with_f else ()
    fw = forces_world if with_f else None
    if _euler(model):
        return _rnea_jacobians_ad(model, q, v, a, ee, fw)
    lead = q.shape[:-1]
    flat = lambda x: x.reshape((-1,) + x.shape[len(lead):]).contiguous()  # noqa: E731
    args = (model, flat(q), flat(v), flat(a))
    if with_f:
        args += (ee, flat(fw))
    return [d.reshape(lead + d.shape[1:])
            for d in rnea_derivs.rnea_derivatives(*args)]


def rnea_derivatives(model, q, v, a, ee_frames=(), forces_world=None):
    """(dtau/dq, dtau/dv, dtau/da[, dtau/df]) of ``rnea``, analytic, over a
    flat batch: q (B, nq), v and a (B, nv), forces_world (B, 3 * n_frames),
    each output (B, nv, ...). The JAX package's function takes one sample
    and is mapped over the batch; this one takes the batch, and dtau/df is
    left out (not None) without forces. It is ``rnea_derivs.
    rnea_derivatives``: the plain version on CPU tensors, kernel K2 on CUDA
    tensors. Quaternion base only."""
    from . import rnea_derivs

    return rnea_derivs.rnea_derivatives(model, q, v, a, ee_frames,
                                        forces_world)


def _primals(*xs):
    """The primals of a forward-mode rule without torch.func's jvp
    wrappers. Inside the vmap over tangents of a jvp the primals are the
    same for every tangent: unwrapped, they are plain tensors, from which
    the rule computes its derivative tensors once, with torch.func's
    dispatch off (``torch._C._DisableFuncTorch``), on tensors whose storage
    a kernel can read."""
    from torch._C import _functorch as fc

    out = []
    for x in xs:
        while x is not None and fc.is_gradtrackingtensor(x):
            x = fc.get_unwrapped(x)
        out.append(x)
    return out


class _RneaAD(torch.autograd.Function):
    """rnea with the analytic forward-mode rule of the JAX package's
    ``rnea_ad`` custom JVP."""

    generate_vmap_rule = True

    @staticmethod
    def forward(model, q, v, a, ee_frames, forces_world):
        return rnea(model, q, v, a, ee_frames, forces_world)

    @staticmethod
    def setup_context(ctx, inputs, output):
        model, q, v, a, ee_frames, forces_world = inputs
        ctx.model, ctx.ee_frames = model, ee_frames
        ctx.save_for_forward(q, v, a, forces_world)

    @staticmethod
    def jvp(ctx, _model, dq, dv, da, _ee, df):
        q, v, a, fw = _primals(*ctx.saved_tensors)
        with torch._C._DisableFuncTorch():
            D = rnea_jacobians(ctx.model, q, v, a, ctx.ee_frames, fw)
        dtau = torch.zeros_like(v)
        if dq is not None:
            dtau = dtau + mv(D[0], coord_to_tangent(q, dq))
        for Dx, dx in zip(D[1:], (dv, da, df)):
            if dx is not None:
                dtau = dtau + mv(Dx, dx)
        return dtau


def rnea_ad(model, q, v, a, ee_frames, forces_world):
    """``rnea`` whose forward-mode derivative (torch.func.jvp, and jacfwd
    or a vmap over tangents of jvp) comes from one ``rnea_jacobians`` call
    on the primals (one launch of kernel K2 on a CUDA tensor, however
    many tangents), contracted with the tangents after
    ``coord_to_tangent``, as the JAX package's ``rnea_ad``. Quaternion
    base only; first order; no reverse mode."""
    with_f = forces_world is not None and len(ee_frames) > 0
    return _RneaAD.apply(model, q, v, a, tuple(ee_frames) if with_f else (),
                         forces_world if with_f else None)


class _FrameKinAD(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(model, frame_names, q, v):
        jd = frame_kin_jac(model, frame_names, q, v, jacobians=False)
        return jd["vel"], jd["pos"], jd["R"]

    @staticmethod
    def setup_context(ctx, inputs, output):
        model, frame_names, q, v = inputs
        ctx.model, ctx.frame_names = model, frame_names
        ctx.save_for_forward(q, v)

    @staticmethod
    def jvp(ctx, _model, _names, dq, dv):
        q, v = _primals(*ctx.saved_tensors)
        with torch._C._DisableFuncTorch():
            jd = frame_kin_jac(ctx.model, ctx.frame_names, q, v)
        t = (coord_to_tangent(q, dq) if dq is not None
             else q.new_zeros(q.shape[:-1] + (ctx.model.nv,)))
        dvel = torch.einsum("...fij,...j->...fi", jd["Jq_vel"], t)
        if dv is not None:
            dvel = dvel + torch.einsum("...fij,...j->...fi", jd["Jv_vel"], dv)
        dpos = torch.einsum("...fij,...j->...fi", jd["Jq_pos"], t)
        dR = torch.einsum("...fabj,...j->...fab", jd["Jq_R"], t)
        return dvel, dpos, dR


def frame_kin_ad(model, frame_names, q, v):
    """Stacked frame kinematics: LWA velocity (..., F, 6), world position
    (..., F, 3) and rotation (..., F, 3, 3), whose forward-mode derivative
    comes from one ``frame_kin_jac`` call on the primals, as the JAX
    package's ``frame_kin_ad``. Quaternion base only; first order."""
    return _FrameKinAD.apply(model, tuple(frame_names), q, v)
