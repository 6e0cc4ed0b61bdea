"""Rigid-body dynamics on tensors with explicit leading batch dimensions.

PyTorch counterpart of the main-path subset of ``tpu_locoman/rbda.py``:
forward kinematics, frame velocities, RNEA with external frame forces,
the world-frame machinery (ancestry mask, world motion axes and
inertias), the analytic frame-kinematics Jacobians and the chart maps.
The analytic RNEA derivatives live in ``rnea_derivs.py`` beside their
CUDA kernel.

Spatial vectors are ordered [linear, angular] as in the JAX package. The
kinematic tree is static, so the recursions are Python loops over links,
each step a batched tensor op over every leading dimension. Free-flyer
(quaternion) base only; the Euler-ZYX chart waits for a later slice.
"""

import torch

from . import lie
from .model import GRAVITY  # noqa: F401  (re-exported)


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


def fk(model, q):
    """World placements of every joint frame: R_w (..., n, 3, 3) and
    p_w (..., n, 3)."""
    R_li, p_li = _joint_transforms(model, q)
    R_w = [lie.quat_to_matrix(q[..., 3:7])]
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
    v_loc = [v[..., :6]]
    for i in range(1, model.n_links):
        lam = model.parent[i]
        vi = motion_act_inv(R_li[..., i - 1, :, :], p_li[i - 1], v_loc[lam])
        vJ = torch.cat([zeros3, T["axis"][i] * v[..., 6 + i - 1, None]], -1)
        v_loc.append(vi + vJ)
    return R_w, p_w, torch.stack(v_loc, dim=-2)


def _frame_consts(model, frame_name, device):
    fr = model.frames[frame_name]
    key = ("_frame", frame_name)
    cache = model.tensors(device)
    if key not in cache:
        cache[key] = (torch.as_tensor(fr.R, dtype=torch.float32, device=device),
                      torch.as_tensor(fr.p, dtype=torch.float32, device=device))
    return fr.parent_joint, cache[key]


def frame_placement(model, frame_name, R_w, p_w):
    j, (fR, fp) = _frame_consts(model, frame_name, R_w.device)
    Rj = R_w[..., j, :, :]
    return Rj @ fR, mv(Rj, fp) + p_w[..., j, :]


def frame_velocity_lwa_from(model, frame_name, R_w, p_w, v_loc):
    j, (fR, fp) = _frame_consts(model, frame_name, R_w.device)
    v_f = motion_act_inv(fR, fp, v_loc[..., j, :])
    R_wf = R_w[..., j, :, :] @ fR
    return torch.cat([mv(R_wf, v_f[..., :3]), mv(R_wf, v_f[..., 3:])], -1)


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


def rnea(model, q, v, a, ee_frames=(), forces_world=None):
    """Whole-body torques tau(q, v, a, f_ext) (..., nv): the local-frame
    two-pass recursion, with world-frame linear forces applied at the
    given frames."""
    T = model.tensors(q.device)
    n = model.n_links
    R_li, p_li = _joint_transforms(model, q)
    zeros3 = torch.zeros_like(v[..., :3])
    R0 = lie.quat_to_matrix(q[..., 3:7])
    g = T["g_spatial"][:3]
    R_w = [R0]
    v_loc = [v[..., :6]]
    a_loc = [torch.cat([mv(R0.transpose(-1, -2), g), zeros3], -1)
             + a[..., :6]]
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

    f_ext = {}
    if forces_world is not None:
        for idx, fname in enumerate(ee_frames):
            jid, (_, fp) = _frame_consts(model, fname, q.device)
            f_lin = mv(R_w[jid].transpose(-1, -2),
                       forces_world[..., 3 * idx:3 * idx + 3])
            fe = torch.cat([f_lin, cross(fp, f_lin)], -1)
            f_ext[jid] = f_ext[jid] + fe if jid in f_ext else fe

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
    return torch.cat([f[0]] + tau_j[1:], dim=-1)


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


def _motion_transform(R, p):
    P = lie.skew(p)
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, P @ R], -1), torch.cat([Z, R], -1)], -2)


def _force_transform(R, p):
    P = lie.skew(p)
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, Z], -1), torch.cat([P @ R, R], -1)], -2)


def local_inertias(model, device):
    """(n, 6, 6) spatial inertias in the joint frames, [lin, ang]."""
    T = model.tensors(device)
    key = "_I_loc"
    if key not in T:
        m = T["mass"][:, None, None]
        C = lie.skew(T["com"])
        eye = torch.eye(3, device=device)
        top = torch.cat([m * eye, -m * C], -1)
        bot = torch.cat([m * C, T["inertia"] - m * (C @ C)], -1)
        T[key] = torch.cat([top, bot], -2)
    return T[key]


def world_inertias(model, R_w, p_w):
    """(..., n, 6, 6) world-origin spatial inertias."""
    I_loc = local_inertias(model, R_w.device)
    Rt = R_w.transpose(-1, -2)
    XF = _force_transform(R_w, p_w)
    XM_inv = _motion_transform(Rt, -mv(Rt, p_w))
    return XF @ I_loc @ XM_inv


# ---------------------------------------------------------------------------
# Chart maps.
# ---------------------------------------------------------------------------

def model_integrate(model, q, dq):
    return lie.integrate_q(q, dq)


def model_difference(model, q0, q1):
    return lie.difference_q(q0, q1)


def coord_to_tangent(q, dq_coords):
    """Map configuration-coordinate tangents (..., nq[, k]) at q to the
    local tangent (..., nv[, k]). A trailing column axis k is allowed when
    dq_coords has one more dimension than q."""
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

def frame_kin_jac(model, frame_names, q, v):
    """Per frame the LWA velocity (6,), world position (3,), rotation
    (3, 3) and their Jacobians wrt the local q tangent and v, stacked over
    frames: vel (..., F, 6), pos (..., F, 3), R (..., F, 3, 3),
    Jq_vel/Jv_vel (..., F, 6, nv), Jq_pos (..., F, 3, nv),
    Jq_R (..., F, 3, 3, nv)."""
    T = model.tensors(q.device)
    R_w, p_w = fk(model, q)
    anc = T["anc"]
    Sw = world_motion_axes(model, R_w, p_w)
    sv = Sw * v[..., None]
    DM = anc[model.dof_link()]
    out = {k: [] for k in ("vel", "pos", "R", "Jq_vel", "Jv_vel", "Jq_pos",
                           "Jq_R")}
    S_lin, S_ang = Sw[..., :3], Sw[..., 3:]
    for fname in frame_names:
        R_f, p_f = frame_placement(model, fname, R_w, p_w)
        lf = model.frames[fname].parent_joint
        a_row = anc[lf]
        V = torch.einsum("j,...jd->...d", a_row, sv)
        vel = torch.cat([V[..., :3] + cross(V[..., 3:], p_f), V[..., 3:]], -1)
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
        out["vel"].append(vel)
        out["pos"].append(p_f)
        out["R"].append(R_f)
        out["Jq_vel"].append(Jq)
        out["Jv_vel"].append(Jv)
        out["Jq_pos"].append(arm.transpose(-1, -2))
        out["Jq_R"].append(Jq_R)
    return {k: torch.stack(vs, dim=q.dim() - 1) for k, vs in out.items()}
