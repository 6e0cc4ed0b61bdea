"""Analytic RNEA derivatives over a flat batch, in plain PyTorch.

For a flat batch of (q, v, a[, forces_world]) it returns dtau/dq (local
tangent), dtau/dv, dtau/da, each (B, nv, nv), and dtau/df
(B, nv, 3 * n_frames): the world-frame forward quantities, then the
derivative pass as masked einsums.
"""

import torch

from . import rbda
from .rbda import cross, motion_cross, motion_cross_star

def forward_quantities(model, q, v, a, ee_frames=(), forces_world=None):
    """World-frame forward pass shared by the kernel and the plain version.

    Returns a dict of (B, ...) float32 tensors: Sw (nv, 6), Iw (n, 6, 6),
    Vl, A, Iv, IA, f (n, 6) with f WITHOUT the external forces, sdot
    (nv, 6), and pf (n_frames, 3) frame positions."""
    T = model.tensors(q.device)
    anc, dof_link = T["anc"], T["dof_link"]
    R_w, p_w = rbda.fk(model, q)
    Sw = rbda.world_motion_axes(model, R_w, p_w)
    Iw = rbda.world_inertias(model, R_w, p_w)
    sv = Sw * v[..., None]
    Vl = torch.einsum("nm,bmd->bnd", anc, sv)
    sdot = motion_cross(Vl[:, dof_link], Sw)
    sa = Sw * a[..., None] + sdot * v[..., None]
    A = torch.einsum("nm,bmd->bnd", anc, sa) + T["g_spatial"]
    Iv = rbda.mv(Iw, Vl)
    IA = rbda.mv(Iw, A)
    f = IA + motion_cross_star(Vl, Iv)
    if forces_world is not None and len(ee_frames) > 0:
        pf = torch.stack([rbda.frame_placement(model, fn, R_w, p_w)[1]
                          for fn in ee_frames], dim=1)
    else:
        pf = q.new_zeros(q.shape[0], 0, 3)
    return {"Sw": Sw, "Iw": Iw, "Vl": Vl, "A": A, "Iv": Iv, "IA": IA,
            "f": f, "sdot": sdot, "pf": pf}


def rnea_derivatives_plain(model, q, v, a, ee_frames=(), forces_world=None):
    """Plain PyTorch version of ``rnea_derivatives`` on any device."""
    fq = forward_quantities(model, q, v, a, ee_frames, forces_world)
    return derivative_pass_plain(model, fq, v, a, ee_frames, forces_world)


def derivative_pass_plain(model, fq, v, a, ee_frames=(), forces_world=None):
    """Plain PyTorch version of the kernel (port of
    ``_rnea_derivatives_flat``, with the batch leading): the analytic
    world-frame derivation of ``rbda.rnea_derivatives`` as masked einsums,
    from the forward quantities ``fq``."""
    T = model.tensors(v.device)
    with_f = forces_world is not None and len(ee_frames) > 0
    ee_joint = ([model.frames[fn].parent_joint for fn in ee_frames]
                if with_f else [])
    return _pass_plain(T["anc"], T["dof_link"], T["DM"], ee_joint, fq, v, a,
                       forces_world if with_f else None)


def _pass_plain(anc, dof_link, DM, ee_joint, fq, v, a, forces_world):
    """The plain pass on the tree's index constants: ``anc`` (n, nv),
    ``dof_link`` (nv,), ``DM`` = anc[dof_link] and the force frames'
    joints ``ee_joint``."""
    AL = anc[None, :, :, None]  # (1, n, nv, 1)
    Sw, Iw, Vl, A = fq["Sw"], fq["Iw"], fq["Vl"], fq["A"]
    Iv, IA, f, sdot = fq["Iv"], fq["IA"], fq["f"], fq["sdot"]
    sv = Sw * v[..., None]

    def I_dot(X):  # (B, n, j, 6) -> I_n X
        return torch.einsum("bnde,bnje->bnjd", Iw, X)

    S_j = Sw[:, None]  # (B, 1, nv, 6)
    # d/da: the CRBA quadratic form
    ISm = torch.einsum("bnde,bme->bnmd", Iw, Sw)
    Z = torch.einsum("nk,bnmd->bkmd", anc, AL * ISm)
    dtau_da = torch.einsum("bkd,bkmd->bkm", Sw, Z)

    # shared: dV_q[i, j] = s_j x sum_m anc[i, m] DM[m, j] sv_m
    Vt = torch.einsum("nm,mj,bmd->bnjd", anc, DM, sv)
    dV_q = motion_cross(S_j, Vt)

    # d/dv
    dV_v = AL * S_j
    dA_v = dV_q + AL * sdot[:, None]
    df_v = (I_dot(dA_v) + motion_cross_star(dV_v, Iv[:, :, None])
            + motion_cross_star(Vl[:, :, None], I_dot(dV_v)))
    dtau_dv = torch.einsum("nk,bkd,bnmd->bkm", anc, Sw, df_v)

    # d/dq (local tangent)
    crossSS = motion_cross(Sw[:, None, :, :], Sw[:, :, None, :])  # s_j x s_m
    dS = DM[None, :, :, None] * crossSS
    dsdot = (motion_cross(dV_q[:, dof_link], Sw[:, :, None])
             + DM[None, :, :, None]
             * motion_cross(Vl[:, dof_link][:, :, None], crossSS))
    dA_q = torch.einsum("nm,bmjd->bnjd", anc,
                        dS * a[:, :, None, None] + dsdot * v[:, :, None, None])
    dIA = AL * (motion_cross_star(S_j, IA[:, :, None])
                - I_dot(motion_cross(S_j, A[:, :, None]))) + I_dot(dA_q)
    dIv = AL * (motion_cross_star(S_j, Iv[:, :, None])
                - I_dot(motion_cross(S_j, Vl[:, :, None]))) + I_dot(dV_q)
    df_q = (dIA + motion_cross_star(dV_q, Iv[:, :, None])
            + motion_cross_star(Vl[:, :, None], dIv))

    dtau_df = None
    if forces_world is not None and len(ee_joint) > 0:
        f = f.clone()
        cols = []
        for idx, jid in enumerate(ee_joint):
            fw = forces_world[:, 3 * idx:3 * idx + 3]
            p_f = fq["pf"][:, idx]
            f[:, jid] = f[:, jid] - torch.cat([fw, cross(p_f, fw)], -1)
            arm = Sw[..., :3] + cross(Sw[..., 3:], p_f[:, None])  # (B, nv, 3)
            dp_f = anc[jid][None, :, None] * arm
            dFx = torch.cat([torch.zeros_like(dp_f),
                             cross(dp_f, fw[:, None])], -1)
            df_q[:, jid] = df_q[:, jid] - dFx
            cols.append(-anc[jid][None, :, None] * arm)
        dtau_df = torch.cat(cols, dim=-1)

    F_dof = torch.einsum("nk,bnd->bkd", anc, f)
    dtau_dq = (torch.einsum("bkjd,bkd->bkj", dS, F_dof)
               + torch.einsum("nk,bkd,bnjd->bkj", anc, Sw, df_q))
    outs = (dtau_dq, dtau_dv, dtau_da)
    return outs + (dtau_df,) if dtau_df is not None else outs


rnea_derivatives = rnea_derivatives_plain
