"""K2: analytic RNEA derivatives over a flat batch, as a CUDA kernel.

Replaces the TPU kernel ``rnea_derivatives_pallas`` / ``_rnea_derivs_kernel``
in ``tpu_locoman/pallas_rbda.py``. Contract: for a flat batch of
(q, v, a[, forces_world]) it returns dtau/dq (local tangent), dtau/dv,
dtau/da, each (B, nv, nv), and dtau/df (B, nv, 3 * n_frames) — the same as
mapping ``rbda.rnea_derivatives`` of the JAX package over axis 0.

Split of the work, as on the TPU: the cheap O(n*6) forward quantities
(world motion axes S_w, world inertias, link velocities and accelerations,
body forces, force arms) are computed here in plain batched torch; the
O(n*nv*6) derivative pass runs in ``csrc/rnea_derivs.cu``.

What bounds it on an H100: latency and occupancy. At the flagship shape
(B = 512 scenarios x 14 nodes = 7168 elements, nv = 24, n = 19 links) the
pass is about 1 GFLOP of short dependent 6-vector algebra with no large
contraction, far from the tensor cores' regime, and its true input/output
traffic is ~80 MB. The kernel keeps every (link, column) intermediate of
one element in shared memory (~45 KB), so none of the ~10 GB of
(n, nv, 6, B) temporaries that the plain version streams through device
memory are ever written; one CTA per element gives 7168 CTAs to fill the
132 SMs, and threads run over (link, column) pairs. The ancestry
contractions are direct masked sums over the 19 links / 24 dofs (the tree
is passed as a 0/1 ancestry mask and a dof->link map, so one build serves
every robot).

``derivative_pass`` is the kernel's wrapper: it takes the plain version
only for CPU tensors; on a CUDA tensor it launches the kernel or raises.
``rnea_derivatives`` is the forward pass followed by ``derivative_pass``.
"""

import ctypes

import numpy as np
import torch

from . import rbda
from .rbda import GRAVITY, cross, motion_cross, motion_cross_star

#: kernel launches made by ``derivative_pass`` (the CUDA path only)
launches = 0


def forward_quantities(model, q, v, a, ee_frames=(), forces_world=None):
    """World-frame forward pass shared by the kernel and the plain version.

    Returns a dict of (B, ...) float32 tensors: Sw (nv, 6), Iw (n, 6, 6),
    Vl, A, Iv, IA, f (n, 6) with f WITHOUT the external forces, sdot
    (nv, 6), and pf (n_frames, 3) frame positions."""
    T = model.tensors(q.device)
    anc = T["anc"]
    dof_link = model.dof_link()
    R_w, p_w = rbda.fk(model, q)
    Sw = rbda.world_motion_axes(model, R_w, p_w)
    Iw = rbda.world_inertias(model, R_w, p_w)
    sv = Sw * v[..., None]
    Vl = torch.einsum("nm,bmd->bnd", anc, sv)
    sdot = motion_cross(Vl[:, dof_link], Sw)
    g_vec = torch.tensor([0.0, 0.0, GRAVITY, 0.0, 0.0, 0.0],
                         dtype=q.dtype, device=q.device)
    sa = Sw * a[..., None] + sdot * v[..., None]
    A = torch.einsum("nm,bmd->bnd", anc, sa) + g_vec
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
    anc = T["anc"]
    dof_link = model.dof_link()
    DM = anc[dof_link]
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
    if forces_world is not None and len(ee_frames) > 0:
        f = f.clone()
        cols = []
        for idx, fname in enumerate(ee_frames):
            jid = model.frames[fname].parent_joint
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


def _topology(model, ee_frames, device):
    cache = model.tensors(device)
    key = ("_k2_topo", tuple(ee_frames))
    if key not in cache:
        parent = model.parent
        if any(parent[i] >= i for i in range(1, model.n_links)):
            raise ValueError("rnea_derivatives needs parent[i] < i")
        ee_joint = np.array([model.frames[fn].parent_joint for fn in ee_frames]
                            or [0], dtype=np.int32)
        cache[key] = (
            cache["anc"].contiguous(),
            torch.as_tensor(model.dof_link().astype(np.int32), device=device),
            torch.as_tensor(ee_joint, device=device),
        )
    return cache[key]


def _check(x, shape, name):
    if x.dtype != torch.float32 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")


def _launch(model, fq, v, a, ee_frames, forces_world):
    from ._build import load

    global launches
    B, nv, n = v.shape[0], model.nv, model.n_links
    nfr = len(ee_frames)
    anc, dof_link, ee_joint = _topology(model, ee_frames, v.device)
    ins = {k: fq[k].contiguous() for k in ("Sw", "Iw", "sdot", "Vl", "A",
                                           "Iv", "IA", "f", "pf")}
    v, a = v.contiguous(), a.contiguous()
    fw = (forces_world.contiguous() if nfr else v.new_zeros(B, 0))
    shapes = {"Sw": (B, nv, 6), "Iw": (B, n, 6, 6), "sdot": (B, nv, 6),
              "Vl": (B, n, 6), "A": (B, n, 6), "Iv": (B, n, 6),
              "IA": (B, n, 6), "f": (B, n, 6), "pf": (B, nfr, 3)}
    for k, shp in shapes.items():
        _check(ins[k], shp, k)
    _check(v, (B, nv), "v")
    _check(a, (B, nv), "a")
    _check(fw, (B, 3 * nfr), "forces_world")
    dq = torch.empty(B, nv, nv, dtype=torch.float32, device=v.device)
    dv = torch.empty_like(dq)
    da = torch.empty_like(dq)
    df = torch.empty(B, nv, max(3 * nfr, 1), dtype=torch.float32,
                     device=v.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = load().rnea_derivs_launch(
        p(anc), p(dof_link), p(ee_joint),
        p(ins["Sw"]), p(ins["Iw"]), p(v), p(a), p(ins["sdot"]),
        p(ins["Vl"]), p(ins["A"]), p(ins["Iv"]), p(ins["IA"]), p(ins["f"]),
        p(ins["pf"]), p(fw), p(dq), p(dv), p(da), p(df),
        ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(nv), ctypes.c_int(nfr),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rnea_derivs kernel launch failed: CUDA error {rc}")
    launches += 1
    return (dq, dv, da, df) if nfr else (dq, dv, da)


def derivative_pass(model, fq, v, a, ee_frames=(), forces_world=None):
    """The kernel's wrapper: the derivative pass from the forward
    quantities ``fq``. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if not v.is_cuda:
        return derivative_pass_plain(model, fq, v, a, ee_frames, forces_world)
    return _launch(model, fq, v, a, ee_frames, forces_world)


def rnea_derivatives(model, q, v, a, ee_frames=(), forces_world=None):
    """(dtau/dq, dtau/dv, dtau/da[, dtau/df]) over a flat batch (B, ...):
    the forward quantities in plain torch, then ``derivative_pass``."""
    with_f = forces_world is not None and len(ee_frames) > 0
    ee = tuple(ee_frames) if with_f else ()
    fw = forces_world if with_f else None
    fq = forward_quantities(model, q, v, a, ee, fw)
    return derivative_pass(model, fq, v, a, ee, fw)
