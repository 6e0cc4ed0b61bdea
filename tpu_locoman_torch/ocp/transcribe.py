"""Stagewise NLP transcription over a batch of scenarios.

PyTorch counterpart of ``tpu_locoman/ocp/transcribe.py``. The iterate is
Z (B, N+1, s) with stage blocks s_i = [dx_i (ndx), u_i (nu)]; constraint
values are g (B, N, m) with the JAX package's row layout (dynamics, swing
zero-force, contact xy velocity, blended z velocity, ext force, arm EE
velocity, friction normal, cone, then the q/v/tau box rows).

Two linearizations, as in the JAX package:

- the split path (every formulation at its default arguments) computes
  the same Jacobian rows as the JAX package's split path. The dynamics
  rows come from the formulation (``dyn_linearize``): the analytic RNEA
  derivatives (kernel K2, ``rbda.rnea_jacobians``) and ABA's implicit
  derivatives (kernels K1 and K2, ``rbda.aba_derivatives``) evaluated once
  on the flat B*N batch, or reverse-mode AD over plain torch for the
  centroidal rows. The frame-velocity rows come from the analytic
  frame-kinematics Jacobians. Both are composed here with the
  configuration-chart map of ``integrate``; no autograd runs through RNEA
  or ABA. On the Euler-ZYX base, as in the JAX package, the RNEA
  derivatives and the frame-velocity rows come from AD over the plain
  recursions instead (the analytic derivatives are for the quaternion
  base);
- the whole-stage path (the variants, whose dynamics rows are nonlinear
  throughout or read dx_next) takes (G, B[, C]) by forward mode over the
  whole stage: ``torch.func.jvp`` of ``stage_residual`` vmapped over the
  tangent basis, each basis vector broadcast over every node (the nodes
  are independent), as the JAX package takes them by jacfwd. RNEA enters
  through ``rbda.rnea_ad``, whose forward-mode rule launches K2 once per
  linearize, on the primals.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import rbda, trace
from ..dynamics.formulations import SharedParams, StageParams
from ..gait import get_spline_vel_z
from ..model import device_consts

_INF = 1e9


class ObjectiveData(NamedTuple):
    """Diagonal quadratic objective, each (B, N+1, s)."""

    P_base: torch.Tensor
    z_des: torch.Tensor
    P_w: torch.Tensor
    z_w: torch.Tensor


def _node(x, lead):
    """Broadcast a per-scenario tensor (B, ...) against node-level leading
    dims lead = (..., B, N)."""
    shape = (1,) * (len(lead) - 2) + x.shape[:1] + (1,) + x.shape[1:]
    return x.reshape(shape).expand(lead + x.shape[1:])


class Transcription:
    def __init__(self, form, nodes, mu=0.7):
        self.form = form
        self.nodes = nodes
        self.mu = mu
        self.ndx = form.ndx
        self.nu = form.nu
        self.s = self.ndx + self.nu
        self.has_ext = form.ext_force_frame is not None
        self.has_arm = form.arm_ee_frame is not None
        self.has_tau = getattr(form, "tau_idx", None) is not None
        nf4, nj = form.n_feet, form.nj

        self.n_dyn = form.n_dyn
        self.n_eq = (self.n_dyn + 3 * nf4 + 2 * nf4 + nf4
                     + (3 if self.has_ext else 0) + (3 if self.has_arm else 0))
        self.n_ineq = 2 * nf4 + nj + nj + (nj if self.has_tau else 0)
        self.m = self.n_eq + self.n_ineq
        self.n_box = 2 * nj + (nj if self.has_tau else 0)
        self.m_dense = self.m - self.n_box
        if form.v_in_u:  # dx = [dh (6), dq (nv)], v = u[:nv_opt]
            off = self.ndx + (6 if form.include_base else 0)
            slots = [12 + j for j in range(nj)] + [off + j for j in range(nj)]
        else:  # dx = [dq (nv), dv (nv)]
            slots = ([6 + j for j in range(nj)]
                     + [form.nv + 6 + j for j in range(nj)])
        if self.has_tau:
            slots += [self.ndx + form.tau_idx + j for j in range(nj)]
        self.box_slots = np.asarray(slots, dtype=np.int64)

        # the dx_next block C: the constant propagation pattern (the QP
        # then streams slices of it) when the formulation has one
        self.C_pat = form.dx_next_pattern()
        self.c_eye_rows = None
        if self.C_pat is not None:
            k = form.n_prop_rows
            expect = np.zeros_like(self.C_pat)
            expect[:k, :k] = np.eye(k, dtype=self.C_pat.dtype)
            if (self.C_pat.shape[0] <= self.m_dense
                    and np.array_equal(self.C_pat, expect)):
                self.c_eye_rows = int(k)

        dyn_nl = form.dyn_nl_idx()
        self.split_ok = dyn_nl is not None and self.C_pat is not None
        if not self.split_ok:
            return
        n_dyn = self.n_dyn
        off_sw = n_dyn
        off_xy = off_sw + 3 * nf4
        off_z = off_xy + 2 * nf4
        off_ext = off_z + nf4
        off_arm = off_ext + (3 if self.has_ext else 0)
        off_fric = off_arm + (3 if self.has_arm else 0)
        off_cone = off_fric + nf4
        assert off_cone + nf4 == self.m_dense
        self.dyn_nl_rows = dyn_nl
        vel_rows = list(range(off_xy, off_z + nf4))
        if self.has_arm:
            vel_rows += list(range(off_arm, off_arm + 3))
        self.vel_rows = np.asarray(vel_rows, dtype=np.int64)
        self.cone_rows = np.arange(off_cone, off_cone + nf4)
        f0 = self.ndx + form.f_idx
        self.sw_rows = np.arange(off_sw, off_sw + 3 * nf4)
        self.sw_cols = f0 + np.arange(3 * nf4)
        if self.has_ext:
            self.ext_rows = np.arange(off_ext, off_ext + 3)
            self.ext_cols = f0 + 3 * nf4 + np.arange(3)
        self.fric_rows = np.arange(off_fric, off_fric + nf4)
        self.fric_cols = f0 + 3 * np.arange(nf4) + 2
        self.cone_cols = f0 + np.arange(3 * nf4)

    _INDEX = ("dyn_nl_rows", "vel_rows", "cone_rows", "cone_cols", "sw_rows",
              "sw_cols", "ext_rows", "ext_cols", "fric_rows", "fric_cols")

    def consts(self, device):
        """The box slots ("box_slots"), the split path's row and column
        indices (under their attribute names, "cone_feet", the foot of each
        cone column, and "one", the ext force rows' entry), the C pattern
        ("C_pat") and the box limits ("q_min", "q_max", "v_max", "tau_max",
        "inf") as tensors on ``device``, made once per device: a tick
        copies nothing from the host."""
        return device_consts(self, "consts", self._make_consts, device)

    def _make_consts(self, device):
        robot = self.form.robot

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def index(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        c = {"box_slots": index(self.box_slots),
             "q_min": f32(robot.joint_pos_min),
             "q_max": f32(robot.joint_pos_max),
             "v_max": f32(robot.joint_vel_max),
             "inf": torch.tensor(_INF, device=device)}
        if self.has_tau:
            c["tau_max"] = f32(robot.joint_torque_max)
        if self.C_pat is not None:
            c["C_pat"] = torch.as_tensor(self.C_pat, device=device)
        if self.split_ok:
            c.update((k, index(getattr(self, k))) for k in self._INDEX
                     if hasattr(self, k))
            c["cone_feet"] = index(np.repeat(np.arange(self.form.n_feet), 3))
            # an index assignment copies a Python number from the host
            c["one"] = torch.ones((), device=device)
        return c

    # ------------------------------------------------------------------
    def _swing_vel(self, swing, shared, lead):
        sp_ = _node(shared.swing_period, lead)[..., None]
        sh = _node(shared.swing_height, lead)[..., None]
        lim = _node(shared.swing_vel_limits, lead)
        return get_spline_vel_z(swing, swing_period=sp_, h_max=sh,
                                v_liftoff=lim[..., 0:1],
                                v_touchdown=lim[..., 1:2])

    def stage_residual(self, dx, u, dx_next, sp: StageParams,
                       shared: SharedParams):
        """All constraint rows, (..., B, N, m), for node tensors with leading
        dims (..., B, N)."""
        form = self.form
        lead = dx.shape[:-1]
        nf = form.n_feet
        x_init = _node(shared.x_init, lead)
        dx = dx * sp.node0_mask[..., None]
        d = form.decode(x_init, dx, u)
        rows = [form.dyn_residual(x_init, dx, u, dx_next, sp, d)]
        q, v, forces = d["q"], d["v"], d["forces"]
        kin = rbda.fk_vel(form.model, q, v)
        c = sp.contact[..., :nf]
        sm = sp.state_mask[..., None]
        f = forces[..., :3 * nf].reshape(lead + (nf, 3))
        vel = torch.stack([rbda.frame_velocity_from(form.model, fn, *kin)
                           for fn in form.foot_frames], dim=-2)  # (..., nf, 6)
        vzd = self._swing_vel(sp.swing[..., :nf], shared, lead)
        rows.append(((1.0 - c)[..., None] * f).reshape(lead + (3 * nf,)))
        rows.append((sm[..., None] * c[..., None] * vel[..., :2]).reshape(
            lead + (2 * nf,)))
        vz = vel[..., 2]
        rows.append(sm * (c * vz + (1.0 - c) * (vz - vzd)))
        if self.has_ext:
            rows.append(forces[..., 3 * nf:] - _node(shared.ext_force_des, lead))
        if self.has_arm:
            va = rbda.frame_velocity_from(
                form.model, form.arm_ee_frame, *kin, relative_to_base=True,
                base_frame=form.base_frame)
            rows.append(sm * (va[..., :3] - _node(shared.arm_vel_des, lead)))
        rows.append(c * f[..., 2])
        rows.append(c * (self.mu**2 * f[..., 2] ** 2 - f[..., 0] ** 2
                         - f[..., 1] ** 2))
        rows.append(q[..., form.model.base_nq:])
        rows.append(v[..., 6:])
        if self.has_tau:
            rows.append(d["tau_j"])
        return torch.cat(rows, dim=-1)

    def stage_bounds(self, sp: StageParams, shared: SharedParams):
        """(l, u), each (B, N, m)."""
        form = self.form
        nf4, nj = form.n_feet, form.nj
        lead = sp.dt.shape
        lim = self.consts(sp.dt.device)
        zeros = sp.dt.new_zeros(lead + (self.n_eq + 2 * nf4,))
        l = [zeros]
        u = [torch.cat([sp.dt.new_zeros(lead + (self.n_eq,)),
                        sp.dt.new_full(lead + (2 * nf4,), _INF)], -1)]
        big = lim["inf"]
        smq = (sp.state_mask * sp.node0_mask)[..., None] > 0
        l.append(torch.where(smq, lim["q_min"], -big))
        u.append(torch.where(smq, lim["q_max"], big))
        # an input v (centroidal_vel) is live at node 0 as well
        smv = (sp.state_mask * (1.0 if form.v_in_u else sp.node0_mask))[
            ..., None] > 0
        vmax = lim["v_max"]
        l.append(torch.where(smv, -vmax, -big))
        u.append(torch.where(smv, vmax, big))
        if self.has_tau:
            tmax = lim["tau_max"]
            tm = sp.tau_mask[..., None] > 0
            l.append(torch.where(tm, -tmax, -big))
            u.append(torch.where(tm, tmax, big))
        return torch.cat(l, -1), torch.cat(u, -1)

    bounds = stage_bounds

    def evaluate(self, Z, stage_params, shared):
        """g (..., B, N, m) at Z (..., B, N+1, s)."""
        DX = Z[..., :self.ndx]
        return self.stage_residual(DX[..., :-1, :], Z[..., :-1, self.ndx:],
                                   DX[..., 1:, :], stage_params, shared)

    # -- split linearization ---------------------------------------------
    def _lin_jacobian(self, sp):
        nf = self.form.n_feet
        c = sp.contact[..., :nf]
        lead = sp.dt.shape
        ix = self.consts(sp.dt.device)
        J = sp.dt.new_zeros(lead + (self.m_dense, self.s))
        J[..., :self.n_dyn, :] = self.form.dyn_lin_jacobian(sp)
        J[..., ix["sw_rows"], ix["sw_cols"]] = torch.repeat_interleave(
            1.0 - c, 3, dim=-1)
        if self.has_ext:
            J[..., ix["ext_rows"], ix["ext_cols"]] = ix["one"]
        J[..., ix["fric_rows"], ix["fric_cols"]] = c
        return J

    def _cone_jac(self, u, sp):
        form = self.form
        nf = form.n_feet
        f = u[..., form.f_idx:form.f_idx + 3 * nf].reshape(u.shape[:-1]
                                                          + (nf, 3))
        c = sp.contact[..., :nf]
        vals = torch.stack([-2.0 * f[..., 0], -2.0 * f[..., 1],
                            2.0 * self.mu**2 * f[..., 2]], dim=-1) * c[..., None]
        J = u.new_zeros(u.shape[:-1] + (nf, self.s))
        ix = self.consts(u.device)
        J[..., ix["cone_feet"], ix["cone_cols"]] = vals.reshape(
            u.shape[:-1] + (3 * nf,))
        return J

    @trace.traced("ocp.linearize")
    def linearize(self, Z, stage_params, shared):
        """(g (B, N, m), G (B, N, m_dense, ndx), Bm (B, N, m_dense, nu),
        C (B, N, m_dense, ndx)) at Z (B, N+1, s)."""
        if self.split_ok:
            return self._linearize_split(Z, stage_params, shared)
        return self._linearize_whole(Z, stage_params, shared)

    def _linearize_whole(self, Z, sp, shared):
        """The whole stage's Jacobian by forward mode: one jvp of
        ``stage_residual`` per column of (dx, u[, dx_next]), vmapped over
        the columns, each tangent the same basis vector at every node.
        With a C pattern, C is that constant and dx_next no tangent."""
        ndx, nu, md = self.ndx, self.nu, self.m_dense
        DX = Z[..., :ndx]
        dx, dxn, u = DX[:, :-1], DX[:, 1:], Z[:, :-1, ndx:]
        with_c = self.C_pat is None
        prim = (dx, u, dxn) if with_c else (dx, u)

        def stage(*x):
            return self.stage_residual(x[0], x[1], x[2] if with_c else dxn,
                                       sp, shared)

        K = sum(p.shape[-1] for p in prim)
        eye = torch.eye(K, dtype=Z.dtype, device=Z.device)
        basis, o = [], 0
        for p in prim:
            w = p.shape[-1]
            basis.append(eye[:, o:o + w].reshape(
                (K,) + (1,) * (p.dim() - 1) + (w,)).expand((K,) + p.shape))
            o += w
        g, J = torch.func.vmap(
            lambda *t: torch.func.jvp(stage, prim, t),
            out_dims=(None, 0))(*basis)
        J = J[..., :md].movedim(0, -1)  # (B, N, m_dense, K)
        if with_c:
            C = J[..., ndx + nu:]
        else:
            C_full = Z.new_zeros(md, ndx)
            C_full[:self.n_dyn] = self.consts(Z.device)["C_pat"]
            C = C_full.expand(dx.shape[:-1] + C_full.shape)
        return g, J[..., :ndx], J[..., ndx:ndx + nu], C

    def _vel_rows_ad(self, x_init, dx, u, sp):
        """The frame-velocity rows' values (unblended z) and their
        (..., n_vel, s) Jacobian by reverse-mode AD over the plain
        kinematics: the Euler-base split path, as the JAX package takes
        it."""
        form = self.form
        model = form.model
        nf, nq = form.n_feet, form.nq
        n0 = sp.node0_mask[..., None]
        sm = sp.state_mask[..., None]
        smc = sm * sp.contact[..., :nf]

        def rows(dx_, u_):
            x = form.integrate(x_init, dx_ * n0)
            if form.v_in_u:
                q, v = x[..., 6:], u_[..., :form.nv]
            else:
                q, v = x[..., :nq], x[..., nq:]
            kin = rbda.fk_vel(model, q, v)
            vel = torch.stack([rbda.frame_velocity_from(model, fn, *kin)
                               for fn in form.foot_frames], dim=-2)
            out = [(smc[..., None] * vel[..., :2]).flatten(-2),
                   sm * vel[..., 2]]
            if self.has_arm:
                va = rbda.frame_velocity_from(
                    model, form.arm_ee_frame, *kin, relative_to_base=True,
                    base_frame=form.base_frame)
                out.append(sm * va[..., :3])
            return torch.cat(out, -1)

        vb0, pull = torch.func.vjp(rows, dx, u)
        n = vb0.shape[-1]
        basis = torch.eye(n, dtype=dx.dtype, device=dx.device).reshape(
            (n,) + (1,) * (vb0.dim() - 1) + (n,)).expand((n,) + vb0.shape)
        gdx, gu = torch.func.vmap(pull)(basis)
        return vb0, torch.cat([gdx, gu], -1).movedim(0, -2)

    def _vel_rows_analytic(self, q, v, sp, to_dx):
        """The frame-velocity rows' values (unblended z) and their
        (..., n_vel, s) Jacobian from the analytic frame kinematics
        (quaternion base), composed with the chart map ``to_dx``."""
        form = self.form
        model = form.model
        nv, nf = form.nv, form.n_feet
        lead = q.shape[:-1]
        n0 = sp.node0_mask[..., None]
        sm = sp.state_mask[..., None]
        n0r = n0[..., None]
        dqo = form.dq_off
        frames = tuple(form.foot_frames)
        if self.has_arm:
            frames = frames + (form.arm_ee_frame, form.base_frame)
        fk = rbda.frame_kin_jac(model, frames, q, v)
        vel, Jq, Jv = fk["vel"], to_dx(fk["Jq_vel"]), fk["Jv_vel"]
        c = sp.contact[..., :nf]
        smc = (sm * c)[..., None]
        vals = [(smc * vel[..., :nf, :2]).reshape(lead + (2 * nf,)),
                sm * vel[..., :nf, 2]]
        Jq_rows = [(smc[..., None] * Jq[..., :nf, :2, :]).reshape(
            lead + (2 * nf, nv)), sm[..., None] * Jq[..., :nf, 2, :]]
        Jv_rows = [(smc[..., None] * Jv[..., :nf, :2, :]).reshape(
            lead + (2 * nf, nv)), sm[..., None] * Jv[..., :nf, 2, :]]
        if self.has_arm:
            ia, ib = nf, nf + 1
            va, vb = vel[..., ia, :], vel[..., ib, :]
            rel_pos = fk["pos"][..., ia, :] - fk["pos"][..., ib, :]
            rel_lin = va[..., :3] - vb[..., :3] - rbda.cross(vb[..., 3:],
                                                             rel_pos)
            Rbt = fk["R"][..., ib, :, :].transpose(-1, -2)
            rel_lin_b = rbda.mv(Rbt, rel_lin)

            def d_rel_lin(Ja, Jb, dpos):  # (..., 6, nv) -> (..., 3, nv)
                out = Ja[..., :3, :] - Jb[..., :3, :] - rbda.cross(
                    Jb[..., 3:, :].transpose(-1, -2),
                    rel_pos[..., None, :]).transpose(-1, -2)
                if dpos is not None:
                    out = out - rbda.cross(
                        vb[..., None, 3:], dpos.transpose(-1, -2)
                    ).transpose(-1, -2)
                return out

            dpos = to_dx(fk["Jq_pos"][..., ia, :, :] - fk["Jq_pos"][..., ib, :, :])
            dRb = fk["Jq_R"][..., ib, :, :, :]  # (..., 3, 3, nv) local tangent
            dRb_rel = torch.einsum("...acj,...a->...cj", dRb, rel_lin)
            Jq_rel = Rbt @ d_rel_lin(Jq[..., ia, :, :], Jq[..., ib, :, :], dpos) \
                + to_dx(dRb_rel)
            Jv_rel = Rbt @ d_rel_lin(Jv[..., ia, :, :], Jv[..., ib, :, :], None)
            vals.append(sm * torch.cat([rel_lin_b[..., :2], va[..., 2:3]], -1))
            Jq_rows.append(sm[..., None] * torch.cat(
                [Jq_rel[..., :2, :], Jq[..., ia, 2:3, :]], -2))
            Jv_rows.append(sm[..., None] * torch.cat(
                [Jv_rel[..., :2, :], Jv[..., ia, 2:3, :]], -2))
        vb0 = torch.cat(vals, -1)
        n_vel = vb0.shape[-1]
        # v is dx_v (masked at node 0) or, for centroidal_vel, u[:nv]
        Jvel = q.new_zeros(lead + (n_vel, self.s))
        Jvel[..., dqo:dqo + nv] = torch.cat(Jq_rows, -2) * n0r
        v0 = self.ndx if form.v_in_u else nv
        Jv_all = torch.cat(Jv_rows, -2)
        Jvel[..., v0:v0 + nv] = Jv_all if form.v_in_u else Jv_all * n0r
        return vb0, Jvel

    def _linearize_split(self, Z, stage_params, shared):
        form = self.form
        model = form.model
        sp = stage_params
        nv, nq, ndx = form.nv, form.nq, self.ndx
        nf = form.n_feet
        DX = Z[..., :ndx]
        dx, dxn = DX[:, :-1], DX[:, 1:]
        u = Z[:, :-1, ndx:]
        lead = dx.shape[:-1]
        n0 = sp.node0_mask[..., None]
        sm = sp.state_mask[..., None]
        x_init = _node(shared.x_init, lead)
        dxm = dx * n0
        qo, dqo = form.q_off, form.dq_off
        euler = model.base_type == "euler_zyx"
        if euler:  # a vector-space chart: the derivatives are in dx_q
            def to_dx(J):
                return J
        else:
            # chart map: d(local tangent at q) / d(dx_q); joint block = I
            Tb = rbda.integrate_tangent_map(x_init[..., qo:qo + nq],
                                            dxm[..., dqo:dqo + nv])

            def to_dx(J):  # (B, N, ..., r, nv) local tangent -> dx_q cols
                T_ = Tb.reshape(lead + (1,) * (J.dim() - 4) + (6, 6))
                return torch.cat([J[..., :6] @ T_, J[..., 6:]], -1)

        # ---- dynamics rows: the formulation's values and Jacobian ---------
        d, dyn0, Jd = form.dyn_linearize(x_init, dx, u, sp, to_dx)
        q, v, forces, tau_j = d["q"], d["v"], d["forces"], d["tau_j"]
        ix = self.consts(Z.device)
        C_pat = ix["C_pat"]
        g_dyn = dyn0 + dxn @ C_pat.T

        # ---- frame-velocity rows ------------------------------------------
        c = sp.contact[..., :nf]
        if euler:
            vb0, Jvel = self._vel_rows_ad(x_init, dx, u, sp)
        else:
            vb0, Jvel = self._vel_rows_analytic(q, v, sp, to_dx)

        # ---- closed-form rows -------------------------------------------
        f = forces[..., :3 * nf].reshape(lead + (nf, 3))
        swing = (torch.repeat_interleave(1.0 - c, 3, dim=-1)
                 * f.reshape(lead + (3 * nf,)))
        fric = c * f[..., 2]
        cone = c * (self.mu**2 * f[..., 2] ** 2 - f[..., 0] ** 2
                    - f[..., 1] ** 2)
        vzd = self._swing_vel(sp.swing[..., :nf], shared, lead)
        rows = [g_dyn, swing, vb0[..., :2 * nf],
                vb0[..., 2 * nf:3 * nf] - sm * (1.0 - c) * vzd]
        if self.has_ext:
            rows.append(forces[..., 3 * nf:3 * nf + 3]
                        - _node(shared.ext_force_des, lead))
        if self.has_arm:
            rows.append(vb0[..., 3 * nf:3 * nf + 3]
                        - sm * _node(shared.arm_vel_des, lead))
        rows += [fric, cone, q[..., model.base_nq:], v[..., 6:]]
        if self.has_tau:
            rows.append(tau_j)
        g = torch.cat(rows, -1)

        GB = self._lin_jacobian(sp)
        GB[..., ix["dyn_nl_rows"], :] = Jd
        GB[..., ix["vel_rows"], :] = Jvel
        GB[..., ix["cone_rows"], :] = self._cone_jac(u, sp)
        C_full = Z.new_zeros(self.m_dense, ndx)
        C_full[:self.n_dyn] = C_pat
        C = C_full.expand(lead + C_full.shape)
        return g, GB[..., :ndx], GB[..., ndx:], C

    # ------------------------------------------------------------------
    def objective_data(self, shared: SharedParams):
        form = self.form
        N = self.nodes
        x_des = form.x_des(shared)
        dx_des = form.difference(shared.x_init, x_des)
        u_des = form.u_des(shared)
        Q, R = shared.Q_diag, shared.R_diag
        ones_x, zeros_x = torch.ones_like(Q), torch.zeros_like(Q)
        P_rows, t_rows = [], []
        for i in range(N + 1):
            pq, tq = (ones_x, zeros_x) if i == 0 else (Q, dx_des)
            if i < N:
                pu, tu = R, u_des
                if self.has_tau and i >= form.tau_nodes:
                    ti = form.tau_idx
                    pu = torch.cat([R[..., :ti], torch.ones_like(R[..., ti:])],
                                   -1)
                    tu = torch.cat([tu[..., :ti],
                                    torch.zeros_like(tu[..., ti:])], -1)
            else:
                pu, tu = torch.ones_like(R), torch.zeros_like(R)
            P_rows.append(torch.cat([pq, pu], -1))
            t_rows.append(torch.cat([tq, tu], -1))
        P_base = torch.stack(P_rows, dim=-2)
        z_des = torch.stack(t_rows, dim=-2)
        P_w = torch.zeros_like(P_base)
        z_w = torch.zeros_like(z_des)
        if self.has_tau:
            t0 = self.ndx + form.tau_idx
            P_w[..., 0, t0:] = shared.W_diag
            z_w[..., 0, t0:] = shared.tau_prev
        return ObjectiveData(P_base, z_des, P_w, z_w)

    def objective_value(self, Z, obj):
        e = Z - obj.z_des
        ew = Z - obj.z_w
        return ((obj.P_base * e * e).sum((-1, -2))
                + (obj.P_w * ew * ew).sum((-1, -2)))

    def objective_gradient(self, Z, obj):
        return 2.0 * obj.P_base * (Z - obj.z_des) + 2.0 * obj.P_w * (Z - obj.z_w)

    def hessian_diag(self, obj):
        return 2.0 * (obj.P_base + obj.P_w)
