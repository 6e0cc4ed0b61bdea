"""Dynamics formulations as batched stage functions.

PyTorch counterpart of ``tpu_locoman/dynamics/formulations.py``:
``StageParams``, ``SharedParams`` and the five formulations
(``centroidal_vel``, ``centroidal_acc``, ``whole_body_acc``,
``whole_body_rnea``, ``whole_body_aba``) at their default arguments. The
variants that the JAX package linearizes by a whole-stage jacfwd
(``include_base=False``, ``include_acc=False``) wait for a later slice
(ROADMAP queue 1, item 13b).

Every stage function takes tensors with the same leading dimensions
(scenarios, nodes, ...) and maps the trailing axis; the JAX versions are
written per node and vmapped.

Each formulation also gives the transcription its dynamics rows with their
(dx, u) Jacobian (``dyn_linearize``): by the chain rule from the analytic
RNEA derivatives (kernel K2) for ``whole_body_rnea`` and
``whole_body_acc``, from ``rbda.aba_derivatives`` (K1 and K2) for
``whole_body_aba``, and by reverse-mode AD over plain torch for the
centroidal rows, which reach no kernel (the JAX package takes those by
jacrev too).
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import rbda, rnea_derivs
from ..rbda import model_difference, model_integrate

#: the NotImplementedError text of the variants still to port
_ITEM_13B = "is not ported yet (ROADMAP queue 1, item 13b)"


class StageParams(NamedTuple):
    """Per-node parameters, (B, N[, 4]) with the scenario axis first."""

    dt: torch.Tensor
    contact: torch.Tensor  # 0/1
    swing: torch.Tensor  # swing phase in [0, 1]
    state_mask: torch.Tensor
    tau_mask: torch.Tensor
    node0_mask: torch.Tensor


class SharedParams(NamedTuple):
    """Horizon-invariant parameters, each with a leading scenario axis."""

    x_init: torch.Tensor  # (B, nx)
    base_vel_des: torch.Tensor  # (B, 6)
    ext_force_des: torch.Tensor  # (B, 3)
    arm_vel_des: torch.Tensor  # (B, 3)
    swing_period: torch.Tensor  # (B,)
    swing_height: torch.Tensor  # (B,)
    swing_vel_limits: torch.Tensor  # (B, 2)
    n_contacts: torch.Tensor  # (B,)
    Q_diag: torch.Tensor  # (B, ndx)
    R_diag: torch.Tensor  # (B, nu)
    W_diag: torch.Tensor  # (B, nj)
    tau_prev: torch.Tensor  # (B, nj)


class Formulation:
    """Shared robot plumbing."""

    name = "base"
    #: where the configuration tangent starts in dx, and q in x
    dq_off = 0
    q_off = 0
    #: v is an input (u[:nv]) rather than part of the state
    v_in_u = False

    def __init__(self, robot):
        self.robot = robot
        self.model = robot.model
        self.mass = robot.mass
        self.foot_frames = list(robot.foot_frames)
        self.ext_force_frame = robot.ext_force_frame
        self.arm_ee_frame = robot.arm_ee_frame
        self.base_frame = robot.base_frame
        self.nq = robot.nq
        self.nv = robot.nv
        self.nj = robot.nj
        self.nf = robot.nf
        self.n_feet = len(self.foot_frames)
        self.ee_frames = self.foot_frames + (
            [self.ext_force_frame] if self.ext_force_frame else [])

    def dx_next_pattern(self):
        """Constant Jacobian of the dynamics rows wrt dx_next."""
        n_prop = self.n_prop_rows
        pat = np.zeros((self.n_dyn, self.ndx), dtype=np.float32)
        pat[:n_prop, :n_prop] = np.eye(n_prop, dtype=np.float32)
        return pat

    def _prop_lin_jacobian(self, sp, with_rv=True):
        """(..., n_dyn, s) Jacobian of the Euler propagation rows
        r_q = dxn[:nv] - (dx*n0)[:nv] - (v0 + (dx*n0)[nv:])*dt and
        r_v = dxn[nv:] - (dx*n0)[nv:] - u[:nv]*dt."""
        nv = self.nv
        s = self.ndx + self.nu
        n0 = sp.node0_mask[..., None]
        dt = sp.dt[..., None]
        lead = sp.dt.shape
        idx = torch.arange(nv, device=sp.dt.device)
        J = sp.dt.new_zeros(lead + (self.n_dyn, s))
        J[..., idx, idx] = -n0
        J[..., idx, nv + idx] = -n0 * dt
        if with_rv:
            J[..., nv + idx, nv + idx] = -n0
            J[..., nv + idx, self.ndx + idx] = -dt.expand(lead + (nv,))
        return J

    # -- shared force kernels -------------------------------------------
    def com_dynamics(self, q, forces):
        """hdot (..., 6), scaled by mass, from the contact forces:
        Newton-Euler about the centre of mass."""
        R_w, p_w = rbda.fk(self.model, q)
        com = rbda._com_from(self.model, R_w, p_w)
        dp = self.model.tensors(q.device)["g_spatial"][:3] * -self.mass
        dl = torch.zeros_like(com)
        for idx, fname in enumerate(self.ee_frames):
            f = forces[..., 3 * idx:3 * idx + 3]
            r = rbda.frame_placement(self.model, fname, R_w, p_w)[1] - com
            dp = dp + f
            dl = dl + rbda.cross(r, f)
        return torch.cat([dp.expand_as(dl), dl], -1)

    def rnea_dyn(self, q, v, a, forces):
        """Whole-body torques (..., nv)."""
        return rbda.rnea(self.model, q, v, a, self.ee_frames, forces)

    def frame_velocity(self, frame, q, v, relative_to_base=False):
        return rbda.frame_velocity(self.model, frame, q, v, relative_to_base,
                                   self.base_frame)

    def _rnea_jac(self, q, v, a, forces):
        """tau (..., nv) and its derivatives dtau/d(q tangent, v, a, f)
        (..., nv, nv | nf): one ``rnea_derivatives`` call (kernel K2) over
        the flat batch of nodes."""
        ee = tuple(self.ee_frames)
        tau = rbda.rnea(self.model, q, v, a, ee, forces)
        lead = q.shape[:-1]
        flat = lambda x: x.reshape((-1,) + x.shape[len(lead):])  # noqa: E731
        derivs = rnea_derivs.rnea_derivatives(
            self.model, flat(q).contiguous(), flat(v).contiguous(),
            flat(a).contiguous(), ee, flat(forces).contiguous())
        return tau, [x.reshape(lead + x.shape[1:]) for x in derivs]

    def dyn_linearize(self, x_init, dx, u, sp, to_dx):
        """(decode, dynamics rows at dx_next = 0, their (..., len(dyn_nl_idx),
        ndx + nu) Jacobian wrt (dx, u)). Here by reverse-mode AD, one
        forward pass and one pullback per nonlinear row over plain torch:
        the centroidal formulations, whose rows reach no kernel. The
        formulations whose rows go through RNEA write the chain rule out
        instead, with ``to_dx`` mapping local q-tangent columns to dx."""
        n0 = sp.node0_mask[..., None]
        zero_next = torch.zeros_like(dx)

        def rows(dx_, u_):
            return self.dyn_residual(x_init, dx_ * n0, u_, zero_next, sp)

        dyn0, pull = torch.func.vjp(rows, dx, u)
        idx = torch.as_tensor(self.dyn_nl_idx(), device=dx.device)
        basis = torch.eye(self.n_dyn, dtype=dx.dtype, device=dx.device)[idx]
        basis = basis.reshape((len(idx),) + (1,) * (dyn0.dim() - 1)
                              + (self.n_dyn,)).expand((len(idx),) + dyn0.shape)
        gdx, gu = torch.func.vmap(pull)(basis)
        J = torch.cat([gdx, gu], -1).movedim(0, -2)
        return self.decode(x_init, dx * n0, u), dyn0, J

    def default_W(self):
        """Torque-continuity weights (the tau_0 term of whole_body_rnea)."""
        return np.zeros(self.nj, dtype=np.float32)

    def f_des(self, n_contacts):
        """(..., nf): 0.8/1.2 front/rear gravity split over contact feet."""
        f_gravity = rbda.GRAVITY * self.mass
        dev = n_contacts.device
        front = (torch.tensor([0.0, 0.0, 0.8], device=dev) * f_gravity
                 / n_contacts[..., None])
        rear = (torch.tensor([0.0, 0.0, 1.2], device=dev) * f_gravity
                / n_contacts[..., None])
        parts = [front, front, rear, rear]
        if self.ext_force_frame:
            parts.append(torch.zeros_like(front))
        return torch.cat(parts, dim=-1)

    def _q_weights_pos(self):
        base = [0, 0, 1000, 10000, 10000, 0]
        joints = list(np.tile([1000, 500, 500], 4))
        if self.arm_ee_frame:
            joints += [100] * 6
        return base + joints

    def _q_weights_vel(self):
        return [2000, 2000, 1000, 1000, 1000, 2000] + [1] * self.nj


class CentroidalVel(Formulation):
    """State (h, q), input (v, forces); the momentum gaps A v = h m."""

    name = "centroidal_vel"
    dq_off = 6
    q_off = 6
    v_in_u = True

    def __init__(self, robot, include_base=True):
        if not include_base:
            raise NotImplementedError(
                f"centroidal_vel(include_base=False) {_ITEM_13B}")
        super().__init__(robot)
        self.include_base = include_base
        self.nv_opt = self.nv
        self.nx = 6 + self.nq
        self.ndx = 6 + self.nv
        self.f_idx = self.nv_opt
        self.tau_idx = None

    @property
    def nu(self):
        return self.nv_opt + self.nf

    @property
    def n_dyn(self):
        return 6 + self.nv + 6

    @property
    def n_prop_rows(self):
        return 6 + self.nv

    def x_nom(self):
        return np.concatenate([np.zeros(6), self.robot.q0])

    def integrate(self, x, dx):
        return torch.cat([x[..., :6] + dx[..., :6],
                          model_integrate(self.model, x[..., 6:],
                                          dx[..., 6:])], -1)

    def difference(self, x0, x1):
        return torch.cat([x1[..., :6] - x0[..., :6],
                          model_difference(self.model, x0[..., 6:],
                                           x1[..., 6:])], -1)

    def base_vel_dynamics(self, h, q, v_j):
        """v_b = A_b^-1 (h m - A_j v_j)."""
        A = rbda.ccrba(self.model, q)
        rhs = h * self.mass - rbda.mv(A[..., 6:], v_j)
        return torch.linalg.solve(A[..., :6], rhs)

    def base_acc_dynamics(self, q, v, a_j, forces):
        """a_b = A_b^-1 (dh - Adot v - A_j a_j); used by the retraction."""
        return _centroidal_base_acc(self, q, v, a_j, forces)

    def decode(self, x_init, dx, u):
        x = self.integrate(x_init, dx)
        return {"h": x[..., :6], "q": x[..., 6:], "v": u[..., :self.nv_opt],
                "forces": u[..., self.f_idx:], "a": None, "tau_j": None}

    def dyn_nl_idx(self):
        return np.concatenate([np.arange(6),
                               np.arange(6 + self.nv, self.n_dyn)])

    def dyn_lin_jacobian(self, sp):
        """r_q = dxn[6:] - (dx*n0)[6:] - u[:nv]*dt."""
        nv = self.nv
        lead = sp.dt.shape
        idx = torch.arange(nv, device=sp.dt.device)
        J = sp.dt.new_zeros(lead + (self.n_dyn, self.ndx + self.nu))
        J[..., 6 + idx, 6 + idx] = -sp.node0_mask[..., None]
        J[..., 6 + idx, self.ndx + idx] = -sp.dt[..., None].expand(
            lead + (nv,))
        return J

    def dyn_residual(self, x_init, dx, u, dx_next, sp, d=None):
        d = self.decode(x_init, dx, u) if d is None else d
        dt = sp.dt[..., None]
        h_dot = self.com_dynamics(d["q"], d["forces"]) / self.mass
        r_h = dx_next[..., :6] - (dx[..., :6] + h_dot * dt)
        r_q = dx_next[..., 6:] - (dx[..., 6:] + d["v"] * dt)
        A = rbda.ccrba(self.model, d["q"])
        gaps = rbda.mv(A, d["v"]) - d["h"] * self.mass
        return torch.cat([r_h, r_q, gaps], -1)

    def x_des(self, shared):
        lead = shared.base_vel_des.shape[:-1]
        q0 = _q0(self, shared.base_vel_des.device)
        return torch.cat([shared.base_vel_des, q0.expand(lead + q0.shape)],
                         -1)

    def default_weights(self):
        Q = np.concatenate([[1000.0] * 6, self._q_weights_pos()])
        R = np.concatenate([[1.0] * self.nv_opt, [1e-3] * self.nf])
        return Q.astype(np.float32), R.astype(np.float32)

    def u_des(self, shared):
        return _zeros_then_forces(self, self.nv_opt, shared)


def _q0(form, device):
    return torch.as_tensor(np.asarray(form.robot.q0, dtype=np.float32),
                           device=device)


def _zeros_then_forces(form, n, shared, tail=0):
    """u targets [0 (n), f_des (nf), 0 (tail)]."""
    f = form.f_des(shared.n_contacts)
    lead = f.shape[:-1]
    return torch.cat([f.new_zeros(lead + (n,)), f,
                      f.new_zeros(lead + (tail,))], -1)


def _centroidal_base_acc(form, q, v, a_j, forces):
    """a_b = A_b^-1 (dh - Adot v - A_j a_j)."""
    A = rbda.ccrba(form.model, q)
    Adot = rbda.dccrba(form.model, q, v)
    dh = form.com_dynamics(q, forces)
    rhs = dh - rbda.mv(Adot, v) - rbda.mv(A[..., 6:], a_j)
    return torch.linalg.solve(A[..., :6], rhs)


class _AccStateFormulation(Formulation):
    """(q, v) state layout."""

    def __init__(self, robot):
        super().__init__(robot)
        self.nx = self.nq + self.nv
        self.ndx = 2 * self.nv

    def x_nom(self):
        return np.concatenate([self.robot.q0, np.zeros(self.nv)])

    def integrate(self, x, dx):
        q = model_integrate(self.model, x[..., :self.nq], dx[..., :self.nv])
        return torch.cat([q, x[..., self.nq:] + dx[..., self.nv:]], dim=-1)

    def difference(self, x0, x1):
        dq = model_difference(self.model, x0[..., :self.nq], x1[..., :self.nq])
        return torch.cat([dq, x1[..., self.nq:] - x0[..., self.nq:]], dim=-1)

    def x_des(self, shared):
        lead = shared.base_vel_des.shape[:-1]
        q0 = _q0(self, shared.base_vel_des.device)
        return torch.cat([q0.expand(lead + q0.shape), shared.base_vel_des,
                          shared.base_vel_des.new_zeros(lead + (self.nj,))],
                         dim=-1)

    def default_weights_Q(self):
        return np.concatenate([self._q_weights_pos(), self._q_weights_vel()])

    def _euler_rows(self, dx, d, dt, dx_next=None):
        """The Euler propagation rows dx_next_q - (dx_q + v dt) and
        dx_next_v - (dx_v + a dt), at dx_next = 0 when it is None."""
        nv = self.nv
        r_q, r_v = dx[..., :nv] + d["v"] * dt, dx[..., nv:] + d["a"] * dt
        if dx_next is None:
            return [-r_q, -r_v]
        return [dx_next[..., :nv] - r_q, dx_next[..., nv:] - r_v]

    def _gaps(self, d, sp):
        """The dynamics rows after the propagation rows."""
        return []

    def dyn_residual(self, x_init, dx, u, dx_next, sp, d=None):
        d = self.decode(x_init, dx, u) if d is None else d
        return torch.cat(self._euler_rows(dx, d, sp.dt[..., None], dx_next)
                         + self._gaps(d, sp), -1)


class _AccInput(_AccStateFormulation):
    """Input (a, forces) with a = u[:nv]: the centroidal_acc and
    whole_body_acc layouts (include_base=True)."""

    def __init__(self, robot, include_base=True):
        if not include_base:
            raise NotImplementedError(
                f"{self.name}(include_base=False) {_ITEM_13B}")
        super().__init__(robot)
        self.include_base = include_base
        self.na_opt = self.nv
        self.f_idx = self.na_opt
        self.tau_idx = None

    @property
    def nu(self):
        return self.na_opt + self.nf

    @property
    def n_dyn(self):
        return 2 * self.nv + 6

    @property
    def n_prop_rows(self):
        return 2 * self.nv

    def decode(self, x_init, dx, u):
        x = self.integrate(x_init, dx)
        return {"q": x[..., :self.nq], "v": x[..., self.nq:],
                "a": u[..., :self.na_opt], "forces": u[..., self.f_idx:],
                "tau_j": None}

    def dyn_nl_idx(self):
        return np.arange(2 * self.nv, self.n_dyn)

    def dyn_lin_jacobian(self, sp):
        return self._prop_lin_jacobian(sp, with_rv=True)

    def default_weights(self):
        Q = self.default_weights_Q()
        R = np.concatenate([[1e-3] * self.na_opt, [1e-3] * self.nf])
        return Q.astype(np.float32), R.astype(np.float32)

    def u_des(self, shared):
        return _zeros_then_forces(self, self.na_opt, shared)


class CentroidalAcc(_AccInput):
    """State (q, v), input (a, forces); the centroidal-map gaps
    A a + Adot v = dh."""

    name = "centroidal_acc"

    def base_acc_dynamics(self, q, v, a_j, forces):
        """a_b = A_b^-1 (dh - Adot v - A_j a_j)."""
        return _centroidal_base_acc(self, q, v, a_j, forces)

    def _gaps(self, d, sp):
        q, v = d["q"], d["v"]
        A = rbda.ccrba(self.model, q)
        Adot = rbda.dccrba(self.model, q, v)
        return [rbda.mv(A, d["a"]) + rbda.mv(Adot, v)
                - self.com_dynamics(q, d["forces"])]


class WholeBodyAcc(_AccInput):
    """State (q, v), input (a, forces); the base rows of the equations of
    motion (RNEA with the contact forces) as gaps."""

    name = "whole_body_acc"

    def base_acc_dynamics(self, q, v, a_j, forces):
        """a_b = M_bb^-1 (-nle_b - M_bj a_j + J_c^T f)."""
        M = rbda.crba(self.model, q)
        nle = rbda.nonlinear_effects(self.model, q, v)
        tau_ext = torch.zeros_like(nle[..., :6])
        for idx, fname in enumerate(self.ee_frames):
            J = rbda.frame_jacobian_lwa(self.model, fname, q)
            tau_ext = tau_ext + rbda.mv(J[..., :3, :6].transpose(-1, -2),
                                        forces[..., 3 * idx:3 * idx + 3])
        rhs = -nle[..., :6] - rbda.mv(M[..., :6, 6:], a_j) + tau_ext
        return torch.linalg.solve(M[..., :6, :6], rhs)

    def _gaps(self, d, sp):
        return [self.rnea_dyn(d["q"], d["v"], d["a"], d["forces"])[..., :6]]

    def dyn_linearize(self, x_init, dx, u, sp, to_dx):
        """The base rows by the chain rule from K2's dtau blocks."""
        n0 = sp.node0_mask[..., None]
        dxm = dx * n0
        d = self.decode(x_init, dxm, u)
        tau, (dq_, dv_, da_, df_) = self._rnea_jac(d["q"], d["v"], d["a"],
                                                   d["forces"])
        dyn0 = torch.cat(self._euler_rows(dxm, d, sp.dt[..., None])
                         + [tau[..., :6]], -1)
        n0r = n0[..., None]
        Jd = torch.cat([to_dx(dq_[..., :6, :]) * n0r, dv_[..., :6, :] * n0r,
                        da_[..., :6, :], df_[..., :6, :]], -1)
        return d, dyn0, Jd


class WholeBodyRNEA(_AccStateFormulation):
    """Inverse-dynamics transcription: input (a, forces, tau_j), torques
    active on the first tau_nodes nodes only."""

    name = "whole_body_rnea"

    def __init__(self, robot, tau_nodes=3, include_acc=True):
        if not include_acc:
            raise NotImplementedError(
                f"whole_body_rnea(include_acc=False) {_ITEM_13B}")
        super().__init__(robot)
        self.tau_nodes = tau_nodes
        self.include_acc = include_acc
        self.na_opt = self.nv
        self.f_idx = self.na_opt
        self.tau_idx = self.f_idx + self.nf

    @property
    def nu(self):
        return self.na_opt + self.nf + self.nj

    @property
    def n_dyn(self):
        return 2 * self.nv + 6 + self.nj

    @property
    def n_prop_rows(self):
        return 2 * self.nv

    def decode(self, x_init, dx, u):
        x = self.integrate(x_init, dx)
        return {"q": x[..., :self.nq], "v": x[..., self.nq:],
                "a": u[..., :self.na_opt],
                "forces": u[..., self.f_idx:self.tau_idx],
                "tau_j": u[..., self.tau_idx:]}

    def aba_dyn(self, q, v, tau_j, forces):
        """Forward dynamics with zero base torque, for the "aba" flip
        reset: RNEA(q, v, ABA(q, v, tau, f), f) = tau."""
        return _aba_dyn(self, q, v, tau_j, forces)

    def dyn_nl_idx(self):
        return np.arange(2 * self.nv, self.n_dyn, dtype=np.int64)

    def dyn_lin_jacobian(self, sp):
        return self._prop_lin_jacobian(sp, with_rv=True)

    def _tau_rows(self, tau, d, sp):
        """The base rows of RNEA and the masked torque-equality rows."""
        return [tau[..., :6],
                sp.tau_mask[..., None] * (tau[..., 6:] - d["tau_j"])]

    def _gaps(self, d, sp):
        return self._tau_rows(
            self.rnea_dyn(d["q"], d["v"], d["a"], d["forces"]), d, sp)

    def dyn_linearize(self, x_init, dx, u, sp, to_dx):
        """The RNEA rows by the chain rule from K2's dtau blocks; the
        torque-equality rows carry -I on tau_j and the tau mask."""
        n0 = sp.node0_mask[..., None]
        dxm = dx * n0
        d = self.decode(x_init, dxm, u)
        lead = dx.shape[:-1]
        nv, nj = self.nv, self.nj
        tau, (dq_, dv_, da_, df_) = self._rnea_jac(d["q"], d["v"], d["a"],
                                                   d["forces"])
        dyn0 = torch.cat(self._euler_rows(dxm, d, sp.dt[..., None])
                         + self._tau_rows(tau, d, sp), -1)
        n0r = n0[..., None]
        Jtau = torch.zeros(lead + (nv, nj), device=dx.device)
        Jtau[..., 6:, :] = -torch.eye(nj, device=dx.device)
        Jd = torch.cat([to_dx(dq_) * n0r, dv_ * n0r, da_, df_, Jtau], -1)
        row_mask = torch.cat([torch.ones(lead + (6,), device=dx.device),
                              sp.tau_mask[..., None].expand(lead + (nj,))], -1)
        return d, dyn0, Jd * row_mask[..., None]

    def default_weights(self):
        Q = self.default_weights_Q()
        R = np.concatenate([[1e-3] * self.na_opt, [1e-3] * self.nf,
                            [1e-4] * self.nj])
        return Q.astype(np.float32), R.astype(np.float32)

    def u_des(self, shared):
        return _zeros_then_forces(self, self.na_opt, shared, tail=self.nj)


def _aba_dyn(form, q, v, tau_j, forces):
    tau = torch.cat([torch.zeros_like(tau_j[..., :6]), tau_j], -1)
    return rbda.aba(form.model, q, v, tau, form.ee_frames, forces)


class WholeBodyABA(_AccStateFormulation):
    """Forward-dynamics transcription: input (tau_j, forces), a = ABA."""

    name = "whole_body_aba"

    def __init__(self, robot):
        super().__init__(robot)
        self.f_idx = self.nj
        self.tau_idx = None

    @property
    def nu(self):
        return self.nj + self.nf

    @property
    def n_dyn(self):
        return 2 * self.nv

    @property
    def n_prop_rows(self):
        return 2 * self.nv

    def aba_dyn(self, q, v, tau_j, forces):
        return _aba_dyn(self, q, v, tau_j, forces)

    def decode(self, x_init, dx, u):
        x = self.integrate(x_init, dx)
        q, v = x[..., :self.nq], x[..., self.nq:]
        tau_j, forces = u[..., :self.nj], u[..., self.f_idx:]
        return {"q": q, "v": v, "a": self.aba_dyn(q, v, tau_j, forces),
                "forces": forces, "tau_j": tau_j}

    def dyn_nl_idx(self):
        return np.arange(self.nv, 2 * self.nv)

    def dyn_lin_jacobian(self, sp):
        return self._prop_lin_jacobian(sp, with_rv=False)

    def dyn_linearize(self, x_init, dx, u, sp, to_dx):
        """r_v = -(dx_v n0 + a dt) by the implicit rule of
        ``rbda.aba_derivatives``: one K1 and one K2 launch for every node
        of the batch."""
        n0 = sp.node0_mask[..., None]
        dxm = dx * n0
        x = self.integrate(x_init, dxm)
        q, v = x[..., :self.nq], x[..., self.nq:]
        tau_j, forces = u[..., :self.nj], u[..., self.f_idx:]
        tau = torch.cat([torch.zeros_like(tau_j[..., :6]), tau_j], -1)
        a, da_dq, da_dv, Minv, da_df = rbda.aba_derivatives(
            self.model, q, v, tau, self.ee_frames, forces)
        d = {"q": q, "v": v, "a": a, "forces": forces, "tau_j": tau_j}
        dt = sp.dt[..., None]
        dyn0 = torch.cat(self._euler_rows(dxm, d, dt), -1)
        n0r, dtr = n0[..., None], dt[..., None]
        eye = torch.eye(self.nv, dtype=dx.dtype, device=dx.device)
        Jd = torch.cat([-dtr * to_dx(da_dq) * n0r,
                        -(eye + dtr * da_dv) * n0r,
                        -dtr * Minv[..., 6:], -dtr * da_df], -1)
        return d, dyn0, Jd

    def default_weights(self):
        Q = self.default_weights_Q()
        R = np.concatenate([[1e-3] * self.nj, [1e-3] * self.nf])
        return Q.astype(np.float32), R.astype(np.float32)

    def u_des(self, shared):
        return _zeros_then_forces(self, self.nj, shared)


FORMULATIONS = {
    "centroidal_vel": CentroidalVel,
    "centroidal_acc": CentroidalAcc,
    "whole_body_acc": WholeBodyAcc,
    "whole_body_rnea": WholeBodyRNEA,
    "whole_body_aba": WholeBodyABA,
}

DEFAULT_ARGS = {
    "centroidal_vel": {"include_base": True},
    "centroidal_acc": {"include_base": True},
    "whole_body_acc": {"include_base": True},
    "whole_body_aba": {},
    "whole_body_rnea": {"tau_nodes": 3, "include_acc": True},
}


def make_formulation(name, robot, **kwargs):
    """The formulation ``name`` for ``robot``, its defaults merged with
    ``kwargs``."""
    if name not in FORMULATIONS:
        raise ValueError(f"Unknown dynamics type: {name}")
    args = dict(DEFAULT_ARGS[name])
    args.update(kwargs)
    return FORMULATIONS[name](robot, **args)
