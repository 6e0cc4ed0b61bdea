"""Dynamics formulations as batched stage functions.

PyTorch counterpart of ``tpu_locoman/dynamics/formulations.py``:
``StageParams``, ``SharedParams``, the ``Formulation`` and
``_AccStateFormulation`` bases and ``WholeBodyRNEA``. The other four
formulations wait for a later slice (ROADMAP queue 1, item 13).

Every stage function takes tensors with the same leading dimensions
(scenarios, nodes, ...) and maps the trailing axis; the JAX versions are
written per node and vmapped.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import rbda
from ..rbda import model_difference, model_integrate


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
        q0 = torch.as_tensor(np.asarray(self.robot.q0, dtype=np.float32),
                             device=shared.base_vel_des.device)
        return torch.cat([q0.expand(lead + q0.shape), shared.base_vel_des,
                          shared.base_vel_des.new_zeros(lead + (self.nj,))],
                         dim=-1)

    def default_weights_Q(self):
        return np.concatenate([self._q_weights_pos(), self._q_weights_vel()])


class WholeBodyRNEA(_AccStateFormulation):
    """Inverse-dynamics transcription: input (a, forces, tau_j), torques
    active on the first tau_nodes nodes only."""

    name = "whole_body_rnea"

    def __init__(self, robot, tau_nodes=3, include_acc=True):
        if not include_acc:
            raise NotImplementedError(
                "whole_body_rnea(include_acc=False) is not ported yet "
                "(ROADMAP queue 1, item 13)")
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

    def dyn_nl_idx(self):
        return np.arange(2 * self.nv, self.n_dyn, dtype=np.int64)

    def dyn_lin_jacobian(self, sp):
        return self._prop_lin_jacobian(sp, with_rv=True)

    def rnea_dyn(self, q, v, a, forces):
        return rbda.rnea(self.model, q, v, a, self.ee_frames, forces)

    def dyn_residual(self, x_init, dx, u, dx_next, sp):
        d = self.decode(x_init, dx, u)
        nv = self.nv
        dt = sp.dt[..., None]
        r_q = dx_next[..., :nv] - (dx[..., :nv] + d["v"] * dt)
        r_v = dx_next[..., nv:] - (dx[..., nv:] + d["a"] * dt)
        tau = self.rnea_dyn(d["q"], d["v"], d["a"], d["forces"])
        return torch.cat([r_q, r_v, tau[..., :6],
                          sp.tau_mask[..., None] * (tau[..., 6:] - d["tau_j"])],
                         dim=-1)

    def default_weights(self):
        Q = self.default_weights_Q()
        R = np.concatenate([[1e-3] * self.na_opt, [1e-3] * self.nf,
                            [1e-4] * self.nj])
        return Q.astype(np.float32), R.astype(np.float32)

    def default_W(self):
        return np.zeros(self.nj, dtype=np.float32)

    def u_des(self, shared):
        f = self.f_des(shared.n_contacts)
        lead = f.shape[:-1]
        return torch.cat([f.new_zeros(lead + (self.na_opt,)), f,
                          f.new_zeros(lead + (self.nj,))], dim=-1)


FORMULATIONS = {"whole_body_rnea": WholeBodyRNEA}
DEFAULT_ARGS = {"whole_body_rnea": {"tau_nodes": 3, "include_acc": True}}
_NOT_PORTED = ("centroidal_vel", "centroidal_acc", "whole_body_acc",
               "whole_body_aba")


def make_formulation(name, robot, **kwargs):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dynamics {name!r} is not ported yet (ROADMAP queue 1, item 13)")
    if name not in FORMULATIONS:
        raise ValueError(f"Unknown dynamics type: {name}")
    args = dict(DEFAULT_ARGS[name])
    args.update(kwargs)
    return FORMULATIONS[name](robot, **args)
