"""Receding-horizon MPC over a batch of scenarios.

PyTorch counterpart of ``tpu_locoman/mpc.py``: ``geometric_dts``,
``MPCCarry`` and ``MPC`` (shared and stage parameters, the force warm start
at the gravity split, the "zero" and "aba" flip resets, the tick, the
time-consistent warm shift, the rollout and the retraction of every
formulation). Every tensor carries the scenario axis first; the JAX
version is written per scenario and vmapped.
"""

from typing import NamedTuple

import numpy as np
import torch

from .dynamics.formulations import SharedParams, StageParams, make_formulation
from .ocp import Transcription
from .solver import SQPConfig, SQPSolver, SolverState


def _device(device):
    """torch.device for an entry point; CUDA unless the caller asks for the
    CPU, and never a silent fall back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: pass device="cpu" to run '
                           'on the CPU')
    return dev


def geometric_dts(dt_min, dt_max, nodes, device="cuda"):
    """dt_i = dt_min * gamma^i, float32 (nodes,)."""
    if nodes < 2:
        raise ValueError("geometric_dts needs nodes >= 2")
    device = _device(device)
    gamma = (dt_max / dt_min) ** (1.0 / (nodes - 1))
    g = torch.tensor(gamma, dtype=torch.float32, device=device)
    return dt_min * g ** torch.arange(nodes, dtype=torch.float32,
                                      device=device)


class MPCCarry(NamedTuple):
    x_init: torch.Tensor  # (B, nx)
    solver_state: SolverState
    tau_prev: torch.Tensor  # (B, nj)


def _scenario_time(t, batch, device):
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    return t.expand(batch) if t.dim() == 0 else t


class MPC:
    """One robot + formulation + horizon, for a batch of scenarios."""

    def __init__(self, robot, dynamics="whole_body_rnea", nodes=14,
                 dt_min=0.01, dt_max=0.08, swing_height=0.07,
                 swing_vel_limits=(0.1, -0.2), config=SQPConfig(),
                 flip_reset=True, warm_shift=True, device="cuda",
                 **form_kwargs):
        self.device = _device(device)
        if robot.gait_sequence is None:
            raise ValueError("call robot.set_gait_sequence first")
        if isinstance(config, str):
            from .solver.sqp import PRESETS

            if config not in PRESETS:
                raise NotImplementedError(
                    f"config preset {config!r} is not ported yet")
            config = PRESETS[config]()
        if flip_reset not in (True, False, "zero", "aba"):
            raise ValueError(f"unknown flip_reset {flip_reset!r}")
        self.robot = robot
        self.form = make_formulation(dynamics, robot, **form_kwargs)
        self.trans = Transcription(self.form, nodes)
        self.solver = SQPSolver(self.trans, config)
        self.nodes = nodes
        self.flip_reset = flip_reset
        self.warm_shift = warm_shift
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.swing_height = swing_height
        self.swing_vel_limits = swing_vel_limits
        self.dts = geometric_dts(dt_min, dt_max, nodes, self.device)
        self.gait = robot.gait_sequence
        self.n_contacts = self.gait.n_contacts
        self.swing_period = self.gait.swing_period
        Q, R = self.form.default_weights()
        self.Q_diag, self.R_diag = Q, R
        self.W_diag = self.form.default_W()
        self._shift_index = self._shift_tables()

    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def x_nom(self):
        return self._f32(self.form.x_nom())

    def make_shared(self, x_init, base_vel_des, ext_force_des=None,
                    arm_vel_des=None, tau_prev=None):
        B = x_init.shape[0]
        dev = self.device

        def per(x, width):
            if x is None:
                return torch.zeros(B, width, device=dev)
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            return x.expand(B, width) if x.dim() == 1 else x

        scal = lambda v: torch.full((B,), v, dtype=torch.float32,  # noqa: E731
                                    device=dev)
        return SharedParams(
            x_init=x_init,
            base_vel_des=per(base_vel_des, 6),
            ext_force_des=per(ext_force_des, 3),
            arm_vel_des=per(arm_vel_des, 3),
            swing_period=scal(self.swing_period),
            swing_height=scal(self.swing_height),
            swing_vel_limits=self._f32(self.swing_vel_limits).expand(B, 2),
            n_contacts=scal(float(self.n_contacts)),
            Q_diag=self._f32(self.Q_diag).expand(B, -1),
            R_diag=self._f32(self.R_diag).expand(B, -1),
            W_diag=self._f32(self.W_diag).expand(B, -1),
            tau_prev=per(tau_prev, self.form.nj),
        )

    def make_stage_params(self, t_current):
        """Per-node schedules and masks, (B, N[, 4]), for t_current (B,)."""
        contact, swing = self.gait.get_gait_schedule(t_current, self.dts)
        B = t_current.shape[0]
        idx = torch.arange(self.nodes, dtype=torch.float32, device=self.device)
        node0 = torch.where(idx > 0, 1.0, 0.0).expand(B, -1)
        ones = torch.ones_like(node0)
        # with v an input, the velocity rows act at node 0 too
        state_mask = ones if self.form.v_in_u else node0
        if self.form.tau_idx is not None:
            tau_mask = torch.where(idx < self.form.tau_nodes, 1.0,
                                   0.0).expand(B, -1)
        else:
            tau_mask = ones
        return StageParams(dt=self.dts.expand(B, -1), contact=contact,
                           swing=swing, state_mask=state_mask,
                           tau_mask=tau_mask, node0_mask=node0)

    # ------------------------------------------------------------------
    def _shift_tables(self):
        N = self.nodes
        told = np.concatenate([[0.0], np.cumsum(self.dts.cpu().numpy())])
        j = np.clip(np.searchsorted(told, told + self.dt_min) - 1, 0, N - 1)
        w = np.clip((told + self.dt_min - told[j]) / (told[j + 1] - told[j]),
                    0.0, 1.0)
        ju = np.clip(np.searchsorted(told[:N], told[:N] + self.dt_min) - 1,
                     0, N - 2)
        wu = np.clip((told[:N] + self.dt_min - told[ju])
                     / (told[ju + 1] - told[ju]), 0.0, 1.0)
        return (torch.as_tensor(j), self._f32(w)[:, None],
                torch.as_tensor(ju), self._f32(wu)[:, None])

    def _shift_Z(self, Z, x_old, x_new):
        """Time-consistent warm-start shift: interpolate the previous
        solution at each node's advanced time and rebase the dx tangents
        from the old anchor state onto the new one."""
        form = self.form
        ndx, N = form.ndx, self.nodes
        j, w, ju, wu = self._shift_index
        dx = Z[..., :ndx]
        dx_i = (1.0 - w) * dx[:, j] + w * dx[:, j + 1]
        lead = dx_i.shape[:-1]
        x_o = x_old[:, None].expand(lead + x_old.shape[-1:])
        x_n = x_new[:, None].expand(lead + x_new.shape[-1:])
        dx_s = form.difference(x_n, form.integrate(x_o, dx_i))
        u = Z[:, :N, ndx:]
        u_i = (1.0 - wu) * u[:, ju] + wu * u[:, ju + 1]
        u_s = torch.cat([u_i, Z[:, N:, ndx:]], dim=1)
        return torch.cat([dx_s, u_s], dim=-1)

    def warm_start_Z(self, Z, sp, shared):
        """Reset the force slots to the contact-masked gravity split."""
        form = self.form
        f_des = form.f_des(shared.n_contacts)  # (B, nf)
        mask = torch.repeat_interleave(sp.contact, 3, dim=-1)
        nf3 = 3 * form.n_feet
        f_all = f_des[:, None, :nf3] * mask
        if form.nf > nf3:
            f_all = torch.cat([f_all, f_des[:, None, nf3:].expand(
                -1, self.nodes, -1)], dim=-1)
        f0 = form.ndx + form.f_idx
        Z = Z.clone()
        Z[:, :-1, f0:f0 + form.nf] = f_all
        return Z

    def init_carry(self, batch, x_init=None):
        x0 = self.x_nom() if x_init is None else torch.as_tensor(
            x_init, dtype=torch.float32, device=self.device)
        x0 = x0.expand(batch, -1).clone() if x0.dim() == 1 else x0
        state = self.solver.init_state(batch, self.device)
        shared = self.make_shared(x0, torch.zeros(6, device=self.device))
        sp = self.make_stage_params(torch.zeros(batch, device=self.device))
        state = state._replace(Z=self.warm_start_Z(state.Z, sp, shared))
        return MPCCarry(x_init=x0, solver_state=state,
                        tau_prev=torch.zeros(batch, self.form.nj,
                                             device=self.device))

    def step(self, carry, t_current, base_vel_des, ext_force_des=None,
             arm_vel_des=None, stage_params=None, prev_stage_params=None):
        """One MPC tick for every scenario; t_current is shared (scalar) or
        per scenario (B,).

        ``stage_params`` (a (B, N, ...) ``StageParams``) overrides the
        generated schedules, e.g. to give each scenario of a batch its own
        gait; the flip reset then reads the previous contact from
        ``prev_stage_params``, and is skipped when that is not given."""
        B = carry.x_init.shape[0]
        t = _scenario_time(t_current, B, self.device)
        shared = self.make_shared(carry.x_init, base_vel_des, ext_force_des,
                                  arm_vel_des, tau_prev=carry.tau_prev)
        sp = self.make_stage_params(t) if stage_params is None else stage_params
        Z = self.warm_start_Z(carry.solver_state.Z, sp, shared)
        na = getattr(self.form, "na_opt", 0)
        if prev_stage_params is not None:
            prev = prev_stage_params.contact
        elif stage_params is None:
            prev = self.make_stage_params(t - self.dt_min).contact
        else:
            prev = None
        if self.flip_reset and na > 0 and prev is not None:
            # reset the acceleration slots of nodes whose contact state
            # flipped since the previous tick: to zero, or ("aba") to the
            # forward dynamics at the warm start, a recorded negative result
            # of the JAX package (worse than zero on the violation spike)
            flipped = (sp.contact != prev).any(-1)
            node_mask = torch.cat([flipped, flipped.new_zeros(B, 1)], 1)
            ndx = self.form.ndx
            a_new = torch.zeros_like(Z[:, :, ndx:ndx + na])
            if self.flip_reset == "aba" and hasattr(self.form, "aba_dyn"):
                x0 = carry.x_init[:, None].expand(-1, self.nodes, -1)
                d = self.form.decode(x0, Z[:, :-1, :ndx], Z[:, :-1, ndx:])
                a_new[:, :-1] = self.form.aba_dyn(d["q"], d["v"], d["tau_j"],
                                                  d["forces"])
            Z[:, :, ndx:ndx + na] = torch.where(
                node_mask[..., None], a_new, Z[:, :, ndx:ndx + na])
        warm = carry.solver_state._replace(Z=Z)
        new_state, stats = self.solver.solve(warm, sp, shared)
        ndx = self.form.ndx
        x_next = self.form.integrate(carry.x_init, new_state.Z[:, 1, :ndx])
        if self.form.tau_idx is not None:
            # the executed torque hand-off: node 1 before the shift
            tau_prev = new_state.Z[:, 1, ndx + self.form.tau_idx:]
        else:
            tau_prev = carry.tau_prev
        if self.warm_shift:
            new_state = new_state._replace(
                Z=self._shift_Z(new_state.Z, carry.x_init, x_next))
        return MPCCarry(x_next, new_state, tau_prev), stats

    def run(self, n_loops, base_vel_des, ext_force_des=None, arm_vel_des=None,
            x_init=None, batch=1):
        """Rollout of n_loops ticks for ``batch`` scenarios; returns (carry,
        outs) with outs stacked (n_loops, B, ...)."""
        carry = self.init_carry(batch, x_init)
        outs = {"x": [], "max_violation": [], "alpha": [], "status": []}
        for k in range(n_loops):
            # the tick's clock in float32 arithmetic, as the JAX scan has it
            t = torch.tensor(float(k), device=self.device) * self.dt_min
            carry, stats = self.step(carry, t, base_vel_des, ext_force_des,
                                     arm_vel_des)
            outs["x"].append(carry.x_init)
            for key in ("max_violation", "alpha", "status"):
                outs[key].append(stats[key])
        return carry, {k: torch.stack(v) for k, v in outs.items()}

    def retract(self, Z, x_init, num_steps=None):
        """Executed (q, v, a, forces, tau) per node, (B, n, ...)."""
        form = self.form
        n = self.nodes if num_steps is None else num_steps
        ndx = form.ndx
        dx = Z[:, :n, :ndx].clone()
        dx[:, 0] = 0.0
        x = x_init[:, None].expand(-1, n, -1)
        d = form.decode(x, dx, Z[:, :n, ndx:])
        q, v, forces = d["q"], d["v"], d["forces"]
        if form.v_in_u:
            # finite-difference acceleration with exact base rows; the last
            # node of the horizon reuses its own input
            u_next = Z[:, 1:n + 1, ndx:].clone()
            if n == self.nodes:
                u_next[:, -1] = Z[:, n - 1, ndx:]
            v_next = form.decode(x, Z[:, 1:n + 1, :ndx], u_next)["v"]
            a = (v_next - v) / self.dts[:n, None]
            a = torch.cat([form.base_acc_dynamics(q, v, a[..., 6:], forces),
                           a[..., 6:]], -1)
            tau = form.rnea_dyn(q, v, a, forces)[..., 6:]
        elif d["tau_j"] is not None:  # torques are inputs
            a, tau = d["a"], d["tau_j"]
        else:
            a = d["a"]
            tau = form.rnea_dyn(q, v, a, forces)[..., 6:]
        return {"q": q, "v": v, "a": a, "forces": forces, "tau": tau}
