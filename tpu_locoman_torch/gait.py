"""Gait sequencing and swing-foot velocity profiles.

PyTorch counterpart of ``tpu_locoman/gait.py`` (``GaitSequence`` and
``get_spline_vel_z``), batched over the leading dimensions of ``t``.
"""

import torch

FEET = ("FR_foot", "FL_foot", "RR_foot", "RL_foot")


def _mod(x, y):
    """Floor modulo with an exact remainder, as ``jnp.mod`` computes it
    (``torch.remainder`` rounds ``x - floor(x/y)*y`` instead)."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


class GaitSequence:
    """Phase-based contact scheduling."""

    def __init__(self, gait_type="trot", gait_period=0.5):
        self.feet = FEET
        self.gait_type = gait_type
        self.gait_period = gait_period
        if gait_type == "trot":
            self.n_contacts = 2
            self.swing_period = 0.5 * gait_period
        elif gait_type == "walk":
            self.n_contacts = 3
            self.swing_period = 0.25 * gait_period
        elif gait_type == "stand":
            self.n_contacts = 4
            self.swing_period = gait_period
        else:
            raise ValueError(f"Gait: {gait_type} not supported")

    def get_gait_schedule(self, t_current, dts):
        """Contact (0/1) and swing-phase schedules, both (..., nodes, 4).

        t_current: (...) float32 tensor; dts: (nodes,) step sizes. Node i
        sits at t_current + sum(dts[:i]). (The JAX version returns the
        transpose, (4, nodes), per scenario.)"""
        offs = torch.cat([torch.zeros(1, dtype=dts.dtype, device=dts.device),
                          torch.cumsum(dts[:-1], 0)])
        t = t_current[..., None] + offs
        period = torch.tensor(self.gait_period, dtype=t.dtype, device=t.device)
        swing_p = torch.tensor(self.swing_period, dtype=t.dtype,
                               device=t.device)
        gait_phase = _mod(t, period) / period
        swing_phase = _mod(t, swing_p) / swing_p
        if self.gait_type == "trot":
            first = gait_phase < 0.5  # FR, RL swing
            swing = torch.stack([first, ~first, ~first, first], dim=-1)
        elif self.gait_type == "walk":
            q1 = gait_phase < 0.25
            q2 = (gait_phase >= 0.25) & (gait_phase < 0.5)
            q3 = (gait_phase >= 0.5) & (gait_phase < 0.75)
            q4 = gait_phase >= 0.75
            swing = torch.stack([q3, q1, q2, q4], dim=-1)
        else:
            swing = torch.zeros(t.shape + (4,), dtype=torch.bool,
                                device=t.device)
        contact = torch.where(swing, 0.0, 1.0).to(t.dtype)
        swing_sched = torch.where(swing, swing_phase[..., None],
                                  torch.zeros((), dtype=t.dtype,
                                              device=t.device))
        return contact, swing_sched


def _spline_vel(t, t0, t1, pos0, vel0, pos1, vel1):
    """Velocity of the OCS2-style cubic spline through (t0, pos0, vel0) and
    (t1, pos1, vel1); every argument may be a tensor."""
    dt = t1 - t0
    dpos = pos1 - pos0
    dvel = vel1 - vel0
    c1 = vel0 * dt
    c2 = -(3.0 * vel0 + dvel) * dt + 3.0 * dpos
    c3 = (2.0 * vel0 + dvel) * dt - 2.0 * dpos
    tn = (t - t0) / dt
    return (3.0 * c3 * tn**2 + 2.0 * c2 * tn + c1) / dt


def get_spline_vel_z(swing_phase, swing_period, h_max=0.1, v_liftoff=0.1,
                     v_touchdown=-0.2):
    """Two C1 cubic splines 0 -> h_max -> 0 with liftoff/touchdown velocity
    boundary conditions; arguments broadcast."""
    mid = swing_period / 2.0
    t = swing_phase * swing_period
    v1 = _spline_vel(t, 0.0, mid, 0.0, v_liftoff, h_max, 0.0)
    v2 = _spline_vel(t, mid, swing_period, h_max, 0.0, 0.0, v_touchdown)
    return torch.where(swing_phase < 0.5, v1, v2)
