"""The one traffic generator: a mix file of parameters in, the inputs of a
run out, all drawn from the seed.

A mix file (``traffic/<name>.json``) gives ``batch`` (scenarios ticked
together), ``base_vel`` (uniform ranges of the commanded base velocity:
``vx``, ``vy`` in m/s and ``yaw_rate`` in rad/s; the other components are
0), ``phase_s`` (the uniform range of each scenario's gait phase offset in
seconds; a single value gives every scenario the same clock) and
``warmup_ticks``. Every scenario starts from the robot's nominal state, so
each seed gives the same work in shape and count, only other targets and
phases."""

from typing import NamedTuple

import numpy as np
import torch


class Inputs(NamedTuple):
    base_vel: torch.Tensor  # (B, 6)
    phase: torch.Tensor  # (B,) float32, seconds
    per_scenario: bool  # phases differ: t is a (B,) tensor
    rng: np.random.Generator  # what is left of the seed's stream

    def time(self, k, dt):
        """The clock of tick k in float32, per scenario or shared."""
        if self.per_scenario:
            return self.phase + np.float32(k) * np.float32(dt)
        return float(np.float32(self.phase[0].item()) + np.float32(k)
                     * np.float32(dt))


def seed_rng(seed):
    return np.random.default_rng(int(seed) % 2 ** 64)


def make(mix, seed, device):
    rng = seed_rng(seed)
    B = int(mix["batch"])
    vel = np.zeros((B, 6), np.float32)
    for key, col in (("vx", 0), ("vy", 1), ("yaw_rate", 5)):
        lo, hi = mix["base_vel"][key]
        vel[:, col] = rng.uniform(lo, hi, B)
    phase = mix["phase_s"]
    lo, hi = (phase, phase) if np.isscalar(phase) else phase
    per = hi > lo
    ph = rng.uniform(lo, hi, B) if per else np.full(B, lo)
    return Inputs(torch.as_tensor(vel, device=device),
                  torch.as_tensor(ph.astype(np.float32), device=device),
                  per, rng)
