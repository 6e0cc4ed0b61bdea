"""Faults planted in the program's timed path, to show that the check
catches them (``tests/test_bench_faults.py``, ``calibrate.py``). Each is a
context manager that wraps ``MPC.step`` of the program."""

import contextlib

import torch


@contextlib.contextmanager
def _wrapped(change):
    from tpu_locoman_torch import mpc as tmpc

    step = tmpc.MPC.step

    def faulty(self, carry, *args, **kwargs):
        out, stats = step(self, carry, *args, **kwargs)
        return change(carry, out), stats

    tmpc.MPC.step = faulty
    try:
        yield
    finally:
        tmpc.MPC.step = step


def unchanged():
    """The step returns the state it was given."""
    return _wrapped(lambda carry, out: carry)


def half_batch():
    """The second half of the scenarios is left out: each keeps the state
    it was given."""
    def change(carry, out):
        h = carry.x_init.shape[0] // 2

        def mix(a, b):
            return torch.cat([b[:h], a[h:]])

        s, o = carry.solver_state, out.solver_state
        return out._replace(
            x_init=mix(carry.x_init, out.x_init),
            solver_state=o._replace(Z=mix(s.Z, o.Z),
                                    z_admm=mix(s.z_admm, o.z_admm),
                                    y_admm=mix(s.y_admm, o.y_admm)),
            tau_prev=mix(carry.tau_prev, out.tau_prev))
    return _wrapped(change)


def altered(delta=0.1):
    """The first scenario's next state is altered where it is produced: its
    base height is off by ``delta`` (m)."""
    def change(carry, out):
        x = out.x_init.clone()
        x[0, 2] += delta
        return out._replace(x_init=x)
    return _wrapped(change)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
