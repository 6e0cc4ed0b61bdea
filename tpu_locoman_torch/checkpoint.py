"""Checkpoint and resume of the MPC carry.

PyTorch counterpart of ``tpu_locoman/checkpoint.py``: the warm-start carry
(primal iterate, ADMM duals, robot state, torque hand-off) is written to an
``.npz`` file with the JAX package's keys, so that a session resumes where
it stopped, and a carry written by either package loads in the other. The
port's carry has a leading scenario axis; the JAX package's is one
scenario, which ``load_carry`` gives a scenario axis of one.
"""

import numpy as np
import torch

from .mpc import MPCCarry, _device
from .solver import SolverState

#: the .npz keys, as the JAX package writes them
KEYS = ("x_init", "Z", "z_admm", "y_admm", "tau_prev")


def save_carry(path, carry):
    """Write ``carry`` to ``path`` (".npz" appended when missing) and
    return the path of the file."""
    path = str(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    st = carry.solver_state
    arrays = dict(x_init=carry.x_init, Z=st.Z, z_admm=st.z_admm,
                  y_admm=st.y_admm, tau_prev=carry.tau_prev)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in arrays.items()})
    return path


def load_carry(path, device="cuda"):
    """The MPCCarry stored at ``path``, as float32 tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = _device(device)
    with np.load(path) as d:
        arrays = {k: np.asarray(d[k], np.float32) for k in KEYS}
    if arrays["x_init"].ndim == 1:  # one scenario (the JAX package's)
        arrays = {k: v[None] for k, v in arrays.items()}
    t = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    return MPCCarry(
        x_init=t["x_init"],
        solver_state=SolverState(Z=t["Z"], z_admm=t["z_admm"],
                                 y_admm=t["y_admm"]),
        tau_prev=t["tau_prev"])
