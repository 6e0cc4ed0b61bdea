"""Carry state between the JAX package and the port.

The system has no learned parameters; what crosses over is the MPC state.
The robot model is carried across by building both sides from the same
spec JSON; the solver state and the stage/shared parameters cross as numpy
arrays (``jax.device_get`` of the JAX NamedTuples, or plain dicts), so this
module imports neither jax nor the JAX package.
"""

import base64
import json

import numpy as np
import torch

from .dynamics.formulations import SharedParams, StageParams
from .mpc import MPCCarry
from .solver import SolverState


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def carry_from_numpy(carry, device):
    """MPCCarry of numpy arrays (batched, scenario axis first) -> the port's
    MPCCarry on ``device``."""
    st = _get(carry, "solver_state")
    return MPCCarry(
        x_init=_t(_get(carry, "x_init"), device),
        solver_state=SolverState(Z=_t(_get(st, "Z"), device),
                                 z_admm=_t(_get(st, "z_admm"), device),
                                 y_admm=_t(_get(st, "y_admm"), device)),
        tau_prev=_t(_get(carry, "tau_prev"), device))


def carry_to_numpy(carry):
    """The port's MPCCarry -> nested dict of numpy arrays."""
    st = carry.solver_state
    return {"x_init": carry.x_init.detach().cpu().numpy(),
            "solver_state": {k: getattr(st, k).detach().cpu().numpy()
                             for k in SolverState._fields},
            "tau_prev": carry.tau_prev.detach().cpu().numpy()}


def stage_params_from_numpy(sp, device, batch=None):
    """StageParams with node-leading (N, ...) or batched (B, N, ...) numpy
    fields -> the port's (B, N, ...) StageParams."""
    out = {}
    for k in StageParams._fields:
        x = _t(_get(sp, k), device)
        if batch is not None and x.dim() == (2 if k in ("contact", "swing")
                                             else 1):
            x = x.expand((batch,) + tuple(x.shape))
        out[k] = x
    return StageParams(**out)


def _unpack(d):
    if isinstance(d, dict) and "b64" in d:
        return np.frombuffer(base64.b64decode(d["b64"]), dtype=d["dtype"]
                             ).reshape(d["shape"]).copy()
    if isinstance(d, dict):
        return {k: _unpack(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_unpack(v) for v in d]
    return d


def load_golden(path):
    """A golden fixture written by tools/make_torch_golden.py, with every
    packed array decoded to numpy."""
    with open(path) as f:
        return _unpack(json.load(f))


def shared_from_numpy(shared, device, batch=None):
    """SharedParams of one scenario (unbatched numpy) or a batch -> the
    port's SharedParams with a leading scenario axis."""
    per_vec = {"swing_period", "swing_height", "n_contacts"}
    out = {}
    for k in SharedParams._fields:
        x = _t(_get(shared, k), device)
        unbatched = x.dim() == (0 if k in per_vec else 1)
        if unbatched:
            x = x[None].expand((batch or 1,) + tuple(x.shape))
        out[k] = x
    return SharedParams(**out)
