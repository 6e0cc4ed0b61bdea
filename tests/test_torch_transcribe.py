"""The port's split linearization, bounds and objective against
tpu_locoman's Transcription on the same iterate: B2G N=4 (arm EE and
external-force rows) and Go2 N=6, at a warm-started Z plus seeded noise
with mixed contact/swing nodes.

Tolerance: atol 1e-4 * (max|ref| + 1) per quantity. Both sides compute the
same analytic Jacobians in f32 (the port composes them by hand, JAX by AD
through custom JVPs); RNEA rows reach ~1e5 in g and ~1e2 in G."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert  # noqa: E402

CASES = [("B2G", 4), ("Go2", 6)]


def _close(out, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=1e-4 * (np.abs(ref).max() + 1),
                               err_msg=err_msg)


def _pair(name, N, t=0.13, seed=3):
    jrob, trob = getattr(J, name)(), getattr(T, name)()
    jrob.set_gait_sequence("trot", 0.8)
    trob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=N)
    tm = T.MPC(trob, dynamics="whole_body_rnea", nodes=N, device="cpu")
    carry = jm.init_carry()
    vel = jnp.array([0.2, 0.0, 0.0, 0.0, 0.0, 0.1])
    shared = jm.make_shared(carry.x_init, vel, tau_prev=carry.tau_prev)
    sp = jm.make_stage_params(jnp.float32(t))
    rng = np.random.default_rng(seed)
    Z = jm.warm_start_Z(carry.solver_state.Z, sp, shared)
    Z = Z + jnp.asarray(rng.normal(size=Z.shape) * 0.02, dtype=jnp.float32)
    tsp = tm.make_stage_params(torch.tensor([t], dtype=torch.float32))
    tsh = tm.make_shared(torch.tensor(np.asarray(carry.x_init))[None],
                         torch.tensor(np.asarray(vel)))
    return jm, tm, Z, sp, shared, torch.tensor(np.asarray(Z))[None], tsp, tsh


@pytest.mark.parametrize("name,N", CASES)
def test_stage_and_shared_params_match(name, N):
    jm, tm, Z, sp, shared, tZ, tsp, tsh = _pair(name, N)
    jsp = convert.stage_params_from_numpy(jax.device_get(sp), "cpu", batch=1)
    for k in jsp._fields:
        _close(getattr(tsp, k), getattr(jsp, k), err_msg=k)
    jsh = convert.shared_from_numpy(jax.device_get(shared), "cpu")
    for k in jsh._fields:
        _close(getattr(tsh, k), getattr(jsh, k), err_msg=k)
    _close(tm.init_carry(1).solver_state.Z[0],
           jm.init_carry().solver_state.Z, err_msg="warm start")


@pytest.mark.parametrize("name,N", CASES)
def test_linearize_matches_jax(name, N):
    jm, tm, Z, sp, shared, tZ, tsp, tsh = _pair(name, N)
    ref = jax.jit(jm.trans.linearize)(Z, sp, shared)
    out = tm.trans.linearize(tZ, tsp, tsh)
    for label, o, r in zip(("g", "G", "B", "C"), out, ref):
        assert tuple(o.shape[1:]) == tuple(np.shape(r)), label
        _close(o[0], r, err_msg=label)


@pytest.mark.parametrize("name,N", CASES)
def test_bounds_evaluate_objective_match_jax(name, N):
    jm, tm, Z, sp, shared, tZ, tsp, tsh = _pair(name, N, t=0.47, seed=4)
    l, u = jm.trans.bounds(sp, shared)
    tl, tu = tm.trans.bounds(tsp, tsh)
    _close(tl[0], l, "l")
    _close(tu[0], u, "u")
    _close(tm.trans.evaluate(tZ, tsp, tsh)[0],
           jm.trans.evaluate(Z, sp, shared), "evaluate")
    obj = jm.trans.objective_data(shared)
    tobj = tm.trans.objective_data(tsh)
    _close(tm.trans.objective_value(tZ, tobj)[0],
           jm.trans.objective_value(Z, obj), "objective")
    _close(tm.trans.objective_gradient(tZ, tobj)[0],
           jm.trans.objective_gradient(Z, obj), "gradient")
    _close(tm.trans.hessian_diag(tobj)[0], jm.trans.hessian_diag(obj),
           "hessian")


def test_linearize_g_matches_evaluate():
    """The linearization's closed-form row values equal the full stage
    residual (the two row-value paths of the transcription)."""
    jm, tm, Z, sp, shared, tZ, tsp, tsh = _pair("B2G", 4, t=0.31, seed=5)
    g = tm.trans.linearize(tZ, tsp, tsh)[0]
    _close(g, tm.trans.evaluate(tZ, tsp, tsh))
