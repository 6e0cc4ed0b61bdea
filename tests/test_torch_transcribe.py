"""The port's split linearization, bounds and objective against
tpu_locoman's Transcription on the same iterate: B2G N=4 (arm EE and
external-force rows) and Go2 N=6, at a warm-started Z plus seeded noise
with mixed contact/swing nodes.

Tolerance: atol 1e-4 * (max|ref| + 1) per quantity. Both sides compute the
same analytic Jacobians in f32 (the port composes them by hand, JAX by AD
through custom JVPs); RNEA rows reach ~1e5 in g and ~1e2 in G. JAX's side
is recorded in tests/data/torch_transcribe_jax.npz, which
``JAX_PLATFORMS=cpu python tests/test_torch_transcribe.py`` rewrites."""

import os

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


# tpu_locoman's side of every comparison (_jax_side), written by running this
# file as a script: the jitted linearize compiles for up to a minute per
# case on a CPU and the rest runs op by op
RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_transcribe_jax.npz")
VEL = [0.2, 0.0, 0.0, 0.0, 0.0, 0.1]
# (label, robot, N, t, seed) of each recorded iterate
POINTS = [("lin", "B2G", 4, 0.13, 3), ("lin", "Go2", 6, 0.13, 3),
          ("bounds", "B2G", 4, 0.47, 4), ("bounds", "Go2", 6, 0.47, 4),
          ("g", "B2G", 4, 0.31, 5)]


def _jax_side(kind, name, N, t, seed):
    """JAX's MPC of a case, one warm-started iterate plus seeded noise at
    time t (mixed contact and swing nodes), and what the tests compare
    there, as numpy."""
    jrob = getattr(J, name)()
    jrob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=N)
    carry = jm.init_carry()
    shared = jm.make_shared(carry.x_init, jnp.array(VEL),
                            tau_prev=carry.tau_prev)
    sp = jm.make_stage_params(jnp.float32(t))
    rng = np.random.default_rng(seed)
    Z = jm.warm_start_Z(carry.solver_state.Z, sp, shared)
    Z = Z + jnp.asarray(rng.normal(size=Z.shape) * 0.02, dtype=jnp.float32)
    out = {"Z": Z, "x_init": carry.x_init, "init_Z": carry.solver_state.Z}
    out.update({f"sp/{k}": v for k, v in jax.device_get(sp)._asdict().items()})
    out.update({f"shared/{k}": v
                for k, v in jax.device_get(shared)._asdict().items()})
    if kind == "bounds":
        l, u = jm.trans.bounds(sp, shared)
        obj = jm.trans.objective_data(shared)
        out.update(l=l, u=u, evaluate=jm.trans.evaluate(Z, sp, shared),
                   objective=jm.trans.objective_value(Z, obj),
                   gradient=jm.trans.objective_gradient(Z, obj),
                   hessian=jm.trans.hessian_diag(obj))
    elif kind == "lin":
        out.update(zip(("g", "G", "B", "C"),
                       jax.jit(jm.trans.linearize)(Z, sp, shared)))
    return {k: np.asarray(v) for k, v in out.items()}


def _recording():
    """_jax_side at every point, as RECORDED holds it."""
    return {f"{p[0]}/{p[1]}/{k}": v for p in POINTS
            for k, v in _jax_side(*p).items()}


def _record():
    np.savez_compressed(RECORDED, **_recording())
    print("wrote", RECORDED)


def _pair(label, name, N, t):
    """(JAX's recorded arrays, the port's MPC, Z, stage and shared
    parameters) at a recorded iterate."""
    with np.load(RECORDED) as d:
        key = f"{label}/{name}/"
        rec = {k[len(key):]: d[k] for k in d.files if k.startswith(key)}
    trob = getattr(T, name)()
    trob.set_gait_sequence("trot", 0.8)
    tm = T.MPC(trob, dynamics="whole_body_rnea", nodes=N, device="cpu")
    tsp = tm.make_stage_params(torch.tensor([t], dtype=torch.float32))
    tsh = tm.make_shared(torch.tensor(rec["x_init"])[None],
                         torch.tensor(VEL))
    return rec, tm, torch.tensor(rec["Z"])[None], tsp, tsh


@pytest.mark.parametrize("name,N", CASES)
def test_stage_and_shared_params_match(name, N):
    rec, tm, tZ, tsp, tsh = _pair("lin", name, N, 0.13)
    jsp = convert.stage_params_from_numpy(
        {k: rec[f"sp/{k}"] for k in tsp._fields}, "cpu", batch=1)
    for k in jsp._fields:
        _close(getattr(tsp, k), getattr(jsp, k), err_msg=k)
    jsh = convert.shared_from_numpy(
        {k: rec[f"shared/{k}"] for k in tsh._fields}, "cpu")
    for k in jsh._fields:
        _close(getattr(tsh, k), getattr(jsh, k), err_msg=k)
    _close(tm.init_carry(1).solver_state.Z[0], rec["init_Z"],
           err_msg="warm start")


@pytest.mark.parametrize("name,N", CASES)
def test_linearize_matches_jax(name, N):
    rec, tm, tZ, tsp, tsh = _pair("lin", name, N, 0.13)
    out = tm.trans.linearize(tZ, tsp, tsh)
    for label, o in zip(("g", "G", "B", "C"), out):
        assert tuple(o.shape[1:]) == rec[label].shape, label
        _close(o[0], rec[label], err_msg=label)


@pytest.mark.parametrize("name,N", CASES)
def test_bounds_evaluate_objective_match_jax(name, N):
    rec, tm, tZ, tsp, tsh = _pair("bounds", name, N, 0.47)
    tl, tu = tm.trans.bounds(tsp, tsh)
    _close(tl[0], rec["l"], "l")
    _close(tu[0], rec["u"], "u")
    _close(tm.trans.evaluate(tZ, tsp, tsh)[0], rec["evaluate"], "evaluate")
    tobj = tm.trans.objective_data(tsh)
    _close(tm.trans.objective_value(tZ, tobj)[0], rec["objective"],
           "objective")
    _close(tm.trans.objective_gradient(tZ, tobj)[0], rec["gradient"],
           "gradient")
    _close(tm.trans.hessian_diag(tobj)[0], rec["hessian"], "hessian")


def test_linearize_g_matches_evaluate():
    """The linearization's closed-form row values equal the full stage
    residual (the two row-value paths of the transcription)."""
    _, tm, tZ, tsp, tsh = _pair("g", "B2G", 4, 0.31)
    g = tm.trans.linearize(tZ, tsp, tsh)[0]
    _close(g, tm.trans.evaluate(tZ, tsp, tsh))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _record()
