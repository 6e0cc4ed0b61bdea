"""The port's rollout entry points against tpu_locoman's: ``MPC.run`` (the
JAX lax.scan rollout), ``MPC.retract`` on its final solution, and
``batched_step(per_scenario_time=True)`` with one clock per scenario.

Go2 whole_body_rnea N=4, the hot config (1 SQP iteration, 10 ADMM sweeps,
corrector 5, 2 line-search trials), JAX factorizer "cholinv". Tolerances
are test_torch_mpc.py's: x atol 1e-3, max_violation 5% relative + 1e-3
absolute, alpha and status equal; retract atol 1e-4 * (max|ref| + 1) (a
decode of the same Z, f32). The JAX side is recorded in
tests/data/torch_mpc_run_jax.npz, which ``JAX_PLATFORMS=cpu python
tests/test_torch_mpc_run.py`` rewrites."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import parallel as jpar  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import convert  # noqa: E402

from test_torch_mpc import _check_tick, _hot  # noqa: E402


# tpu_locoman's side of both tests (_jax_side), written by running this file
# as a script: each JAX rollout compiles for a minute or more on a CPU
RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_mpc_run_jax.npz")
VEL = [0.2, 0, 0, 0, 0, 0.1]
TARGETS = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0]], np.float32)
T0 = np.array([0.05, 0.47], np.float32)
STATS = ("max_violation", "alpha", "status")


def _mpc(mod, factorizer, N=4, **kw):
    robot = mod.Go2()
    robot.set_gait_sequence("trot", 0.8)
    return mod.MPC(robot, dynamics="whole_body_rnea", nodes=N,
                   config=_hot(mod, factorizer), **kw)


def _jax_side():
    """JAX's MPC.run of 4 ticks (its outputs, final carry and the retract
    of its final solution) and two per-scenario-time ticks from
    batched_init, as numpy."""
    jm = _mpc(J, "cholinv")
    jc, jouts = jax.jit(lambda: jm.run(4, jnp.array(VEL)))()
    out = {f"run/{k}": np.asarray(jouts[k]) for k in ("x",) + STATS}
    out["run/Z"] = np.asarray(jc.solver_state.Z)
    out["run/x_init"] = np.asarray(jc.x_init)
    ref = jm.retract(jc.solver_state.Z, jc.x_init)
    out.update({f"retract/{k}": np.asarray(v) for k, v in ref.items()})
    jc = jpar.batched_init(jm, 2)
    c0 = convert.carry_to_numpy(convert.carry_from_numpy(
        jax.device_get(jc), "cpu"))
    out.update({"pst/init/" + k: v for k, v in (
        ("x_init", c0["x_init"]), ("tau_prev", c0["tau_prev"]),
        *c0["solver_state"].items())})
    jstep = jpar.batched_step(jm, donate=False, per_scenario_time=True)
    for k in range(2):
        jc, js = jstep(jc, jnp.asarray(T0 + np.float32(k * 0.01)),
                       jnp.asarray(TARGETS))
        out[f"pst/{k}/x"] = np.asarray(jc.x_init)
        out.update({f"pst/{k}/{n}": np.asarray(js[n]) for n in STATS})
    return out


def _record():
    np.savez_compressed(RECORDED, **_jax_side())
    print("wrote", RECORDED)


def _recorded(prefix):
    with np.load(RECORDED) as d:
        return {k[len(prefix):]: d[k] for k in d.files
                if k.startswith(prefix)}


class _Tick:
    """A recorded JAX tick in the shape _check_tick reads."""

    def __init__(self, rec, k):
        self.x_init = rec[f"{k}/x"]
        self.stats = {n: rec[f"{k}/{n}"] for n in STATS}


def test_run_and_retract_match_jax():
    tm = _mpc(T, "cholinv_pb", device="cpu")
    jouts = _recorded("run/")
    tc, touts = tm.run(4, torch.tensor(VEL), batch=1)
    assert tuple(touts["x"].shape) == (4, 1) + np.shape(jouts["x"])[1:]
    for k in range(4):
        np.testing.assert_allclose(touts["x"][k, 0].numpy(), jouts["x"][k],
                                   atol=1e-3)
        np.testing.assert_allclose(touts["max_violation"][k, 0].numpy(),
                                   jouts["max_violation"][k],
                                   rtol=0.05, atol=1e-3)
        assert float(touts["alpha"][k, 0]) == float(jouts["alpha"][k])
        assert int(touts["status"][k, 0]) == int(jouts["status"][k])

    # retract both sides' decode of the JAX solution from one anchor state
    Z, x0 = jouts["Z"], jouts["x_init"]
    ref = _recorded("retract/")
    out = tm.retract(torch.tensor(Z)[None], torch.tensor(x0)[None])
    assert set(out) == set(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(out[key][0].numpy(), r,
                                   atol=1e-4 * (np.abs(r).max() + 1),
                                   err_msg=key)


def test_per_scenario_time_matches_jax():
    """Two scenarios at two gait phases in one batched tick: one swings the
    FR/RL pair, the other the FL/RR pair."""
    tm = _mpc(T, "cholinv_pb", device="cpu")
    rec = _recorded("pst/")
    tc = convert.carry_from_numpy(
        {"x_init": rec["init/x_init"], "tau_prev": rec["init/tau_prev"],
         "solver_state": {k: rec["init/" + k] for k in ("Z", "z_admm",
                                                         "y_admm")}}, "cpu")
    tstep = T.batched_step(tm, per_scenario_time=True)
    for k in range(2):
        tk = T0 + np.float32(k * 0.01)
        tc, ts = tstep(tc, torch.tensor(tk), torch.tensor(TARGETS))
        ref = _Tick(rec, k)
        _check_tick(k, ref, ref.stats, tc, ts)
    with pytest.raises(ValueError):
        tstep(tc, torch.tensor(0.0), torch.tensor(TARGETS))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _record()
