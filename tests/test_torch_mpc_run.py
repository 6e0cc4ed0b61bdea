"""The port's rollout entry points against tpu_locoman's: ``MPC.run`` (the
JAX lax.scan rollout), ``MPC.retract`` on its final solution, and
``batched_step(per_scenario_time=True)`` with one clock per scenario.

Go2 whole_body_rnea N=4, the hot config (1 SQP iteration, 10 ADMM sweeps,
corrector 5, 2 line-search trials), JAX factorizer "cholinv". Tolerances
are test_torch_mpc.py's: x atol 1e-3, max_violation 5% relative + 1e-3
absolute, alpha and status equal; retract atol 1e-4 * (max|ref| + 1) (a
decode of the same Z, f32)."""

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


def _go2_pair(N=4):
    jrob, trob = J.Go2(), T.Go2()
    jrob.set_gait_sequence("trot", 0.8)
    trob.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jrob, dynamics="whole_body_rnea", nodes=N,
               config=_hot(J, "cholinv"))
    tm = T.MPC(trob, dynamics="whole_body_rnea", nodes=N,
               config=_hot(T, "cholinv_pb"), device="cpu")
    return jm, tm


def test_run_and_retract_match_jax():
    jm, tm = _go2_pair()
    vel = [0.2, 0, 0, 0, 0, 0.1]
    jc, jouts = jax.jit(lambda: jm.run(4, jnp.array(vel)))()
    tc, touts = tm.run(4, torch.tensor(vel), batch=1)
    assert tuple(touts["x"].shape) == (4, 1) + np.shape(jouts["x"])[1:]
    for k in range(4):
        np.testing.assert_allclose(touts["x"][k, 0].numpy(),
                                   np.asarray(jouts["x"][k]), atol=1e-3)
        np.testing.assert_allclose(touts["max_violation"][k, 0].numpy(),
                                   np.asarray(jouts["max_violation"][k]),
                                   rtol=0.05, atol=1e-3)
        assert float(touts["alpha"][k, 0]) == float(jouts["alpha"][k])
        assert int(touts["status"][k, 0]) == int(jouts["status"][k])

    # retract both sides' decode of the JAX solution from one anchor state
    Z = np.asarray(jc.solver_state.Z)
    x0 = np.asarray(jc.x_init)
    ref = jm.retract(jnp.asarray(Z), jnp.asarray(x0))
    out = tm.retract(torch.tensor(Z)[None], torch.tensor(x0)[None])
    assert set(out) == set(ref)
    for key, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(out[key][0].numpy(), r,
                                   atol=1e-4 * (np.abs(r).max() + 1),
                                   err_msg=key)


def test_per_scenario_time_matches_jax():
    """Two scenarios at two gait phases in one batched tick: one swings the
    FR/RL pair, the other the FL/RR pair."""
    jm, tm = _go2_pair()
    targets = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0]],
                       np.float32)
    t = np.array([0.05, 0.47], np.float32)
    jc = jpar.batched_init(jm, 2)
    tc = convert.carry_from_numpy(jax.device_get(jc), "cpu")
    jstep = jpar.batched_step(jm, donate=False, per_scenario_time=True)
    tstep = T.batched_step(tm, per_scenario_time=True)
    for k in range(2):
        tk = t + np.float32(k * 0.01)
        jc, js = jstep(jc, jnp.asarray(tk), jnp.asarray(targets))
        tc, ts = tstep(tc, torch.tensor(tk), torch.tensor(targets))
        _check_tick(k, jc, js, tc, ts)
    with pytest.raises(ValueError):
        tstep(tc, torch.tensor(0.0), torch.tensor(targets))
