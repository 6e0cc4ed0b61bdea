"""The port's exported step against the JAX package's exported step, on the
configuration of tests/test_aot.py: Go2 ``centroidal_acc`` N=3, one SQP
iteration of 5 ADMM sweeps, batch 2 in the port (one JAX artifact call per
scenario).

The JAX side is ``tpu_locoman.aot.export_mpc_step`` followed by
``load_artifact`` and one tick from JAX's initial carry at t = 0 with the
two targets below. Exporting and compiling that artifact takes minutes on
the CPU, so its inputs and outputs are a fixture,
tests/data/torch_aot_centroidal_jax.json, which this file writes when run
as a script (``JAX_PLATFORMS=cpu python tests/test_torch_aot_jax.py``).

Bounds: the port's artifact equals the port's eager step within 1e-5 in
x, Z and max_violation (measured: 0), and lies within
tests/test_torch_mpc.py's bounds of JAX's artifact tick (x atol 1e-3,
max_violation 5% + 1e-3): f32 summation orders differ in every product.
The centroidal rows reach the artifact through the reverse-mode
``dyn_linearize`` and ``rbda.dccrba``'s jvp, whose tensor factories a
direct ``torch.export`` would bake in as fake constants."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402

import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import aot, convert  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_aot_centroidal_jax.json")
TARGETS = [[0.2, 0, 0, 0, 0, 0], [0.1, 0, 0, 0, 0, 0.2]]
TOL = 1e-5


def _config(mod):
    return dict(dynamics="centroidal_acc", nodes=3,
                config=mod.SQPConfig(sqp_iters=1,
                                     admm=mod.ADMMConfig(iters=5)))


@pytest.fixture(scope="module")
def exported():
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.5)
    mpc = T.MPC(robot, device="cpu", **_config(T))
    return mpc, aot.load_artifact(aot.export_mpc_step(mpc, len(TARGETS)))


def _jax_carry(fix):
    """The fixture's JAX initial carry, one scenario, as the port's carry
    with a scenario axis of len(TARGETS)."""
    c = fix["carry"]
    B = len(TARGETS)
    tile = lambda x: np.repeat(np.asarray(x, np.float32)[None], B, 0)  # noqa: E731
    return convert.carry_from_numpy(
        {"x_init": tile(c["x_init"]), "tau_prev": tile(c["tau_prev"]),
         "solver_state": {k: tile(c[k]) for k in ("Z", "z_admm", "y_admm")}},
        "cpu")


def test_centroidal_artifact_equals_eager_step(exported):
    mpc, step = exported
    tg = torch.tensor(TARGETS)
    z = torch.zeros(len(TARGETS), 3)
    ca = ce = mpc.init_carry(len(TARGETS))
    for k in range(3):
        t = torch.full((len(TARGETS),), np.float32(k * 0.01))
        ca, viol = step(ca, t, tg, z, z)
        ce, stats = mpc.step(ce, t, tg, z, z)
        for name, a, e in (("x", ca.x_init, ce.x_init),
                           ("Z", ca.solver_state.Z, ce.solver_state.Z),
                           ("max_violation", viol, stats["max_violation"])):
            np.testing.assert_allclose(a.numpy(), e.numpy(), atol=TOL,
                                       err_msg=f"{name}, tick {k}")
    assert not isinstance(ce.x_init, FakeTensor)


def test_centroidal_artifact_holds_k1_and_no_k2(exported):
    """The centroidal rows reach no RNEA: the graph holds the K1 op of the
    factorization and no K2 op."""
    ops = {str(n.target) for n in exported[1].graph.nodes
           if n.op == "call_function"}
    assert "tpu_locoman_torch.chol_inv_node.default" in ops
    assert not any("rnea_derivs" in o for o in ops)


def test_jax_fixture_is_this_configuration():
    with open(FIXTURE) as f:
        fix = json.load(f)
    assert fix["targets"] == TARGETS and "centroidal_acc N=3" in fix["config"]
    robot = T.Go2()
    robot.set_gait_sequence("trot", 0.5)
    mpc = T.MPC(robot, device="cpu", **_config(T))
    c = fix["carry"]
    assert np.shape(c["Z"]) == (mpc.nodes + 1, mpc.trans.s)
    assert np.shape(fix["x"]) == (len(TARGETS), mpc.form.nx)
    assert np.isfinite(fix["max_violation"]).all()


def test_centroidal_artifact_tick_matches_jax_artifact(exported):
    mpc, step = exported
    with open(FIXTURE) as f:
        fix = json.load(f)
    assert fix["targets"] == TARGETS
    carry = _jax_carry(fix)
    np.testing.assert_allclose(carry.x_init[0].numpy(),
                               mpc.init_carry(1).x_init[0].numpy(),
                               atol=1e-6)
    z = torch.zeros(len(TARGETS), 3)
    out, viol = step(carry, torch.zeros(len(TARGETS)), torch.tensor(TARGETS),
                     z, z)
    np.testing.assert_allclose(out.x_init.numpy(), np.asarray(fix["x"]),
                               atol=1e-3)
    np.testing.assert_allclose(viol.numpy(),
                               np.asarray(fix["max_violation"]),
                               rtol=0.05, atol=1e-3)


def _fixture():
    """Export JAX's step, load it, tick once per target: FIXTURE's
    content."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import tpu_locoman as J
    from tpu_locoman.aot import export_mpc_step, load_artifact

    robot = J.Go2()
    robot.set_gait_sequence("trot", 0.5)
    mpc = J.MPC(robot, **_config(J))
    fn = load_artifact(export_mpc_step(mpc))
    carry = mpc.init_carry()
    xs, viols = [], []
    for tg in TARGETS:
        out, viol = fn(carry, jnp.float32(0.0), jnp.asarray(tg, jnp.float32),
                       jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32))
        xs.append(np.asarray(out.x_init).tolist())
        viols.append(float(viol))
    c = jax.device_get(carry)
    fix = {"config": "Go2 centroidal_acc N=3, SQPConfig(sqp_iters=1, "
                     "admm=ADMMConfig(iters=5)); tpu_locoman.aot "
                     "export_mpc_step + load_artifact, one tick at t=0",
           "targets": TARGETS, "x": xs, "max_violation": viols,
           "carry": {"x_init": np.asarray(c.x_init).tolist(),
                     "tau_prev": np.asarray(c.tau_prev).tolist(),
                     **{k: np.asarray(getattr(c.solver_state, k)).tolist()
                        for k in ("Z", "z_admm", "y_admm")}}}
    return fix


def _make_fixture():
    """Write FIXTURE."""
    with open(FIXTURE, "w") as f:
        json.dump(_fixture(), f)
    print("wrote", FIXTURE)


if __name__ == "__main__":
    _make_fixture()
