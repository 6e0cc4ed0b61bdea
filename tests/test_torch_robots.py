"""The port's other robots and its URDF/SRDF model builder against
tpu_locoman: B2 with no payload, a front and a rear payload, B2G with the
whole arm locked, each robot's dims, limits, frames and mass, one batched
linearize at N=3, and a small URDF/SRDF (written here: the repo holds none)
parsed, reduced and serialized by both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpu_locoman as J  # noqa: E402
from tpu_locoman import model as jmodel  # noqa: E402
import tpu_locoman_torch as T  # noqa: E402
from tpu_locoman_torch import model as tmodel  # noqa: E402
from tpu_locoman_torch import urdf  # noqa: E402

ROBOTS = [("B2", {}), ("B2", {"payload": "front"}),
          ("B2", {"payload": "rear"}), ("B2G", {"ignore_arm": True})]
ATTRS = ("nq", "nv", "nj", "nf", "mass", "ext_force_frame", "arm_ee_frame",
         "base_frame", "FOOT_FRAMES")
LIMITS = ("joint_pos_min", "joint_pos_max", "joint_vel_max",
          "joint_torque_max", "q0")


@pytest.mark.parametrize("name,kw", ROBOTS)
def test_robot_matches_jax(name, kw):
    """Exact: the same spec file and the same constants."""
    jr, tr = getattr(J, name)(**kw), getattr(T, name)(**kw)
    for a in ATTRS:
        assert getattr(tr, a) == getattr(jr, a), a
    for a in LIMITS:
        np.testing.assert_array_equal(getattr(tr, a), getattr(jr, a), a)
    assert tmodel.model_to_dict(tr.model) == jmodel.model_to_dict(jr.model)
    if tr.ext_force_frame:
        assert tr.ext_force_frame in tr.model.frames


def test_b2_rejects_an_unknown_payload():
    with pytest.raises(ValueError, match="payload"):
        T.B2(payload="side")


@pytest.mark.parametrize("name,kw", [("B2", {"payload": "front"}),
                                     ("B2G", {"ignore_arm": True})])
def test_batched_linearize_matches_jax(name, kw):
    """One linearize at N=3 for a batch of two warm-started iterates with
    seeded noise (trot, t = 0.13), the port batched against JAX per
    scenario. As tests/test_torch_transcribe.py: the same analytic
    Jacobians in f32, atol 1e-4*(max|ref|+1) per quantity."""
    N, t = 3, 0.13
    jr, tr = getattr(J, name)(**kw), getattr(T, name)(**kw)
    for r in (jr, tr):
        r.set_gait_sequence("trot", 0.8)
    jm = J.MPC(jr, dynamics="whole_body_rnea", nodes=N)
    tm = T.MPC(tr, dynamics="whole_body_rnea", nodes=N, device="cpu")
    carry = jm.init_carry()
    vel = jnp.array([0.2, 0.0, 0.0, 0.0, 0.0, 0.1])
    shared = jm.make_shared(carry.x_init, vel, tau_prev=carry.tau_prev)
    sp = jm.make_stage_params(jnp.float32(t))
    Z0 = jm.warm_start_Z(carry.solver_state.Z, sp, shared)
    rng = np.random.default_rng(5)
    Zs = [Z0 + jnp.asarray(rng.normal(size=Z0.shape) * 0.02, jnp.float32)
          for _ in range(2)]
    lin = jax.jit(jm.trans.linearize)
    refs = [lin(Z, sp, shared) for Z in Zs]
    tsp = tm.make_stage_params(torch.full((2,), t))
    tsh = tm.make_shared(torch.tensor(np.asarray(carry.x_init)).expand(2, -1),
                         torch.tensor(np.asarray(vel)))
    out = tm.trans.linearize(torch.tensor(np.stack(Zs)), tsp, tsh)
    for label, o, *rs in zip(("g", "G", "B", "C"), out, *refs):
        for b, r in enumerate(rs):
            r = np.asarray(r)
            assert tuple(o.shape[1:]) == r.shape, label
            np.testing.assert_allclose(o[b].numpy(), r,
                                       atol=1e-4 * (np.abs(r).max() + 1),
                                       err_msg=f"{label}, scenario {b}")


_URDF = """<?xml version="1.0"?>
<robot name="tiny">
  <link name="base">
    <inertial><origin xyz="0.01 0 0.02" rpy="0 0 0.1"/><mass value="5.0"/>
      <inertia ixx="0.1" ixy="0.001" ixz="0" iyy="0.2" iyz="0.002"
               izz="0.25"/></inertial>
  </link>
  <link name="imu"><inertial><mass value="0.3"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001"/></inertial></link>
  <link name="thigh">
    <inertial><origin xyz="0 0.02 -0.1" rpy="0.2 0 0"/><mass value="1.2"/>
      <inertia ixx="0.02" ixy="0" ixz="0.001" iyy="0.021" iyz="0"
               izz="0.003"/></inertial>
  </link>
  <link name="calf">
    <inertial><origin xyz="0 0 -0.12"/><mass value="0.4"/>
      <inertia ixx="0.005" iyy="0.005" izz="0.0004"/></inertial>
  </link>
  <link name="foot"><inertial><mass value="0.05"/>
      <inertia ixx="1e-5" iyy="1e-5" izz="1e-5"/></inertial></link>
  <link name="tail">
    <inertial><origin xyz="-0.1 0 0"/><mass value="0.2"/>
      <inertia ixx="1e-4" iyy="2e-4" izz="2e-4"/></inertial>
  </link>
  <joint name="imu_joint" type="fixed">
    <parent link="base"/><child link="imu"/>
    <origin xyz="0.05 0 0.03" rpy="0 0.1 0"/>
  </joint>
  <joint name="hip_joint" type="revolute">
    <parent link="base"/><child link="thigh"/>
    <origin xyz="0.2 0.1 0" rpy="0.1 0 -0.2"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="knee_joint" type="revolute">
    <parent link="thigh"/><child link="calf"/>
    <origin xyz="0 0 -0.25"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="foot_joint" type="fixed">
    <parent link="calf"/><child link="foot"/><origin xyz="0 0 -0.25"/>
  </joint>
  <joint name="tail_joint" type="continuous">
    <parent link="base"/><child link="tail"/>
    <origin xyz="-0.3 0 0.05"/><axis xyz="0 0.6 0.8"/>
  </joint>
</robot>
"""

_SRDF = """<?xml version="1.0"?>
<robot name="tiny">
  <group_state name="home" group="all">
    <joint name="root_joint" value="0 0 0.4 0 0 0 1"/>
    <joint name="hip_joint" value="0.7"/>
    <joint name="knee_joint" value="-1.3"/>
    <joint name="tail_joint" value="0.25"/>
  </group_state>
  <group_state name="folded" group="all">
    <joint name="knee_joint" value="-2.1"/>
  </group_state>
</robot>
"""


def _dicts_close(out, ref, path=""):
    """Equal structure and names, numbers within 1e-12."""
    if isinstance(ref, dict):
        assert set(out) == set(ref), path
        for k in ref:
            _dicts_close(out[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list) and ref and isinstance(ref[0], str):
        assert out == ref, path
    elif isinstance(ref, (list, float, int)):
        np.testing.assert_allclose(np.asarray(out, float),
                                   np.asarray(ref, float), rtol=0,
                                   atol=1e-12, err_msg=path)
    else:
        assert out == ref, path


def test_urdf_parse_and_reduce_match_jax(tmp_path):
    """A floating base with a fixed IMU frame, a two-joint leg with a fixed
    foot frame and a continuous tail: parsed, given the SRDF's reference
    configurations and reduced with the knee locked at the "home"
    configuration (Pinocchio id 3), then the SRDF loaded into the reduced
    model, as the JAX package builds a robot from its URDF. Both packages'
    model_to_dict agree within 1e-12 (the same float64 arithmetic)."""
    u, s = tmp_path / "tiny.urdf", tmp_path / "tiny.srdf"
    u.write_text(_URDF)
    s.write_text(_SRDF)
    models = {}
    for name, mod in (("jax", jmodel), ("port", urdf)):
        full = mod.parse_urdf(str(u))
        mod.load_srdf_reference_configurations(full, str(s))
        red = mod.build_reduced_model(full, [3],
                                      full.reference_configurations["home"])
        mod.load_srdf_reference_configurations(red, str(s))
        models[name] = (full, red)
    (jf, jred), (tf, tred) = models["jax"], models["port"]
    assert tf.joint_names == ("root_joint", "hip_joint", "knee_joint",
                              "tail_joint")
    assert tred.joint_names == ("root_joint", "hip_joint", "tail_joint")
    assert tf.frames["foot"].parent_joint == 2
    assert tred.frames["foot"].parent_joint == 1  # re-parented to the hip
    assert tf.frames["imu_joint"].parent_joint == 0
    np.testing.assert_allclose(tf.total_mass, 7.15, rtol=1e-12)
    np.testing.assert_allclose(tred.total_mass, 7.15, rtol=1e-12)
    _dicts_close(tmodel.model_to_dict(tf), jmodel.model_to_dict(jf))
    _dicts_close(tmodel.model_to_dict(tred), jmodel.model_to_dict(jred))
    # the spec round trip, as the robots load their JSON specs
    back = tmodel.model_from_dict(tmodel.model_to_dict(tred))
    assert tmodel.model_to_dict(back) == tmodel.model_to_dict(tred)
