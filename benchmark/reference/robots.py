"""Robot definitions (Go2, B2, B2G + Z1 arm) built from the JSON specs
in ``specs/`` beside this file; a robot without a spec is refused."""

import dataclasses
import json
import os

import numpy as np

from .gait import GaitSequence
from .model import RobotModel, model_from_dict  # noqa: F401  (re-exported)

SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs")


def load_spec(spec_name):
    """The model of ``specs/<spec_name>.json``, or None if it is absent."""
    path = os.path.join(SPEC_DIR, spec_name + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return model_from_dict(json.load(f))


def _build_from_urdf(urdf_rel, srdf_rel, lock_joints=None):
    raise FileNotFoundError(f"the reference has no spec for {urdf_rel}")


def _quat_to_euler_zyx_np(q):
    """Host-side (x, y, z, w) quaternion -> ZYX Euler angles."""
    x, y, z, w = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    ry = np.arcsin(-np.clip(R[2, 0], -1, 1))
    rz = np.arctan2(R[1, 0], R[0, 0])
    rx = np.arctan2(R[2, 1], R[2, 2])
    return np.array([rz, ry, rx])


def _to_euler_base(model):
    """The model with the Euler-ZYX base chart, its reference poses
    converted."""
    refs = {
        name: np.concatenate([q[:3], _quat_to_euler_zyx_np(q[3:7]), q[7:]])
        for name, q in model.reference_configurations.items()
    }
    return dataclasses.replace(model, base_type="euler_zyx",
                               reference_configurations=refs)


class Robot:
    """Dims, reference pose, gait attachment and end-effector frames.
    ``use_quaternion=False`` puts the base in the Euler-ZYX chart."""

    FOOT_FRAMES = ["FR_foot", "FL_foot", "RR_foot", "RL_foot"]

    def __init__(self, model, reference_pose, base_frame="base_link",
                 use_quaternion=True):
        if not use_quaternion:
            model = _to_euler_base(model)
        self.model = model
        self.base_frame = base_frame
        if reference_pose and reference_pose in model.reference_configurations:
            self.q0 = np.asarray(model.reference_configurations[reference_pose])
        else:
            base0 = [0, 0, 0, 0, 0, 0, 1] if use_quaternion else [0] * 6
            self.q0 = np.concatenate([base0, np.zeros(model.nj)])
        self.nq = model.nq
        self.nv = model.nv
        self.nj = model.nj
        self.nf = 12  # forces at the four feet
        self.ext_force_frame = None
        self.arm_ee_frame = None
        self.gait_sequence = None

    @property
    def mass(self):
        return self.model.total_mass

    def set_gait_sequence(self, gait_type, gait_period):
        self.gait_sequence = GaitSequence(gait_type, gait_period)
        self.foot_frames = list(self.gait_sequence.feet)


class Go2(Robot):
    """12-DoF Unitree Go2."""

    def __init__(self, reference_pose="standing", use_quaternion=True):
        model = load_spec("go2") or _build_from_urdf(
            "go2_description/urdf/go2.urdf", "go2_description/srdf/go2.srdf")
        super().__init__(model, reference_pose, base_frame="base",
                         use_quaternion=use_quaternion)
        self.joint_pos_min = np.tile([-1.0472, -1.5708, -2.7227], 4)
        self.joint_pos_max = np.tile([1.0472, 3.4907, -0.83776], 4)
        self.joint_vel_max = np.tile([30.1, 30.1, 15.70], 4)
        self.joint_torque_max = np.tile([23.7, 23.7, 45.43], 4)


class B2(Robot):
    """12-DoF Unitree B2, with an optional payload force at the front or
    rear payload frame."""

    def __init__(self, reference_pose="standing", payload=None,
                 use_quaternion=True):
        if payload not in (None, "front", "rear"):
            raise ValueError(f"payload must be None, 'front' or 'rear', got "
                             f"{payload!r}")
        model = load_spec("b2") or _build_from_urdf(
            "b2_description/urdf/b2.urdf", "b2_description/srdf/b2.srdf")
        super().__init__(model, reference_pose, use_quaternion=use_quaternion)
        self.joint_pos_min = np.tile([-0.87, -0.94, -2.82], 4)
        self.joint_pos_max = np.tile([0.87, 4.69, -0.43], 4)
        self.joint_vel_max = np.tile([23.0, 23.0, 14.0], 4)
        self.joint_torque_max = np.tile([200, 200, 320], 4)
        if payload is not None:
            self.ext_force_frame = f"payload_joint_{payload}"
            self.nf += 3


class B2G(Robot):
    """B2 + Z1 arm with the gripper joint locked; ``ignore_arm=True`` locks
    the whole arm (the ``b2g_arm_locked`` spec: no arm limits, no gripper
    force)."""

    def __init__(self, reference_pose="standing_with_arm_up", ignore_arm=False,
                 use_quaternion=True):
        spec, lock = (("b2g_arm_locked", range(14, 21)) if ignore_arm
                      else ("b2g", [20]))
        model = load_spec(spec) or _build_from_urdf(
            "b2g_description/urdf/b2g.urdf", "b2g_description/srdf/b2g.srdf",
            lock_joints=lock)
        super().__init__(model, reference_pose, use_quaternion=use_quaternion)
        self.joint_pos_min = np.tile([-0.87, -0.94, -2.82], 4)
        self.joint_pos_max = np.tile([0.87, 4.69, -0.43], 4)
        self.joint_vel_max = np.tile([23.0, 23.0, 14.0], 4)
        self.joint_torque_max = np.tile([200, 200, 320], 4)
        if ignore_arm:
            return
        self.ext_force_frame = "gripperStator"
        self.arm_ee_frame = "gripperStator"
        self.nf += 3
        self.joint_pos_min = np.concatenate((
            self.joint_pos_min, [-2.62, 0.0, -2.88, -1.52, -1.34, -2.79]))
        self.joint_pos_max = np.concatenate((
            self.joint_pos_max, [2.62, 2.97, 0.0, 1.52, 1.34, 2.79]))
        self.joint_vel_max = np.concatenate((self.joint_vel_max, [3.14] * 6))
        self.joint_torque_max = np.concatenate((
            self.joint_torque_max, [30, 60, 30, 30, 30, 30]))
