"""Robot model: the static description of a robot, built from a JSON spec.

PyTorch counterpart of ``RobotModel`` and ``model_from_dict`` in
``tpu_locoman/model.py``. The spec arrays load as float64 numpy (as in the
JAX package); the rigid-body code reads them as float32 tensors on the
device it runs on (``RobotModel.tensors``), the counterpart of
``RobotModel.jnp_arrays``. ``model_to_dict`` / ``model_from_dict`` are
the JSON spec format; the URDF/SRDF parser is ``tpu_locoman_torch.urdf``.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

GRAVITY = 9.81


@dataclass
class FrameHost:
    name: str
    parent_joint: int  # movable-joint index (0 = free-flyer base)
    R: np.ndarray  # placement in the parent joint frame
    p: np.ndarray


@dataclass
class RobotModel:
    """Movable joint 0 is the floating base; joints 1..n_links-1 are
    revolute. All arrays are indexed by movable-joint index. ``base_type``
    is the base chart: "freeflyer" (q_base = [p, quat], the local twist as
    velocity) or "euler_zyx" (q_base = [p, rz ry rx] and their rates, a
    vector space)."""

    name: str
    parent: tuple
    joint_names: tuple
    R_tree: np.ndarray  # (n, 3, 3)
    p_tree: np.ndarray  # (n, 3)
    axis: np.ndarray  # (n, 3)
    mass: np.ndarray  # (n,)
    com: np.ndarray  # (n, 3)
    inertia: np.ndarray  # (n, 3, 3)
    frames: dict = field(default_factory=dict)
    reference_configurations: dict = field(default_factory=dict)
    base_type: str = "freeflyer"

    @property
    def n_links(self):
        return len(self.parent)

    @property
    def nj(self):
        return self.n_links - 1

    @property
    def base_nq(self):
        return 7 if self.base_type == "freeflyer" else 6

    @property
    def nq(self):
        return self.base_nq + self.nj

    @property
    def nv(self):
        return 6 + self.nj

    @property
    def total_mass(self):
        return float(np.sum(self.mass))

    def ancestry_mask(self):
        """(n_links, nv) 0/1 float32: dof j moves link i."""
        n = self.n_links
        anc = np.zeros((n, self.nv), dtype=np.float32)
        anc[:, :6] = 1.0
        for i in range(1, n):
            j = i
            while j != 0:
                anc[i, 6 + j - 1] = 1.0
                j = self.parent[j]
        return anc

    def dof_link(self):
        """(nv,) link carrying each dof (base dofs -> link 0)."""
        return np.array([0] * 6 + list(range(1, self.n_links)), dtype=np.int64)

    def tensors(self, device):
        """Float32 copies of the numeric arrays on ``device`` (cached), and
        the tree's index constants, so that no call copies from the host:
        ``dof_link`` (nv,) int64, ``DM`` = ``anc[dof_link]`` (nv, nv) and
        the spatial gravity acceleration ``g_spatial`` (6,)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_tensor_cache", {})
        key = str(device)
        if key not in cache:
            f32 = lambda x: torch.as_tensor(  # noqa: E731
                np.asarray(x, dtype=np.float32), device=device)
            skews = []
            for ax in np.asarray(self.axis, dtype=np.float32):
                x, y, z = ax
                skews.append(np.array([[0.0, -z, y], [z, 0.0, -x],
                                       [-y, x, 0.0]], dtype=np.float32))
            K = f32(np.stack(skews))
            cache[key] = {
                "R_tree": f32(self.R_tree),
                "p_tree": f32(self.p_tree),
                "axis": f32(self.axis),
                "mass": f32(self.mass),
                "com": f32(self.com),
                "inertia": f32(self.inertia),
                "axis_skew": K,
                "axis_skew2": K @ K,
                "anc": f32(self.ancestry_mask()),
                "dof_link": torch.as_tensor(self.dof_link(), device=device),
                "DM": f32(self.ancestry_mask()[self.dof_link()]),
                "g_spatial": f32([0.0, 0.0, GRAVITY, 0.0, 0.0, 0.0]),
            }
        return cache[key]


def model_to_dict(model):
    """The JSON spec of a model (plain lists), as ``model_from_dict`` and
    the JAX package's ``model_from_dict`` read it."""
    return {
        "name": model.name,
        "parent": list(model.parent),
        "joint_names": list(model.joint_names),
        "R_tree": model.R_tree.tolist(),
        "p_tree": model.p_tree.tolist(),
        "axis": model.axis.tolist(),
        "mass": model.mass.tolist(),
        "com": model.com.tolist(),
        "inertia": model.inertia.tolist(),
        "frames": {
            name: {"parent_joint": fr.parent_joint, "R": fr.R.tolist(),
                   "p": fr.p.tolist()}
            for name, fr in model.frames.items()
        },
        "reference_configurations": {
            k: v.tolist() for k, v in model.reference_configurations.items()
        },
    }


def model_from_dict(d):
    return RobotModel(
        name=d["name"],
        parent=tuple(d["parent"]),
        joint_names=tuple(d["joint_names"]),
        R_tree=np.asarray(d["R_tree"]),
        p_tree=np.asarray(d["p_tree"]),
        axis=np.asarray(d["axis"]),
        mass=np.asarray(d["mass"]),
        com=np.asarray(d["com"]),
        inertia=np.asarray(d["inertia"]),
        frames={
            name: FrameHost(name, f["parent_joint"], np.asarray(f["R"]),
                            np.asarray(f["p"]))
            for name, f in d["frames"].items()
        },
        reference_configurations={
            k: np.asarray(v) for k, v in d["reference_configurations"].items()
        },
    )
