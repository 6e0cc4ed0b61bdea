"""Robot models from URDF/SRDF: a first-party parser, host-side numpy and
``xml.etree`` only.

Port of the model builder in ``tpu_locoman/model.py``: the movable joints
(a free-flyer base and the revolute joints) in depth-first document order,
fixed joints merged into their parent body (inertia composed) and kept as
named frames, as Pinocchio's ``BuildFromURDF`` does; the SRDF's
``group_state`` reference configurations; and the locked-joint reduction
of ``buildReducedRobot``. The result is the port's ``RobotModel``, which
``model.model_to_dict`` writes as a JSON spec.

    model = parse_urdf("robot.urdf")
    model = build_reduced_model(model, [lock_ids], q_neutral)
    load_srdf_reference_configurations(model, "robot.srdf")
"""

import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

from .model import FrameHost, RobotModel


def rpy_to_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _axis_angle_matrix(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _compose(Ra, pa, Rb, pb):
    """T_a * T_b for transforms (R, p)."""
    return Ra @ Rb, Ra @ pb + pa


@dataclass
class SpatialInertiaHost:
    """Inertia of one body in its joint frame: mass, CoM offset com (3,)
    and the rotational inertia inertia_com (3, 3) about the CoM."""

    mass: float
    com: np.ndarray
    inertia_com: np.ndarray

    @staticmethod
    def zero():
        return SpatialInertiaHost(0.0, np.zeros(3), np.zeros((3, 3)))

    def transformed(self, R, p):
        """The same body in a frame F where this inertia's frame sits at
        T_FB = (R, p)."""
        return SpatialInertiaHost(self.mass, R @ self.com + p,
                                  R @ self.inertia_com @ R.T)

    def __add__(self, other):
        m = self.mass + other.mass
        if m <= 0.0:
            return SpatialInertiaHost.zero()
        c = (self.mass * self.com + other.mass * other.com) / m

        def about(inert, new_c):
            d = inert.com - new_c
            # parallel axis: I_c = I_com + m (|d|^2 I - d d^T)
            return inert.inertia_com + inert.mass * (
                np.dot(d, d) * np.eye(3) - np.outer(d, d))

        return SpatialInertiaHost(m, c, about(self, c) + about(other, c))


def _parse_origin(elem):
    R = np.eye(3)
    p = np.zeros(3)
    if elem is not None:
        origin = elem.find("origin")
        if origin is not None:
            xyz = origin.get("xyz")
            rpy = origin.get("rpy")
            if xyz:
                p = np.array([float(v) for v in xyz.split()])
            if rpy:
                R = rpy_to_matrix([float(v) for v in rpy.split()])
    return R, p


def _parse_inertial(link_elem):
    inertial = link_elem.find("inertial")
    if inertial is None:
        return SpatialInertiaHost.zero()
    mass = float(inertial.find("mass").get("value"))
    R, p = _parse_origin(inertial)
    ie = inertial.find("inertia")
    ixx, iyy, izz = (float(ie.get(k)) for k in ("ixx", "iyy", "izz"))
    ixy, ixz, iyz = (float(ie.get(k, 0.0)) for k in ("ixy", "ixz", "iyz"))
    I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    # URDF: the inertia is about the CoM, in the inertial origin's frame
    return SpatialInertiaHost(mass, p, R @ I_local @ R.T)


def parse_urdf(urdf_path, root_link=None):
    """A RobotModel with a free-flyer root joint from a URDF: joints added
    depth-first in document order, fixed joints collapsed into their
    parent movable joint's body (and kept as frames, as is each child
    link), revolute and continuous joints as 1-DoF revolute joints."""
    robot = ET.parse(urdf_path).getroot()
    name = robot.get("name", "robot")
    links = {ln.get("name"): ln for ln in robot.findall("link")}
    children, child_of = {}, {}
    for j in robot.findall("joint"):
        children.setdefault(j.find("parent").get("link"), []).append(j)
        child_of[j.find("child").get("link")] = j
    if root_link is None:
        roots = [ln for ln in links if ln not in child_of]
        if len(roots) != 1:
            raise ValueError(f"expected a unique root link, got {roots}")
        root_link = roots[0]

    parent_idx = [-1]
    joint_names = ["root_joint"]
    R_tree, p_tree, axes = [np.eye(3)], [np.zeros(3)], [np.zeros(3)]
    inertias = [_parse_inertial(links[root_link])]
    frames = {root_link: FrameHost(root_link, 0, np.eye(3), np.zeros(3))}

    def add_subtree(link_name, movable_idx, R_acc, p_acc):
        """Walk the children of link_name, whose frame sits at (R_acc,
        p_acc) in the frame of movable joint movable_idx."""
        for j in children.get(link_name, []):
            jtype, jname = j.get("type"), j.get("name")
            child_link = j.find("child").get("link")
            Rj, pj = _parse_origin(j)
            R_cj, p_cj = _compose(R_acc, p_acc, Rj, pj)
            if jtype == "fixed":
                inertias[movable_idx] += _parse_inertial(
                    links[child_link]).transformed(R_cj, p_cj)
                frames[jname] = FrameHost(jname, movable_idx, R_cj, p_cj)
                frames[child_link] = FrameHost(child_link, movable_idx, R_cj,
                                               p_cj)
                add_subtree(child_link, movable_idx, R_cj, p_cj)
            elif jtype in ("revolute", "continuous"):
                axis_elem = j.find("axis")
                axis = (np.array([float(v) for v in
                                  axis_elem.get("xyz").split()])
                        if axis_elem is not None else np.array([1.0, 0, 0]))
                idx = len(parent_idx)
                parent_idx.append(movable_idx)
                joint_names.append(jname)
                R_tree.append(R_cj)
                p_tree.append(p_cj)
                axes.append(axis)
                inertias.append(_parse_inertial(links[child_link]))
                frames[child_link] = FrameHost(child_link, idx, np.eye(3),
                                               np.zeros(3))
                add_subtree(child_link, idx, np.eye(3), np.zeros(3))
            else:
                raise NotImplementedError(f"joint type {jtype} ({jname})")

    add_subtree(root_link, 0, np.eye(3), np.zeros(3))
    return RobotModel(
        name=name, parent=tuple(parent_idx), joint_names=tuple(joint_names),
        R_tree=np.stack(R_tree), p_tree=np.stack(p_tree), axis=np.stack(axes),
        mass=np.array([s.mass for s in inertias]),
        com=np.stack([s.com for s in inertias]),
        inertia=np.stack([s.inertia_com for s in inertias]), frames=frames)


def load_srdf_reference_configurations(model, srdf_path):
    """Fill model.reference_configurations from the SRDF's group_state
    tags (as pin.loadReferenceConfigurations): the identity base
    quaternion (x, y, z, w) unless root_joint is given; joints absent from
    a reduced model are skipped."""
    for gs in ET.parse(srdf_path).getroot().findall(".//group_state"):
        q = np.zeros(model.nq)
        q[6] = 1.0
        for js in gs.findall("joint"):
            jn = js.get("name")
            vals = np.array([float(v) for v in js.get("value").split()])
            if jn == "root_joint":
                q[:7] = vals
            elif jn in model.joint_names:
                q[7 + model.joint_names.index(jn) - 1] = vals[0]
        model.reference_configurations[gs.get("name")] = q
    return model


def build_reduced_model(model, lock_joint_ids, q_ref):
    """Lock the given joints at their q_ref values (as
    pin.buildReducedRobot). lock_joint_ids follow Pinocchio's numbering:
    1 is the free-flyer, 2.. the revolute joints in order (movable index +
    1). Each locked body merges into its nearest kept ancestor; frames and
    child joints are re-parented with the composed placements."""
    lock_movable = sorted(i - 1 for i in lock_joint_ids)
    if not all(1 <= i < model.n_links for i in lock_movable):
        raise ValueError(f"lock_joint_ids {list(lock_joint_ids)} must name "
                         f"revolute joints 2..{model.n_links}")
    locked = set(lock_movable)
    new_index = {}
    for i in range(model.n_links):
        if i not in locked:
            new_index[i] = len(new_index)
    # each old joint frame in its nearest kept ancestor's frame, in
    # topological order (parents before children)
    anchor = {}
    inertias = [SpatialInertiaHost(model.mass[i], model.com[i].copy(),
                                   model.inertia[i].copy())
                for i in range(model.n_links)]
    kept_inertia = {i: inertias[i] for i in range(model.n_links)
                    if i not in locked}
    R_tree = [None] * model.n_links
    p_tree = [None] * model.n_links
    for i in range(model.n_links):
        if i == 0:
            anchor[0] = (0, np.eye(3), np.zeros(3))
            R_tree[0], p_tree[0] = np.eye(3), np.zeros(3)
            continue
        a_par, Rp, pp = anchor[model.parent[i]]
        R_aj, p_aj = _compose(Rp, pp, model.R_tree[i], model.p_tree[i])
        if i in locked:
            R_lock = _axis_angle_matrix(model.axis[i], q_ref[7 + i - 1])
            R_cfg, p_cfg = _compose(R_aj, p_aj, R_lock, np.zeros(3))
            anchor[i] = (a_par, R_cfg, p_cfg)
            kept_inertia[a_par] += inertias[i].transformed(R_cfg, p_cfg)
        else:
            anchor[i] = (i, np.eye(3), np.zeros(3))
            R_tree[i], p_tree[i] = R_aj, p_aj

    new_frames = {}
    for fname, fr in model.frames.items():
        a, Ra, pa = anchor[fr.parent_joint]
        Rf, pf = _compose(Ra, pa, fr.R, fr.p)
        new_frames[fname] = FrameHost(fname, new_index[a], Rf, pf)

    kept = [i for i in range(model.n_links) if i not in locked]
    reduced = RobotModel(
        name=model.name,
        parent=tuple(-1 if i == 0 else new_index[anchor[model.parent[i]][0]]
                     for i in kept),
        joint_names=tuple(model.joint_names[i] for i in kept),
        R_tree=np.stack([R_tree[i] for i in kept]),
        p_tree=np.stack([p_tree[i] for i in kept]),
        axis=np.stack([model.axis[i] for i in kept]),
        mass=np.array([kept_inertia[i].mass for i in kept]),
        com=np.stack([kept_inertia[i].com for i in kept]),
        inertia=np.stack([kept_inertia[i].inertia_com for i in kept]),
        frames=new_frames)
    # reference configurations lose the locked joints' entries
    keep_q = list(range(7)) + [7 + i - 1 for i in kept[1:]]
    for rname, q in model.reference_configurations.items():
        reduced.reference_configurations[rname] = q[keep_q]
    return reduced
