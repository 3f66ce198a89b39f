"""Floating-base forward kinematics, CoM, Jacobians, centroidal momentum.

PyTorch counterpart of `cmw_tpu/core/kinematics.py`. A robot model is a set
of static numpy arrays (parent indices, joint axes, fixed origin transforms,
link masses and inertias); its tensors are made once per (device, dtype) by
`RobotModel.tensors` and reused on every call. The per-call inputs are
(q [..., nj], base rotation [..., 3, 3], base position [..., 3]); every
function takes any number of leading batch dimensions.

Conventions: mixed-representation twists [linear(world), angular(world)];
joint i rotates child link i+1 about `axis[i]` located at the joint origin.
A `frames` table attaches named frames (soles, chest) to links.

Host side (numpy): `parse_urdf`, `ergocub_approx`, `ergocub_urdf` (the
URDF shipped in `cmw_tpu_torch/models/`), `walk_ready_pose`,
`reference_initial_pose`.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.core import lie
from portbench.reference.core.centroidal import cross


class ModelTensors(NamedTuple):
    """A RobotModel's constant arrays as tensors on one device, in one dtype."""

    parent: torch.Tensor  # [nj] long
    axis: torch.Tensor  # [nj, 3]
    origin_pos: torch.Tensor  # [nj, 3]
    origin_rot: torch.Tensor  # [nj, 3, 3]
    link_mass: torch.Tensor  # [nl]
    link_com: torch.Tensor  # [nl, 3]
    link_inertia: torch.Tensor  # [nl, 3, 3]
    frame_link: torch.Tensor  # [nf] long
    frame_pos: torch.Tensor  # [nf, 3]
    frame_rot: torch.Tensor  # [nf, 3, 3]
    anc: torch.Tensor  # [nl, nj] ancestor matrix


@dataclasses.dataclass(frozen=True, eq=False)
class RobotModel:
    """Static kinematic/inertial description (numpy; hashable by identity)."""

    joint_names: tuple  # nj strings, order = q order
    # tree: link 0 is the floating base. Link i (1..nj) is the child of
    # joint i-1.
    parent: np.ndarray  # [nj] parent LINK index of each joint (0-based)
    axis: np.ndarray  # [nj, 3] joint axis in the joint frame
    origin_pos: np.ndarray  # [nj, 3] joint origin in parent link frame
    origin_rot: np.ndarray  # [nj, 3, 3]
    link_mass: np.ndarray  # [nl = nj+1]
    link_com: np.ndarray  # [nl, 3] com offset in link frame
    link_inertia: np.ndarray  # [nl, 3, 3] rotational inertia about link com
    frame_names: tuple  # named frames (e.g. l_sole)
    frame_link: np.ndarray  # [nf] link index
    frame_pos: np.ndarray  # [nf, 3] offset in link frame
    frame_rot: np.ndarray  # [nf, 3, 3]
    # optional joint limits (URDF <limit lower/upper/velocity>; None when
    # the source carries none)
    q_lim: np.ndarray | None = None  # [nj, 2] (lower, upper) rad
    qd_lim: np.ndarray | None = None  # [nj] rad/s
    _tensors: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @property
    def nj(self):
        return len(self.joint_names)

    @property
    def total_mass(self):
        return float(self.link_mass.sum())

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    def tensors(self, device, dtype) -> ModelTensors:
        """The model's arrays as tensors on `device` in `dtype`, made on the
        first call for that pair and reused after (no copy per call)."""
        key = (torch.device(device), dtype)
        if key not in self._tensors:
            def f(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

            def i(a):
                return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)

            self._tensors[key] = ModelTensors(
                parent=i(self.parent), axis=f(self.axis), origin_pos=f(self.origin_pos),
                origin_rot=f(self.origin_rot), link_mass=f(self.link_mass), link_com=f(self.link_com),
                link_inertia=f(self.link_inertia), frame_link=i(self.frame_link), frame_pos=f(self.frame_pos),
                frame_rot=f(self.frame_rot), anc=f(_ancestor_matrix(self)),
            )
        return self._tensors[key]


def _consts(model: RobotModel, like) -> ModelTensors:
    return model.tensors(like.device, like.dtype)


def fk(model: RobotModel, q, base_rot, base_pos):
    """World pose of every link: (R [..., nl, 3, 3], p [..., nl, 3]).

    The joint rotations come from one batched so3_exp; the chain is then
    walked joint by joint (each link after its parent)."""
    mt = _consts(model, q)
    lead = torch.broadcast_shapes(q.shape[:-1], base_rot.shape[:-2], base_pos.shape[:-1])
    Rj = lie.so3_exp(mt.axis * q[..., :, None])  # [..., nj, 3, 3]
    Rs = [base_rot.expand(lead + (3, 3))]
    ps = [base_pos.expand(lead + (3,))]
    for i in range(model.nj):
        par = int(model.parent[i])
        Rp, pp = Rs[par], ps[par]
        Rs.append(Rp @ mt.origin_rot[i] @ Rj[..., i, :, :])
        ps.append(pp + Rp @ mt.origin_pos[i])
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def frame_poses(model: RobotModel, link_R, link_p):
    """World pose of each named frame given link poses."""
    mt = _consts(model, link_R)
    Rl = link_R[..., mt.frame_link, :, :]
    R = Rl @ mt.frame_rot
    p = link_p[..., mt.frame_link, :] + torch.einsum("...fij,fj->...fi", Rl, mt.frame_pos)
    return R, p


def _link_coms(mt: ModelTensors, link_R, link_p):
    """World CoM of every link [..., nl, 3]."""
    return link_p + torch.einsum("...lij,lj->...li", link_R, mt.link_com)


def com(model: RobotModel, link_R, link_p):
    """World CoM from link poses."""
    mt = _consts(model, link_p)
    return torch.einsum("l,...li->...i", mt.link_mass, _link_coms(mt, link_R, link_p)) / model.total_mass


def _ancestor_matrix(model: RobotModel) -> np.ndarray:
    """[nl, nj] anc[l, j] = 1 if joint j is on the path base->link l."""
    nj = model.nj
    anc = np.zeros((nj + 1, nj))
    for i in range(nj):
        child = i + 1
        anc[child] = anc[int(model.parent[i])]
        anc[child, i] = 1.0
    return anc


def joint_world_axes(model: RobotModel, link_R, link_p):
    """World-frame joint axes [..., nj, 3] and joint origin positions
    (a point on each axis) [..., nj, 3]. Joint i's axis is R_parent @
    origin_rot @ axis: the rotation about the axis leaves it fixed."""
    mt = _consts(model, link_R)
    Rp = link_R[..., mt.parent, :, :]
    axis_w = torch.einsum("...jab,jbc,jc->...ja", Rp, mt.origin_rot, mt.axis)
    pivot = link_p[..., mt.parent, :] + torch.einsum("...jab,jb->...ja", Rp, mt.origin_pos)
    return axis_w, pivot


def _eye(lead, like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(lead + (3, 3))


def frame_jacobian(model: RobotModel, link_R, link_p, frame_idx: int):
    """Mixed-representation [..., 6, 6+nj] Jacobian of a named frame.

    Rows: [linear (world); angular (world)]; columns: [base linear, base
    angular, joint velocities].
    """
    mt = _consts(model, link_R)
    mask = mt.anc[int(model.frame_link[frame_idx])][:, None]  # [nj, 1]
    _, fp = frame_poses(model, link_R, link_p)
    pf = fp[..., frame_idx, :]
    axis_w, pivot = joint_world_axes(model, link_R, link_p)
    Jw = axis_w * mask  # [..., nj, 3] angular columns
    Jv = cross(axis_w, pf[..., None, :] - pivot) * mask  # [..., nj, 3]
    lead = pf.shape[:-1]
    eye = _eye(lead, pf)
    base_lin = torch.cat([eye, -lie.hat(pf - link_p[..., 0, :])], dim=-1)  # [..., 3, 6]
    base_ang = torch.cat([torch.zeros_like(eye), eye], dim=-1)
    Jlin = torch.cat([base_lin, Jv.transpose(-1, -2)], dim=-1)  # [..., 3, 6+nj]
    Jang = torch.cat([base_ang, Jw.transpose(-1, -2)], dim=-1)
    return torch.cat([Jlin, Jang], dim=-2)


def com_jacobian(model: RobotModel, link_R, link_p):
    """[..., 3, 6+nj] world CoM Jacobian (mixed representation)."""
    mt = _consts(model, link_R)
    m = mt.link_mass
    c_world = _link_coms(mt, link_R, link_p)  # [..., nl, 3]
    c = torch.einsum("l,...li->...i", m, c_world) / model.total_mass
    axis_w, pivot = joint_world_axes(model, link_R, link_p)
    # column j: sum_l m_l/M * anc[l,j] * axis_j x (c_l - pivot_j)
    arms = c_world[..., :, None, :] - pivot[..., None, :, :]  # [..., nl, nj, 3]
    cols = cross(axis_w[..., None, :, :], arms)  # [..., nl, nj, 3]
    w = (m[:, None] / model.total_mass) * mt.anc  # [nl, nj]
    Jq = torch.einsum("lj,...ljx->...xj", w, cols)  # [..., 3, nj]
    base = torch.cat([_eye(c.shape[:-1], c), -lie.hat(c - link_p[..., 0, :])], dim=-1)
    return torch.cat([base, Jq], dim=-1)


def link_com_jacobians(model: RobotModel, link_R, link_p):
    """Per-link CoM linear + angular Jacobians, mixed representation.

    Returns (c_world [..., nl, 3], Jv [..., nl, 3, 6+nj], Jw [..., nl, 3, 6+nj])."""
    mt = _consts(model, link_R)
    anc = mt.anc  # [nl, nj]
    nl = anc.shape[0]
    c_world = _link_coms(mt, link_R, link_p)  # [..., nl, 3]
    axis_w, pivot = joint_world_axes(model, link_R, link_p)
    eye3 = _eye(c_world.shape[:-2] + (nl,), c_world)

    # angular: [0 | I | anc * axis]
    Jw_q = anc[:, None, :] * axis_w.transpose(-1, -2)[..., None, :, :]  # [..., nl, 3, nj]
    Jw = torch.cat([torch.zeros_like(eye3), eye3, Jw_q], dim=-1)
    # linear: [I | -hat(c_l - p_base) | anc * axis x (c_l - pivot)]
    arms = c_world[..., :, None, :] - pivot[..., None, :, :]  # [..., nl, nj, 3]
    cols = cross(axis_w[..., None, :, :], arms)  # [..., nl, nj, 3]
    Jv_q = anc[:, None, :] * cols.transpose(-1, -2)  # [..., nl, 3, nj]
    Jv = torch.cat([eye3, -lie.hat(c_world - link_p[..., 0:1, :]), Jv_q], dim=-1)
    return c_world, Jv, Jw


def _world_inertias(mt: ModelTensors, link_R):
    return torch.einsum("...lab,lbc,...ldc->...lad", link_R, mt.link_inertia, link_R)


def centroidal_momentum_matrix(model: RobotModel, link_R, link_p):
    """Centroidal momentum matrix A_h [..., 6, 6+nj]: h = A_h @ nu with
    h = [linear; angular about the CoM] and nu mixed-representation."""
    mt = _consts(model, link_R)
    m = mt.link_mass
    c_world, Jv, Jw = link_com_jacobians(model, link_R, link_p)
    com_w = torch.einsum("l,...li->...i", m, c_world) / model.total_mass
    A_lin = torch.einsum("l,...lxk->...xk", m, Jv)
    r = c_world - com_w[..., None, :]
    A_ang = torch.einsum("l,...lab,...lbk->...ak", m, lie.hat(r), Jv) + torch.einsum(
        "...lab,...lbk->...ak", _world_inertias(mt, link_R), Jw
    )
    return torch.cat([A_lin, A_ang], dim=-2)


def centroidal_momentum(model: RobotModel, link_R, link_p, nu):
    """Centroidal momentum h = [linear; angular] [..., 6] given nu =
    [v_base(3), w_base(3), qdot(nj)] in mixed representation."""
    mt = _consts(model, link_R)
    anc, m = mt.anc, mt.link_mass
    c_world = _link_coms(mt, link_R, link_p)
    com_w = torch.einsum("l,...li->...i", m, c_world) / model.total_mass
    axis_w, pivot = joint_world_axes(model, link_R, link_p)

    v_b, w_b, qd = nu[..., 0:3], nu[..., 3:6], nu[..., 6:]
    # per-link linear velocity of its com and angular velocity
    w_l = w_b[..., None, :] + torch.einsum("...jx,lj,...j->...lx", axis_w, anc, qd)
    v_l = (
        v_b[..., None, :]
        + cross(w_b[..., None, :], c_world - link_p[..., 0:1, :])
        + torch.einsum(
            "...ljx,lj,...j->...lx",
            cross(axis_w[..., None, :, :], c_world[..., :, None, :] - pivot[..., None, :, :]),
            anc,
            qd,
        )
    )
    lin = torch.einsum("l,...lx->...x", m, v_l)
    ang = torch.einsum("l,...lx->...x", m, cross(c_world - com_w[..., None, :], v_l)) + torch.einsum(
        "...lab,...lb->...a", _world_inertias(mt, link_R), w_l
    )
    return torch.cat([lin, ang], dim=-1)


# ---------------------------------------------------------------------------
# URDF import (host-side, numpy)
# ---------------------------------------------------------------------------


def _rpy_to_mat(r, p, y):
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return (
        np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    )


def parse_urdf(source: str, base_link: str, joint_order: list[str], frames: dict[str, str]):
    """Minimal URDF -> RobotModel reduced to `joint_order` (other joints
    locked at zero and welded). `frames` maps frame name -> URDF link name.

    Equivalent of iDynTree ModelLoader's reduced-model load
    (WholeBodyQPBlock.cpp:525-543 with the 26-name joints_list).
    """
    root = ET.fromstring(source if source.lstrip().startswith("<") else open(source).read())
    links = {l.get("name"): l for l in root.findall("link")}
    joints = {j.get("name"): j for j in root.findall("joint")}

    # walk the tree from base_link, welding everything not in joint_order
    child_of = {}
    for jname, j in joints.items():
        child_of.setdefault(j.find("parent").get("link"), []).append(jname)

    jn, parent, axis, opos, orot = [], [], [], [], []
    qlo, qhi, qvl = [], [], []
    link_names = [base_link]
    masses, coms, inertias = [], [], []

    def link_inertial(lname):
        l = links[lname]
        inertial = l.find("inertial")
        if inertial is None:
            return 1e-6, np.zeros(3), np.eye(3) * 1e-9
        mass = float(inertial.find("mass").get("value"))
        orig = inertial.find("origin")
        xyz = np.fromstring(orig.get("xyz", "0 0 0"), sep=" ") if orig is not None else np.zeros(3)
        it = inertial.find("inertia")
        I = np.array(
            [
                [float(it.get("ixx", 0)), float(it.get("ixy", 0)), float(it.get("ixz", 0))],
                [float(it.get("ixy", 0)), float(it.get("iyy", 0)), float(it.get("iyz", 0))],
                [float(it.get("ixz", 0)), float(it.get("iyz", 0)), float(it.get("izz", 0))],
            ]
        )
        return mass, xyz, I

    m0, c0, I0 = link_inertial(base_link)
    masses, coms, inertias = [m0], [c0], [I0]

    # DFS accumulating welded subtrees into their moving ancestor link
    def dfs(urdf_link, model_link_idx, T_acc_R, T_acc_p):
        for jname in child_of.get(urdf_link, []):
            j = joints[jname]
            child = j.find("child").get("link")
            orig = j.find("origin")
            xyz = np.fromstring(orig.get("xyz", "0 0 0"), sep=" ") if orig is not None else np.zeros(3)
            rpy = np.fromstring(orig.get("rpy", "0 0 0"), sep=" ") if orig is not None else np.zeros(3)
            R_j = _rpy_to_mat(*rpy)
            R_new = T_acc_R @ R_j
            p_new = T_acc_p + T_acc_R @ xyz
            if jname in joint_order and j.get("type") in ("revolute", "continuous"):
                ax = np.fromstring(j.find("axis").get("xyz"), sep=" ") if j.find("axis") is not None else np.array([0.0, 0, 1])
                jn.append(jname)
                parent.append(model_link_idx)
                axis.append(ax)
                opos.append(p_new)
                orot.append(R_new)
                lim = j.find("limit")
                qlo.append(float(lim.get("lower", -np.pi)) if lim is not None else -np.pi)
                qhi.append(float(lim.get("upper", np.pi)) if lim is not None else np.pi)
                qvl.append(float(lim.get("velocity", 10.0)) if lim is not None else 10.0)
                mc, cc, Ic = link_inertial(child)
                masses.append(mc)
                coms.append(cc)
                inertias.append(Ic)
                link_names.append(child)
                new_idx = len(link_names) - 1
                _frame_hits(child, new_idx, np.eye(3), np.zeros(3))
                dfs(child, new_idx, np.eye(3), np.zeros(3))
            else:
                # weld: merge child inertia into model_link_idx
                mc, cc, Ic = link_inertial(child)
                cw = p_new + R_new @ cc
                m_old = masses[model_link_idx]
                c_old = coms[model_link_idx]
                m_new = m_old + mc
                c_new = (m_old * c_old + mc * cw) / max(m_new, 1e-9)
                # parallel-axis both inertias to c_new (rotation applied to child)
                def pa(I, m, c, cn):
                    d = c - cn
                    return I + m * ((d @ d) * np.eye(3) - np.outer(d, d))
                I_new = pa(inertias[model_link_idx], m_old, c_old, c_new) + pa(
                    R_new @ Ic @ R_new.T, mc, cw, c_new
                )
                masses[model_link_idx] = m_new
                coms[model_link_idx] = c_new
                inertias[model_link_idx] = I_new
                _frame_hits(child, model_link_idx, R_new, p_new)
                dfs(child, model_link_idx, R_new, p_new)

    frame_records = {}

    def _frame_hits(urdf_link, model_link, R_off, p_off):
        for fname, flink in frames.items():
            if flink == urdf_link:
                frame_records[fname] = (model_link, R_off.copy(), p_off.copy())

    _frame_hits(base_link, 0, np.eye(3), np.zeros(3))
    dfs(base_link, 0, np.eye(3), np.zeros(3))

    # reorder joints to joint_order
    order = [jn.index(n) for n in joint_order if n in jn]
    missing = [n for n in joint_order if n not in jn]
    if missing:
        raise ValueError(f"joints not found in URDF: {missing}")
    remap = {old + 1: new + 1 for new, old in enumerate(order)}
    remap[0] = 0
    parent_arr = np.array([remap[parent[i]] if parent[i] in remap else 0 for i in order])
    # NB: reordering requires parents to appear before children in
    # joint_order within each chain (true for standard humanoid lists).

    fnames = tuple(frame_records.keys())
    flink = np.array([remap.get(frame_records[f][0], 0) for f in fnames])
    frot = np.stack([frame_records[f][1] for f in fnames]) if fnames else np.zeros((0, 3, 3))
    fpos = np.stack([frame_records[f][2] for f in fnames]) if fnames else np.zeros((0, 3))

    return RobotModel(
        joint_names=tuple(joint_order),
        parent=parent_arr,
        axis=np.stack([axis[i] for i in order]),
        origin_pos=np.stack([opos[i] for i in order]),
        origin_rot=np.stack([orot[i] for i in order]),
        link_mass=np.array([masses[0]] + [masses[i + 1] for i in order]),
        link_com=np.stack([coms[0]] + [coms[i + 1] for i in order]),
        link_inertia=np.stack([inertias[0]] + [inertias[i + 1] for i in order]),
        frame_names=fnames,
        frame_link=flink,
        frame_pos=fpos,
        frame_rot=frot,
        q_lim=np.stack([np.array([qlo[i], qhi[i]]) for i in order]),
        qd_lim=np.array([qvl[i] for i in order]),
    )


# ---------------------------------------------------------------------------
# Built-in approximate ergoCub model (26 joints, joints_list order of
# centroidal_mpc_walking.ini:16-22). Dimensions/inertia are plausible
# humanoid values (total mass ~56 kg, hip height ~0.78 m) — the reference
# repo ships no URDF, so this model backs the demo apps and tests.
# ---------------------------------------------------------------------------

ERGOCUB_JOINTS = (
    "l_hip_pitch", "l_hip_roll", "l_hip_yaw", "l_knee", "l_ankle_pitch", "l_ankle_roll",
    "r_hip_pitch", "r_hip_roll", "r_hip_yaw", "r_knee", "r_ankle_pitch", "r_ankle_roll",
    "torso_pitch", "torso_roll", "torso_yaw",
    "neck_pitch", "neck_roll", "neck_yaw",
    "l_shoulder_pitch", "l_shoulder_roll", "l_shoulder_yaw", "l_elbow",
    "r_shoulder_pitch", "r_shoulder_roll", "r_shoulder_yaw", "r_elbow",
)

_X, _Y, _Z = np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])


def ergocub_approx() -> RobotModel:
    """26-joint approximate ergoCub: legs (6 DoF each), torso (3), neck (3),
    arms (4 each). Floating base = pelvis (root_link).

    PROVENANCE of the baked constants (the reference loads the real URDF via
    findFileByName("model.urdf"), CentroidalMPCBlock.cpp:150-151; no URDF
    ships in this repo or the reference's, so the model here is hand-built
    and calibrated against what the reference tree does pin down):
    - total mass 58.0 kg and the ~56/44 lower/upper split match the public
      ergoCub spec sheet class (56-58 kg); per-link masses are box-inertia
      guesses at plausible segment fractions, NOT measured values.
    - leg segment lengths (0.30 m thigh, 0.30 m shank, hip separation
      0.16 m, ankle height 0.06 m) are chosen so the walk-ready crouch
      (the reference's hard-coded joints, CentroidalMPCBlock.cpp:273-280,
      with the Gazebo spawn base pitch -0.1) puts the CoM 0.75 m above the
      soles — consistent with the reference's 0.7 m MPC operating height
      being a deliberate ~5 cm squat below natural
      (CentroidalMPCBlock.cpp:531-534; config com_height_drop=0.05).
      - joint AXIS SIGNS are calibrated, not guessed — see the comment below.
    Error bound: downstream quantities shaped by the inertia guesses are the
    angular-momentum reference scale and the rigid plant's mass matrix;
    geometry-driven quantities (CoM height, foot placement, ZMP arms) are
    pinned by the calibration above."""
    eye = np.eye(3)

    def box_inertia(m, x, y, z):
        return m / 12.0 * np.diag([y * y + z * z, x * x + z * z, x * x + y * y])

    joints = []  # (name, parent_link_name, axis, origin_pos)
    links = {"root_link": (8.0, np.array([0.0, 0.0, 0.05]), box_inertia(8.0, 0.15, 0.25, 0.15))}

    # Joint-axis conventions (calibrated against the reference's own data,
    # not guessed): the axis signs below are the unique family (up to a
    # global reflection fixed by the Gazebo spawn pitch) for which
    #   (a) the hard-coded initial crouch (CentroidalMPCBlock.cpp:273-280)
    #       yields FLAT soles with the base pitched -0.11 rad — matching the
    #       reference world's spawn pose `0 0 0.78 0 -0.1 0`
    #       (worlds/centroidal_mpc_ergoCubGazeboV1/world), sole tilt < 1.3
    #       deg on both feet (exhaustive sign search over 2^6 x mirror);
    #   (b) MANN's walking joint trajectories produce a sane gait through
    #       this FK: swing clearance 5-9 cm, feet never cross (min
    #       left-right sole spacing 0.16 m; the unmirrored variant dips to
    #       0.00 m), forward stride.
    # Right-side roll/yaw axes are mirrored (positive = abduction/external
    # rotation on BOTH sides — the iCub/ergoCub convention, evidenced by the
    # crouch's same-sign L/R hip_roll/hip_yaw/shoulder_roll values).
    # With the old all-positive axes, MANN postures were kinematically
    # inconsistent with flat feet: the leg-pitch angles don't sum to zero,
    # so the IK's soft posture task rotated the BASE by up to 23 deg to
    # compensate — the round-1 "lateral weight-transfer lag" rigid-plant
    # falls all traced back to this.
    def leg(side, sgn):
        hip = np.array([0.0, sgn * 0.08, -0.05])
        joints.extend(
            [
                (f"{side}_hip_pitch", "root_link", -_Y, hip, (2.0, [0, 0, 0], box_inertia(2.0, 0.1, 0.1, 0.1))),
                (f"{side}_hip_roll", f"{side}_hip_pitch_l", sgn * _X, np.zeros(3), (1.5, [0, 0, 0], box_inertia(1.5, 0.1, 0.1, 0.1))),
                (f"{side}_hip_yaw", f"{side}_hip_roll_l", sgn * _Z, np.zeros(3), (3.5, [0, 0, -0.15], box_inertia(3.5, 0.1, 0.1, 0.3))),
                (f"{side}_knee", f"{side}_hip_yaw_l", -_Y, np.array([0.0, 0.0, -0.30]), (2.5, [0, 0, -0.14], box_inertia(2.5, 0.08, 0.08, 0.3))),
                (f"{side}_ankle_pitch", f"{side}_knee_l", _Y, np.array([0.0, 0.0, -0.30]), (0.8, [0, 0, 0], box_inertia(0.8, 0.07, 0.07, 0.07))),
                (f"{side}_ankle_roll", f"{side}_ankle_pitch_l", -sgn * _X, np.zeros(3), (0.9, [0.03, 0, -0.06], box_inertia(0.9, 0.2, 0.08, 0.04))),
            ]
        )

    def arm(side, sgn):
        sh = np.array([0.0, sgn * 0.16, 0.22])
        joints.extend(
            [
                (f"{side}_shoulder_pitch", "torso_yaw_l", _Y, sh, (1.0, [0, 0, 0], box_inertia(1.0, 0.08, 0.08, 0.08))),
                (f"{side}_shoulder_roll", f"{side}_shoulder_pitch_l", sgn * _X, np.zeros(3), (0.8, [0, 0, 0], box_inertia(0.8, 0.07, 0.07, 0.07))),
                (f"{side}_shoulder_yaw", f"{side}_shoulder_roll_l", sgn * _Z, np.zeros(3), (1.5, [0, 0, -0.12], box_inertia(1.5, 0.06, 0.06, 0.24))),
                (f"{side}_elbow", f"{side}_shoulder_yaw_l", _Y, np.array([0.0, 0.0, -0.24]), (1.2, [0, 0, -0.12], box_inertia(1.2, 0.05, 0.05, 0.24))),
            ]
        )

    leg("l", +1)
    leg("r", -1)
    joints.extend(
        [
            ("torso_pitch", "root_link", _Y, np.array([0.0, 0.0, 0.1]), (2.0, [0, 0, 0], box_inertia(2.0, 0.15, 0.2, 0.1))),
            ("torso_roll", "torso_pitch_l", _X, np.zeros(3), (2.0, [0, 0, 0], box_inertia(2.0, 0.15, 0.2, 0.1))),
            ("torso_yaw", "torso_roll_l", _Z, np.zeros(3), (12.0, [0, 0, 0.15], box_inertia(12.0, 0.2, 0.3, 0.35))),
            ("neck_pitch", "torso_yaw_l", _Y, np.array([0.0, 0.0, 0.32]), (0.3, [0, 0, 0], box_inertia(0.3, 0.05, 0.05, 0.05))),
            ("neck_roll", "neck_pitch_l", _X, np.zeros(3), (0.3, [0, 0, 0], box_inertia(0.3, 0.05, 0.05, 0.05))),
            ("neck_yaw", "neck_roll_l", _Z, np.zeros(3), (2.0, [0, 0, 0.1], box_inertia(2.0, 0.14, 0.16, 0.2))),
        ]
    )
    arm("l", +1)
    arm("r", -1)

    name_to_entry = {j[0]: j for j in joints}
    link_index = {"root_link": 0}
    jn, parent, axis, opos, orot = [], [], [], [], []
    masses = [links["root_link"][0]]
    coms = [links["root_link"][1]]
    inertias = [links["root_link"][2]]
    for name in ERGOCUB_JOINTS:
        jname, par_link, ax, orig, (m, c, I) = name_to_entry[name]
        par_idx = link_index[par_link]
        jn.append(jname)
        parent.append(par_idx)
        axis.append(ax)
        opos.append(orig)
        orot.append(eye)
        masses.append(m)
        coms.append(np.asarray(c, float))
        inertias.append(I)
        link_index[f"{jname}_l"] = len(masses) - 1

    frames = {
        "root_link": (0, eye, np.zeros(3)),
        "l_sole": (link_index["l_ankle_roll_l"], eye, np.array([0.03, 0.0, -0.10])),
        "r_sole": (link_index["r_ankle_roll_l"], eye, np.array([0.03, 0.0, -0.10])),
        "chest": (link_index["torso_yaw_l"], eye, np.array([0.0, 0.0, 0.1])),
        "head": (link_index["neck_yaw_l"], eye, np.array([0.0, 0.0, 0.15])),
    }
    fnames = tuple(frames.keys())
    # joint limits: spec-class ESTIMATES (the authoritative values live in
    # the unobtainable icub-models URDF — see ergocub_urdf provenance).
    # Generous enough that the nominal gait never touches them; the
    # meaningful tight ones are the knee (bends NEGATIVE in this model's
    # calibrated axis convention — walking crouch ~-0.9 rad — so +0.1
    # blocks hyperextension and -2.2 blocks folding flat, the measured
    # end state of the round-4 speed runaway) and the ankle pitch.
    _lim = {
        "hip_pitch": (-2.0, 2.0), "hip_roll": (-1.2, 1.2),
        "hip_yaw": (-1.2, 1.2), "knee": (-2.2, 0.1),
        "ankle_pitch": (-0.9, 0.9), "ankle_roll": (-0.8, 0.8),
        "torso_pitch": (-1.0, 1.2), "torso_roll": (-0.8, 0.8),
        "torso_yaw": (-1.5, 1.5), "neck_pitch": (-1.0, 1.0),
        "neck_roll": (-1.0, 1.0), "neck_yaw": (-1.5, 1.5),
        "shoulder_pitch": (-2.8, 2.8), "shoulder_roll": (-2.8, 2.8),
        "shoulder_yaw": (-2.8, 2.8), "elbow": (-2.0, 2.0),
    }
    q_lim = np.array(
        [_lim[n.split("_", 1)[1] if n[1] == "_" else n] for n in ERGOCUB_JOINTS]
    )
    return RobotModel(
        joint_names=ERGOCUB_JOINTS,
        parent=np.array(parent),
        axis=np.stack(axis),
        origin_pos=np.stack(opos),
        origin_rot=np.stack(orot),
        link_mass=np.array(masses),
        link_com=np.stack(coms),
        link_inertia=np.stack(inertias),
        frame_names=fnames,
        frame_link=np.array([frames[f][0] for f in fnames]),
        frame_pos=np.stack([frames[f][2] for f in fnames]),
        frame_rot=np.stack([frames[f][1] for f in fnames]),
        q_lim=q_lim,
        qd_lim=np.full(len(ERGOCUB_JOINTS), 10.0),
    )


def ergocub_urdf(path: str | None = None) -> RobotModel:
    """The ergoCub URDF shipped with the port (`cmw_tpu_torch/models/
    ergocub.urdf`, byte-identical to the JAX package's) through the full
    `parse_urdf` reduction to the 26-joint joints_list.

    PROVENANCE: the authoritative icub-models URDF is not available; the
    shipped file is the calibrated ergocub_approx() skeleton with a
    realistic anthropometric inertial distribution (56.6 kg, off-axis
    segment CoMs, welded feet/head/hands/battery)."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models", "ergocub.urdf")
    return parse_urdf(
        path,
        "root_link",
        list(ERGOCUB_JOINTS),
        frames={
            "root_link": "root_link",
            "l_sole": "l_sole_frame",
            "r_sole": "r_sole_frame",
            "chest": "chest_frame",
            "head": "head_frame",
        },
    )


#: Base pitch (rad) of the walk-ready crouch: the reference world spawns the
#: robot at pose `0 0 0.78 0 -0.1 0` (centroidal_mpc_ergoCubGazeboV1/world);
#: -0.11 is the grid-refined value minimizing sole tilt of
#: `reference_initial_pose()` under the calibrated axis conventions above
#: (max sole tilt 1.23 deg over both feet).
CROUCH_BASE_PITCH = -0.11


def walk_ready_pose():
    """(q0 [26], base_rot [3,3]) of the reference's walk-ready crouch —
    joints from `reference_initial_pose()`, base pitched by
    `CROUCH_BASE_PITCH` so the soles are flat. This is the default start
    configuration for closed-loop episodes (the reference both spawns the
    Gazebo robot and seeds MANN from exactly this configuration)."""
    cp, sp = np.cos(CROUCH_BASE_PITCH), np.sin(CROUCH_BASE_PITCH)
    base_rot = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    return reference_initial_pose(), base_rot


def reference_initial_pose() -> np.ndarray:
    """The reference's hard-coded initial joint configuration
    (CentroidalMPCBlock.cpp:273-280, same 26-joint order as
    centroidal_mpc_walking.ini:16-22; the Gazebo worlds spawn the robot in
    the matching pose, worlds/centroidal_mpc_ergoCubGazeboV1/world).

    Starting from this pose matters: it is inside the MANN training
    distribution, so the generator's first references are consistent with
    the robot's actual state (from zeros, the CoM reference jumps ~2.3 cm
    forward at t=0 and the physical robot lurches). Use `walk_ready_pose()`
    for the matching base orientation (the soles are flat only with the
    base pitched by CROUCH_BASE_PITCH)."""
    return np.array(
        [
            # left leg / right leg
            -0.10914914922234864, 0.013321900684695305, 0.0641749643461214,
            -0.10257791368141178, -0.10022507712940709, -0.008216588774319855,
            -0.12268291054316265, 0.030634497603792124, 0.07615972729195111,
            -0.08458915163006389, -0.09374216923819316, 0.03547153929302758,
            # torso, neck
            0.15820784458809578, 0.0027573447757581046, -0.00487324344589554,
            -0.00020607396841307649, -0.0024925787007575857, 0.044068009171592995,
            # left arm, right arm
            -0.027139990021827265, 0.10001107590632177, -0.20205046715326178,
            0.03895909848833218,
            -0.03078463156388759, 0.09999763869735125, -0.20637555723866208,
            -0.003024742916772738,
        ]
    )
