"""HumanML3D motion features, extracted and recovered (reference
`utils/motion_process.py:38-397`; the port of
`conductor_tpu/t2m/motion_process.py`).

Feature layout a frame (dim = 4 + (J-1)*3 + (J-1)*6 + J*3 + 4; 263 for t2m's
22 joints, 251 for KIT's 21):

    [root_rot_vel(1) | root_lin_vel_xz(2) | root_y(1) |
     ric (J-1)*3 | rot6d (J-1)*6 | local_vel J*3 | feet contacts 4]

`recover_root_rot_pos`, `recover_from_ric` and `recover_from_rot` take
tensors and compute where they live; their sums over time are
`torch.cumsum`.  `uniform_skeleton`, `process_file`, `extract_features_full`
and `extract_ric_features` are the offline preprocessing: numpy in, numpy
out, as JAX's are, with the rotations and kinematics on ``device`` (the
card unless the caller asks for ``"cpu"``) and the rest in numpy on the
host, where JAX's runs numpy too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.precision import full_float32
from ..train.ddpm_trainer import require_device
from .quaternion import qbetween, qfix, qinv, qmul, qrot, quaternion_to_cont6d
from .skeleton import Skeleton, _f32


def recover_root_rot_pos(data: torch.Tensor):
    """Integrate the root's yaw and planar velocities back to its rotation
    and position (`motion_process.py:328-348`).  data (..., T, D): channel
    0 the yaw velocity, 1:3 the xz velocity, 3 the root height."""
    rot_vel = data[..., 0]
    r_rot_ang = torch.cumsum(torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]],
                                       dim=-1), dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)

    r_pos_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_pos = torch.stack([r_pos_xz[..., 0], torch.zeros_like(r_pos_xz[..., 0]), r_pos_xz[..., 1]],
                        dim=-1)
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.stack([r_pos[..., 0], data[..., 3], r_pos[..., 2]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """RIC features (..., T, D) -> joint positions (..., T, J, 3)
    (`motion_process.py:367-384`)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (-1, 3))
    positions = qrot(qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,)),
                     positions)
    positions = positions + torch.stack(
        [r_pos[..., 0:1], torch.zeros_like(r_pos[..., 0:1]), r_pos[..., 2:3]], dim=-1)
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def recover_from_rot(data: torch.Tensor, joints_num: int, skeleton: Skeleton) -> torch.Tensor:
    """6-D rotation features -> joint positions through FK
    (`motion_process.py:350-364`)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    r_rot_cont6d = quaternion_to_cont6d(r_rot_quat)
    start = 1 + 2 + 1 + (joints_num - 1) * 3
    end = start + (joints_num - 1) * 6
    cont6d = torch.cat([r_rot_cont6d, data[..., start:end]], dim=-1)
    cont6d = cont6d.reshape(-1, joints_num, 6)
    return skeleton.forward_kinematics_cont6d(cont6d, r_pos.reshape(-1, 3))


# HumanML3D preprocessing constants.  The reference's `uniform_skeleton` /
# `process_file` (`motion_process.py:13-35,156-326`) read them as globals of
# the HumanML3D notebook; here they are explicit, with the published values
# as defaults (`conductor_tpu/t2m/motion_process.py:92-100`).
T2M_LEFT_LEG = (5, 8)             # l_idx1, l_idx2
T2M_FID_R = (8, 11)               # right-foot joints
T2M_FID_L = (7, 10)               # left-foot joints
T2M_FACE_JOINTS = (2, 1, 17, 16)  # r_hip, l_hip, sdr_r, sdr_l


def uniform_skeleton(positions: np.ndarray, target_offset, n_raw_offsets: np.ndarray,
                     kinematic_chain, *, face_joint_indx=T2M_FACE_JOINTS,
                     l_idx1: int = T2M_LEFT_LEG[0], l_idx2: int = T2M_LEFT_LEG[1],
                     device: torch.device | str = "cuda") -> np.ndarray:
    """Retarget a motion (T, J, 3) onto the canonical skeleton
    (`motion_process.py:13-35`): scale the root path by the ratio of leg
    lengths, IK to local quaternions on the source bones, FK back on the
    target bones."""
    device = require_device(device)
    positions = np.asarray(positions, dtype=np.float32)
    with full_float32():
        skel = Skeleton(n_raw_offsets, kinematic_chain)
        src_offset = skel.get_offsets_joints(_f32(positions[0], device)).cpu().numpy()
        tgt_offset = np.asarray(target_offset, dtype=np.float32)

        src_leg_len = np.abs(src_offset[l_idx1]).max() + np.abs(src_offset[l_idx2]).max()
        tgt_leg_len = np.abs(tgt_offset[l_idx1]).max() + np.abs(tgt_offset[l_idx2]).max()
        tgt_root_pos = positions[:, 0] * (tgt_leg_len / src_leg_len)

        quat_params = skel.inverse_kinematics(_f32(positions, device), face_joint_indx)
        skel.set_offset(tgt_offset)
        return skel.forward_kinematics(quat_params, _f32(tgt_root_pos, device)).cpu().numpy()


def process_file(positions: np.ndarray, feet_thre: float, tgt_offsets,
                 n_raw_offsets: np.ndarray, kinematic_chain, *,
                 face_joint_indx=T2M_FACE_JOINTS, fid_r=T2M_FID_R, fid_l=T2M_FID_L,
                 l_idx1: int = T2M_LEFT_LEG[0], l_idx2: int = T2M_LEFT_LEG[1],
                 device: torch.device | str = "cuda"):
    """Raw global joints (T, J, 3) -> the whole HumanML3D feature pipeline
    (`motion_process.py:156-326`): the uniform skeleton, on the floor, the
    root's XZ at the origin, the first pose facing +z (`qbetween`), then
    the features.  Returns ``(data, global_positions, local_positions,
    l_velocity)`` as the reference does."""
    device = require_device(device)
    positions = uniform_skeleton(positions, tgt_offsets, n_raw_offsets, kinematic_chain,
                                 face_joint_indx=face_joint_indx, l_idx1=l_idx1, l_idx2=l_idx2,
                                 device=device)

    # on the floor, the root's XZ at the origin (in float64, as JAX's numpy)
    positions = positions - np.array([0.0, positions[:, :, 1].min(), 0.0])
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * np.array([1.0, 0.0, 1.0])

    # the first pose faces +z
    r_hip, l_hip, sdr_r, sdr_l = face_joint_indx
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
        root_pos_init[sdr_r] - root_pos_init[sdr_l])
    across = across / np.sqrt((across ** 2).sum())
    forward_init = np.cross(np.array([0.0, 1.0, 0.0]), across)
    forward_init = forward_init / np.sqrt((forward_init ** 2).sum())
    with full_float32():
        root_quat_init = qbetween(_f32(forward_init[None], device),
                                  _f32([[0.0, 0.0, 1.0]], device))
        pos = _f32(positions, device)
        positions = qrot(root_quat_init.expand(pos.shape[:-1] + (4,)), pos).cpu().numpy()

    return extract_features_full(positions, feet_thre, n_raw_offsets, kinematic_chain,
                                 face_joint_indx, fid_r, fid_l, device=device)


def extract_features_full(positions: np.ndarray, feet_thre: float, n_raw_offsets: np.ndarray,
                          kinematic_chain, face_joint_indx, fid_r, fid_l, *,
                          device: torch.device | str = "cuda"):
    """`extract_features` with the reference `process_file`'s whole return
    tuple ``(data, global_positions, local_positions, l_velocity)``.  Foot
    contacts are a strict ``<`` of the squared displacement a frame against
    ``feet_thre``, in numpy."""
    device = require_device(device)
    positions = np.asarray(positions, dtype=np.float32)
    global_positions = positions.copy()

    def foot_contacts(fid):
        d2 = ((positions[1:, fid] - positions[:-1, fid]) ** 2).sum(axis=-1)
        return (d2 < feet_thre).astype(np.float32)

    feet_l, feet_r = foot_contacts(fid_l), foot_contacts(fid_r)
    T, J = positions.shape[:2]

    with full_float32():
        pos = _f32(positions, device)
        skel = Skeleton(n_raw_offsets, kinematic_chain)
        quat_params = qfix(skel.inverse_kinematics(pos, face_joint_indx, smooth_forward=True))
        cont6d_params = quaternion_to_cont6d(quat_params)
        r_rot = quat_params[:, 0]

        velocity = qrot(r_rot[1:], pos[1:, 0] - pos[:-1, 0]).cpu().numpy()
        r_velocity = qmul(r_rot[1:], qinv(r_rot[:-1])).cpu().numpy()

        # root-relative, facing +z
        local = positions.copy()
        local[..., 0] -= local[:, 0:1, 0]
        local[..., 2] -= local[:, 0:1, 2]
        local = qrot(r_rot[:, None].expand(T, J, 4), _f32(local, device)).cpu().numpy()

        local_vel = qrot(r_rot[:-1, None].expand(T - 1, J, 4),
                         _f32(global_positions[1:] - global_positions[:-1], device))
        local_vel = local_vel.cpu().numpy().reshape(T - 1, -1)
        cont6d_params = cont6d_params.cpu().numpy()

    root_data = np.concatenate(
        [np.arcsin(r_velocity[:, 2:3]), velocity[:, [0, 2]], local[:-1, 0, 1:2]], axis=-1)
    ric_data = local[:, 1:].reshape(T, -1)
    rot_data = cont6d_params[:, 1:].reshape(T, -1)
    data = np.concatenate(
        [root_data, ric_data[:-1], rot_data[:-1], local_vel, feet_l, feet_r], axis=-1)
    return data, global_positions, local, velocity[:, [0, 2]]


def extract_ric_features(positions: np.ndarray, feet_thre: float, n_raw_offsets: np.ndarray,
                         kinematic_chain, face_joint_indx, fid_r, fid_l, *,
                         device: torch.device | str = "cuda") -> np.ndarray:
    """Global joint positions (T, J, 3) -> (T-1, D) feature frames
    (`motion_process.py:38-153` `extract_features`)."""
    return extract_features_full(positions, feet_thre, n_raw_offsets, kinematic_chain,
                                 face_joint_indx, fid_r, fid_l, device=device)[0]
