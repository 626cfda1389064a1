"""Forward / inverse kinematics over kinematic chains (reference
`utils/skeleton.py:4-199`; the port of `conductor_tpu/t2m/skeleton.py`).

The chains are Python lists, so the loops over them run on the host and
each step is a batched tensor op on the joints' device.  Joint positions
and local rotations are written by index into a fresh tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .quaternion import cont6d_to_matrix, qbetween, qinv, qmul, qnormalize, qrot


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Skeleton:
    """offset: (J, 3) unit bone directions; kinematic_tree: a list of chains,
    each starting at its parent joint (the root chain at 0).  Methods
    compute on the device of the joints or rotations they are given."""

    def __init__(self, offset, kinematic_tree):
        self._raw_offset = _f32(offset)
        self._kinematic_tree = [list(c) for c in kinematic_tree]
        self._offset = None
        self._parents = [0] * self._raw_offset.shape[0]
        self._parents[0] = -1
        for chain in self._kinematic_tree:
            for j in range(1, len(chain)):
                self._parents[chain[j]] = chain[j - 1]

    def njoints(self) -> int:
        return int(self._raw_offset.shape[0])

    def kinematic_tree(self):
        return self._kinematic_tree

    def parents(self):
        return self._parents

    def offset(self):
        return self._offset

    def set_offset(self, offsets) -> None:
        self._offset = _f32(offsets)

    def get_offsets_joints(self, joints) -> torch.Tensor:
        """Scale the unit bone directions by the bone lengths of a reference
        pose (J, 3) (`skeleton.py:42-50`); stored as the offsets."""
        joints = _f32(joints)
        parents = np.array(self._parents)
        parents_safe = np.where(parents < 0, 0, parents)
        lengths = torch.linalg.vector_norm(joints - joints[parents_safe], dim=-1)
        lengths[0] = 0.0
        self._offset = self._raw_offset.to(joints.device) * lengths[:, None]
        return self._offset

    def inverse_kinematics(self, joints, face_joint_idx,
                           smooth_forward: bool = False) -> torch.Tensor:
        """Global joint positions (T, J, 3) -> local quaternions (T, J, 4)
        (`skeleton.py:56-100`).  ``face_joint_idx`` = (r_hip, l_hip, r_sdr,
        l_sdr) gives the facing direction; frame 0's root rotation is pinned
        to the identity, as the reference's is.  ``smooth_forward`` smooths
        the facing direction over time by scipy's ``gaussian_filter1d`` on
        the host."""
        joints = _f32(joints)
        r_hip, l_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
        across = across / torch.linalg.vector_norm(across, dim=-1, keepdim=True)
        forward = torch.linalg.cross(joints.new_tensor([[0.0, 1.0, 0.0]]).expand_as(across),
                                     across, dim=-1)
        if smooth_forward:
            from scipy.ndimage import gaussian_filter1d

            forward = _f32(gaussian_filter1d(forward.cpu().numpy(), 20, axis=0, mode="nearest"),
                           joints.device)
        forward = forward / torch.linalg.vector_norm(forward, dim=-1, keepdim=True)

        root_quat = qbetween(forward, joints.new_tensor([0.0, 0.0, 1.0]).expand_as(forward))
        root_quat[0] = joints.new_tensor([1.0, 0.0, 0.0, 0.0])

        raw = self._raw_offset.to(joints.device)
        quat_params = joints.new_zeros(joints.shape[:-1] + (4,))
        quat_params[:, 0] = root_quat
        for chain in self._kinematic_tree:
            R = root_quat
            for j in range(len(chain) - 1):
                u = raw[chain[j + 1]].expand(joints.shape[0], 3)
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                R_loc = qmul(qinv(R), qbetween(u, v))
                quat_params[:, chain[j + 1]] = R_loc
                R = qmul(R, R_loc)
        return quat_params

    def _resolve_offsets(self, batch: int, skel_joints, device) -> torch.Tensor:
        if skel_joints is not None:
            offsets = torch.stack([self.get_offsets_joints(_f32(skel_joints[i], device))
                                   for i in range(len(skel_joints))])
        elif self._offset is not None and self._offset.dim() == 2:
            offsets = self._offset.expand((batch,) + tuple(self._offset.shape))
        else:
            offsets = self._offset
        return offsets.to(device)

    def forward_kinematics(self, quat_params, root_pos, skel_joints=None,
                           do_root_R: bool = True) -> torch.Tensor:
        """Local quaternions (B, J, 4) and root positions (B, 3) -> global
        joint positions (B, J, 3) (`skeleton.py:103-123`).  Each chain starts
        from the root's rotation."""
        quat_params = _f32(quat_params)
        root_pos = _f32(root_pos, quat_params.device)
        B = quat_params.shape[0]
        offsets = self._resolve_offsets(B, skel_joints, quat_params.device)
        joints = quat_params.new_zeros(quat_params.shape[:-1] + (3,))
        joints[:, 0] = root_pos
        for chain in self._kinematic_tree:
            if do_root_R:
                R = quat_params[:, 0]
            else:
                R = quat_params.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
            for i in range(1, len(chain)):
                R = qmul(R, quat_params[:, chain[i]])
                joints[:, chain[i]] = (qrot(qnormalize(R), offsets[:, chain[i]])
                                       + joints[:, chain[i - 1]])
        return joints

    def forward_kinematics_cont6d(self, cont6d_params, root_pos, skel_joints=None,
                                  do_root_R: bool = True) -> torch.Tensor:
        """6-D rotations (B, J, 6) and root positions (B, 3) -> global joint
        positions (B, J, 3) (`skeleton.py:149-199`)."""
        cont6d_params = _f32(cont6d_params)
        root_pos = _f32(root_pos, cont6d_params.device)
        B = cont6d_params.shape[0]
        offsets = self._resolve_offsets(B, skel_joints, cont6d_params.device)
        joints = cont6d_params.new_zeros(cont6d_params.shape[:-1] + (3,))
        joints[:, 0] = root_pos
        for chain in self._kinematic_tree:
            if do_root_R:
                matR = cont6d_to_matrix(cont6d_params[:, 0])
            else:
                matR = torch.eye(3, device=cont6d_params.device).expand(B, 3, 3)
            for i in range(1, len(chain)):
                matR = matR @ cont6d_to_matrix(cont6d_params[:, chain[i]])
                joints[:, chain[i]] = ((matR @ offsets[:, chain[i], :, None])[..., 0]
                                       + joints[:, chain[i - 1]])
        return joints
