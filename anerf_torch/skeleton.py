"""Skeleton definitions and the canonical SMPL rest pose.

The PyTorch port's own copy of `anerf_tpu/skeleton.py` (numpy only; the
port imports nothing from the JAX package). The `Skeleton` type is a
frozen, hashable dataclass, so a RenderConfig that holds it stays
hashable too.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """A kinematic tree definition.

    joint_names: per-joint names.
    joint_trees: parent index for each joint (root points at itself).
    root_id: index of the root joint.
    cutoffs: per joint-class cutoff distances in mm (reference:
        core/utils/skeleton_utils.py:107-108).
    end_effectors: indices of end-effector joints (or None).
    """

    joint_names: Tuple[str, ...]
    joint_trees: Tuple[int, ...]
    root_id: int
    cutoffs: Tuple[Tuple[str, int], ...] = ()
    end_effectors: Optional[Tuple[int, ...]] = None

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def nonroot_id(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.n_joints) if i != self.root_id)

    @property
    def cutoff_table(self) -> Dict[str, int]:
        return dict(self.cutoffs)

    @cached_property
    def parent_ids_nonroot(self) -> Tuple[int, ...]:
        """Parent id per non-root joint, in non-root order."""
        jt = self.joint_trees
        return tuple(jt[i] for i in range(self.n_joints) if i != self.root_id)

    @cached_property
    def levels(self) -> Tuple[Tuple[int, ...], ...]:
        """Joints grouped by depth in the tree (root = level 0).

        Used to build a level-parallel FK: all joints in a level share no
        ancestor/descendant relation, so their local-to-world transforms can
        be computed with one batched matmul per level (the generalization of
        the reference's hand-unrolled 8-stage chain,
        core/pose_opt.py:482-521).
        """
        depth = [0] * self.n_joints
        for j in range(self.n_joints):
            if j == self.root_id:
                continue
            depth[j] = depth[self.joint_trees[j]] + 1
        out = []
        for d in range(max(depth) + 1):
            out.append(tuple(j for j in range(self.n_joints) if depth[j] == d))
        return tuple(out)


SMPLSkeleton = Skeleton(
    joint_names=(
        'pelvis', 'left_hip', 'right_hip', 'spine1',
        'left_knee', 'right_knee', 'spine2', 'left_ankle',
        'right_ankle', 'spine3', 'left_foot', 'right_foot',
        'neck', 'left_collar', 'right_collar', 'head',
        'left_shoulder', 'right_shoulder', 'left_elbow', 'right_elbow',
        'left_wrist', 'right_wrist', 'left_hand', 'right_hand',
    ),
    joint_trees=(
        0, 0, 0, 0,
        1, 2, 3, 4,
        5, 6, 7, 8,
        9, 9, 9, 12,
        13, 14, 16, 17,
        18, 19, 20, 21,
    ),
    root_id=0,
    cutoffs=(
        ('hip', 200), ('spine', 300), ('knee', 70), ('ankle', 70),
        ('foot', 40), ('collar', 100), ('neck', 100), ('head', 120),
        ('shoulder', 70), ('elbow', 70), ('wrist', 60), ('hand', 60),
    ),
    end_effectors=(10, 11, 15, 22, 23),
)

# Alias kept for parity with the reference naming (skeleton_utils.py:113).
CMUSkeleton = SMPLSkeleton

CanonicalSkeleton = Skeleton(
    joint_names=(
        'head_top', 'neck', 'right_shoulder', 'right_elbow', 'right_wrist',
        'left_shoulder', 'left_elbow', 'left_wrist', 'right_hip', 'right_knee',
        'right_ankle', 'left_hip', 'left_knee', 'left_ankle', 'pelvis',
        'spine', 'head',
    ),
    joint_trees=(
        1, 15, 1, 2, 3,
        1, 5, 6, 14, 8,
        9, 14, 11, 12, 14,
        14, 1,
    ),
    root_id=14,
)

Mpi3dhpSkeleton = Skeleton(
    joint_names=(
        'spine3', 'spine4', 'spine2', 'spine',
        'pelvis', 'neck', 'head', 'head_top',
        'left_clavicle', 'left_shoulder', 'left_elbow', 'left_wrist',
        'left_hand', 'right_clavicle', 'right_shoulder', 'right_elbow',
        'right_wrist', 'right_hand', 'left_hip', 'left_knee',
        'left_ankle', 'left_foot', 'left_toe', 'right_hip',
        'right_knee', 'right_ankle', 'right_foot', 'right_toe',
    ),
    joint_trees=(
        2, 0, 3, 4,
        4, 1, 5, 6,
        5, 8, 9, 10,
        11, 5, 13, 14,
        15, 16, 4, 18,
        19, 20, 21, 4,
        23, 24, 25, 26,
    ),
    root_id=4,
)

SMPLSkeletonExtended = Skeleton(
    joint_names=(
        'pelvis', 'left_hip', 'right_hip', 'spine1',
        'left_knee', 'right_knee', 'spine2', 'left_ankle',
        'right_ankle', 'spine3', 'left_foot', 'right_foot',
        'neck', 'left_collar', 'right_collar', 'head',
        'left_shoulder', 'right_shoulder', 'left_upper_arm', 'right_upper_arm',
        'left_elbow', 'right_elbow', 'left_lower_arm', 'right_lower_arm',
        'left_wrist', 'right_wrist', 'left_hand', 'right_hand',
    ),
    joint_trees=(
        0, 0, 0, 0,
        1, 2, 3, 4,
        5, 6, 7, 8,
        9, 9, 9, 12,
        13, 14, 16, 17,
        18, 19, 20, 21,
        22, 23, 24, 25,
    ),
    root_id=0,
)


def get_skeleton_type(kps: np.ndarray) -> Skeleton:
    """Infer skeleton from keypoint count (reference: skeleton_utils.py:180-188)."""
    if kps.shape[-2] == 17:
        return CanonicalSkeleton
    if kps.shape[-2] == 28:
        return Mpi3dhpSkeleton
    return SMPLSkeleton


# SMPL canonical rest pose, (24, 3), y-up convention.
# Numeric values match the reference table (skeleton_utils.py:259-282): these
# are the canonical SMPL zero-pose joint locations and are part of the data
# contract (FK against pretrained checkpoints depends on them bit-for-bit).
smpl_rest_pose = np.array(
    [[ 0.00000000e+00,  2.30003661e-09, -9.86228770e-08],
     [ 1.63832515e-01, -2.17391014e-01, -2.89178602e-02],
     [-1.57855421e-01, -2.14761734e-01, -2.09642015e-02],
     [-7.04505108e-03,  2.50450850e-01, -4.11837511e-02],
     [ 2.42021069e-01, -1.08830070e+00, -3.14962119e-02],
     [-2.47206554e-01, -1.10715497e+00, -3.06970738e-02],
     [ 3.95125849e-03,  5.94849110e-01, -4.03754264e-02],
     [ 2.12680623e-01, -1.99382353e+00, -1.29327580e-01],
     [-2.10857525e-01, -2.01218796e+00, -1.23002514e-01],
     [ 9.39484313e-03,  7.19204426e-01,  2.06931755e-02],
     [ 2.63385147e-01, -2.12222481e+00,  1.46775618e-01],
     [-2.51970559e-01, -2.12153077e+00,  1.60450473e-01],
     [ 3.83779174e-03,  1.22592449e+00, -9.78838727e-02],
     [ 1.91201791e-01,  1.00385976e+00, -6.21964522e-02],
     [-1.77145526e-01,  9.96228695e-01, -7.55542740e-02],
     [ 1.68482102e-02,  1.38698268e+00,  2.44048554e-02],
     [ 4.01985168e-01,  1.07928419e+00, -7.47655183e-02],
     [-3.98825467e-01,  1.07523870e+00, -9.96334553e-02],
     [ 1.00236952e+00,  1.05217218e+00, -1.35129794e-01],
     [-9.86728609e-01,  1.04515052e+00, -1.40235111e-01],
     [ 1.56646240e+00,  1.06961894e+00, -1.37338534e-01],
     [-1.56946480e+00,  1.05935931e+00, -1.53905824e-01],
     [ 1.75282109e+00,  1.04682994e+00, -1.68231070e-01],
     [-1.75758195e+00,  1.04255080e+00, -1.77773550e-01]],
    dtype=np.float32)


def cutoff_dists_mm(skel: Skeleton) -> np.ndarray:
    """Per-joint cutoff distance in mm from the skeleton's class table.

    Joints whose name contains a class key ('knee', 'hip', ...) get that
    class's cutoff; unknown joints fall back to the max entry.
    """
    table = skel.cutoff_table
    default = max(table.values()) if table else 500
    out = []
    for name in skel.joint_names:
        val = default
        for key, mm in table.items():
            if key in name:
                val = mm
                break
        out.append(val)
    return np.asarray(out, dtype=np.float32)
