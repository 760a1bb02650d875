"""SMPL-X body model data: the release-npz loader and a procedural stand-in.

Port (a numpy copy) of humangaussian_tpu/smplx/model.py. `SMPLXModel`
holds numpy arrays as loaded; `humangaussian_torch.convert.smplx_from_numpy`
moves it onto a device for `smplx.lbs.lbs_forward`.

The `extra landmark` vertex ids (nose/eyes/ears/feet/fingertips) follow
the smplx package's public vertex_ids table, so joint indices 55..75 line
up with the joint mappers of the reference implementation.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

NUM_JOINTS = 55  # SMPL-X skeleton joints under LBS
NUM_BODY_JOINTS = 21  # body joints (excl. global orient, hands, face)

# vertex landmarks appended after the 55 LBS joints, in smplx package
# order (VertexJointSelector): 5 face + 6 feet + 10 fingertips
EXTRA_LANDMARK_NAMES = (
    "nose", "right_eye", "left_eye", "right_ear", "left_ear",
    "left_big_toe", "left_small_toe", "left_heel",
    "right_big_toe", "right_small_toe", "right_heel",
    "left_thumb", "left_index", "left_middle", "left_ring", "left_pinky",
    "right_thumb", "right_index", "right_middle", "right_ring", "right_pinky",
)
SMPLX_LANDMARK_VERTEX_IDS = np.array(
    [
        9120, 9929, 9448, 616, 6,  # nose, reye, leye, rear, lear
        5770, 5780, 8846,  # left toe/toe/heel
        8463, 8474, 8635,  # right toe/toe/heel
        5361, 4933, 5058, 5169, 5286,  # left fingertips
        8079, 7669, 7794, 7905, 8022,  # right fingertips
    ],
    dtype=np.int32,
)


class SMPLXModel(NamedTuple):
    """SMPL-X template + blend-shape + skinning data (numpy arrays, or
    tensors after `convert.smplx_from_numpy`)."""

    v_template: np.ndarray  # [V,3]
    shapedirs: np.ndarray  # [V,3,n_betas]
    exprdirs: np.ndarray  # [V,3,n_expr]
    posedirs: np.ndarray  # [V,3,(J-1)*9]
    j_regressor: np.ndarray  # [J,V]
    lbs_weights: np.ndarray  # [V,J]
    parents: np.ndarray  # [J] int32, parents[0] == -1
    faces: np.ndarray  # [F,3] int32
    landmark_vertex_ids: np.ndarray  # [L] int32
    hands_mean: np.ndarray  # [30*3] left+right hand mean pose (axis-angle)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]


def load_smplx_npz(
    path: str,
    gender: str = "neutral",
    num_betas: int = 10,
    num_expression: int = 10,
) -> SMPLXModel:
    """Load a standard SMPL-X release npz (e.g. SMPLX_NEUTRAL.npz).

    `path` may be the npz itself or a directory containing
    `smplx/SMPLX_{GENDER}.npz` (the layout smplx.create expects).
    """
    if os.path.isdir(path):
        cand = [
            os.path.join(path, "smplx", f"SMPLX_{gender.upper()}.npz"),
            os.path.join(path, f"SMPLX_{gender.upper()}.npz"),
        ]
        for c in cand:
            if os.path.exists(c):
                path = c
                break
        else:
            raise FileNotFoundError(f"no SMPL-X npz under {path!r}: {cand}")
    with np.load(path, allow_pickle=True) as d:
        shapedirs_all = np.asarray(d["shapedirs"], np.float32)
        # smplx convention: columns 0:300 shape, 300:400 expression
        if shapedirs_all.shape[-1] > 300:
            shapedirs = shapedirs_all[..., :num_betas]
            exprdirs = shapedirs_all[..., 300 : 300 + num_expression]
        else:
            shapedirs = shapedirs_all[..., :num_betas]
            exprdirs = np.zeros(
                shapedirs.shape[:2] + (num_expression,), np.float32
            )
        posedirs = np.asarray(d["posedirs"], np.float32)
        if posedirs.ndim == 2:  # some releases store [(J-1)*9, V*3]
            posedirs = posedirs.reshape(posedirs.shape[0], -1, 3).transpose(
                1, 2, 0
            )
        kintree = np.asarray(d["kintree_table"], np.int64)
        parents = kintree[0].astype(np.int32)
        parents[0] = -1
        hands_mean = np.concatenate(
            [
                np.asarray(d["hands_meanl"], np.float32).reshape(-1),
                np.asarray(d["hands_meanr"], np.float32).reshape(-1),
            ]
        ) if "hands_meanl" in d else np.zeros((90,), np.float32)
        return SMPLXModel(
            v_template=np.asarray(d["v_template"], np.float32),
            shapedirs=shapedirs,
            exprdirs=exprdirs,
            posedirs=posedirs,
            j_regressor=np.asarray(d["J_regressor"], np.float32),
            lbs_weights=np.asarray(d["weights"], np.float32),
            parents=parents,
            faces=np.asarray(d["f"], np.int32),
            landmark_vertex_ids=SMPLX_LANDMARK_VERTEX_IDS.copy(),
            hands_mean=hands_mean,
        )


def toy_model(
    n_ring: int = 16, n_seg_per_bone: int = 6, radius: float = 0.05
) -> SMPLXModel:
    """Tiny procedural articulated model with the SMPL-X joint COUNT and
    kinematic layout, for tests without the licensed model file.

    A vertical capsule-ish tube is skinned to the spine chain
    (pelvis -> spine1/2/3 -> neck -> head); all other joints (hips, limbs,
    hands, face) sit at plausible offsets with rigid weights on the
    nearest ring so every joint moves *something*. Landmark vertex ids
    point at distinct tube vertices.
    """
    j = NUM_JOINTS
    # standard SMPL-X parent table
    parents = np.array(
        [
            -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
            17, 18, 19, 15, 22, 23,
            20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
            21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
        ],
        dtype=np.int32,
    )
    assert parents.shape[0] == j

    # joint rest positions: spine along +y, limbs off to the sides
    joints = np.zeros((j, 3), np.float32)
    spine = {0: 0.0, 3: 0.15, 6: 0.3, 9: 0.45, 12: 0.6, 15: 0.7}
    for idx, y in spine.items():
        joints[idx] = (0.0, y, 0.0)
    joints[1] = (-0.08, -0.05, 0.0)  # left hip
    joints[2] = (0.08, -0.05, 0.0)  # right hip
    joints[4] = (-0.09, -0.4, 0.0)  # knees
    joints[5] = (0.09, -0.4, 0.0)
    joints[7] = (-0.09, -0.8, 0.0)  # ankles
    joints[8] = (0.09, -0.8, 0.0)
    joints[10] = (-0.09, -0.85, 0.1)  # feet
    joints[11] = (0.09, -0.85, 0.1)
    joints[13] = (-0.07, 0.55, 0.0)  # collars
    joints[14] = (0.07, 0.55, 0.0)
    joints[16] = (-0.15, 0.55, 0.0)  # shoulders
    joints[17] = (0.15, 0.55, 0.0)
    joints[18] = (-0.4, 0.55, 0.0)  # elbows
    joints[19] = (0.4, 0.55, 0.0)
    joints[20] = (-0.65, 0.55, 0.0)  # wrists
    joints[21] = (0.65, 0.55, 0.0)
    joints[22] = (0.0, 0.72, 0.05)  # jaw
    joints[23] = (-0.03, 0.75, 0.05)  # eyes
    joints[24] = (0.03, 0.75, 0.05)
    for f in range(25, 40):  # left fingers around the wrist
        joints[f] = joints[20] + (-(0.02 + 0.01 * (f - 25)), 0.0, 0.0)
    for f in range(40, 55):
        joints[f] = joints[21] + ((0.02 + 0.01 * (f - 40)), 0.0, 0.0)

    # tube vertices along the spine, one ring per segment
    chain = [0, 3, 6, 9, 12, 15]
    ys = np.linspace(-0.05, 0.75, len(chain) * n_seg_per_bone)
    theta = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    verts, weights = [], []
    for y in ys:
        ring = np.stack(
            [radius * np.cos(theta), np.full_like(theta, y), radius * np.sin(theta)],
            axis=1,
        )
        verts.append(ring)
        # weight: linear blend between the two nearest chain joints
        yj = np.array([joints[c][1] for c in chain])
        upper = np.clip(np.searchsorted(yj, y), 1, len(chain) - 1)
        lower = upper - 1
        t = np.clip((y - yj[lower]) / max(yj[upper] - yj[lower], 1e-6), 0, 1)
        w = np.zeros((n_ring, j), np.float32)
        w[:, chain[lower]] = 1.0 - t
        w[:, chain[upper]] = t
        weights.append(w)
    v_template = np.concatenate(verts).astype(np.float32)
    lbs_weights = np.concatenate(weights).astype(np.float32)
    v = v_template.shape[0]

    # append one anchor vertex per joint, rigidly skinned to it, so the
    # regressor recovers the exact joint positions and the anchors track
    # their joints rigidly (handy for assertions)
    v_template = np.concatenate([v_template, joints]).astype(np.float32)
    anchor_w = np.eye(j, dtype=np.float32)
    lbs_weights = np.concatenate([lbs_weights, anchor_w]).astype(np.float32)
    v = v_template.shape[0]
    j_regressor = np.zeros((j, v), np.float32)
    j_regressor[:, v - j :] = anchor_w

    # faces: triangulate consecutive rings
    faces = []
    n_rows = len(ys)
    for r in range(n_rows - 1):
        for k in range(n_ring):
            a = r * n_ring + k
            b = r * n_ring + (k + 1) % n_ring
            c = (r + 1) * n_ring + k
            d = (r + 1) * n_ring + (k + 1) % n_ring
            faces.append((a, b, c))
            faces.append((b, d, c))
    faces = np.array(faces, np.int32)

    landmark_ids = (np.arange(len(EXTRA_LANDMARK_NAMES)) * 7 % v).astype(np.int32)
    return SMPLXModel(
        v_template=v_template,
        shapedirs=np.zeros((v, 3, 10), np.float32),
        exprdirs=np.zeros((v, 3, 10), np.float32),
        posedirs=np.zeros((v, 3, (j - 1) * 9), np.float32),
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        parents=parents,
        faces=faces,
        landmark_vertex_ids=landmark_ids,
        hands_mean=np.zeros((90,), np.float32),
    )
