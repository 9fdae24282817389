"""SBI relocaliser: recover a lost tracker from keyframe appearance (port
of mcptam_tpu/tracker/reloc.py, ref Relocaliser, src/Relocaliser.cc:61-120).

The current frame's SmallBlurryImages are scored against every stored
keyframe SBI of the same camera, the best (keyframe, camera) pair is
ESM-aligned (K3, one camera, 12 iterations), the SE2 is lifted to a camera
rotation, and the keyframe's pose rotated by it gives the recovered base
pose.  Nothing here reads back to the host.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch.core.camera import CameraModel
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.keyframe import FrameFeatures
from mcptam_tpu_torch.map.state import MapState, kf_cam_from_world
from mcptam_tpu_torch.ops.sbi import sbi_zmssd, se3_from_se2
from mcptam_tpu_torch.ops.sbi_kernel import esm_align_all

# sdRecoveryMaxScore (src/Relocaliser.cc:50,83), on the SSD of the aligned
# 40x30 byte-scale templates: ~9.1 grey levels RMS after alignment
RECOVERY_MAX_SCORE = 1e5


def attempt_recovery(ms: MapState, cams_sbi: CameraModel, feats: FrameFeatures,
                     max_score: float = RECOVERY_MAX_SCORE, cam_active=None):
    """Returns (base_from_world SE3, success () bool, aligned score ()).
    A dropped camera (cam_active False) is not scored; success needs a
    scored pair at all and an aligned residual below ``max_score``."""
    C = feats.sbi.shape[0]
    scores = sbi_zmssd(feats.sbi[None], ms.mkfs.sbi)             # (M,C)
    valid = ms.mkfs.valid[:, None] & ms.mkfs.kf_valid
    if cam_active is not None:
        valid = valid & cam_active[None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, float("inf")))
    flat = torch.argmin(scores.reshape(-1))                      # first minimum
    best_m, best_c = flat // C, flat % C
    best_score = scores.reshape(-1)[flat]

    pick = best_c.reshape(1)
    se2, esm_score = esm_align_all(
        feats.sbi[pick].contiguous(), ms.mkfs.sbi[best_m, pick].contiguous(),
        ms.mkfs.sbi_gx[best_m, pick].contiguous(),
        ms.mkfs.sbi_gy[best_m, pick].contiguous(), n_iterations=12)
    cam = cams_sbi[pick]
    R_rel = se3_from_se2(se2, cam, cam)[0]       # keyframe rays -> current rays

    kcw = kf_cam_from_world(ms)
    kf_pose = SE3(R=kcw.R[best_m, best_c], t=kcw.t[best_m, best_c])
    cam_pose = SE3(R=R_rel, t=torch.zeros_like(kf_pose.t)) @ kf_pose
    base_pose = ms.cam_from_base[best_c].inv() @ cam_pose
    success = torch.isfinite(best_score) & (esm_score[0] < max_score)
    return base_pose, success, esm_score[0]
