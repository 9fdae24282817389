"""Map persistence (port of mcptam_tpu/system/mapio.py): the full MapState
round-trips through one npz, and ASCII dumps in the spirit of the
reference's map.dat and cameras.dat (src/MapMakerBase.cc:475-579,
src/SystemBase.cc:166-215) are written for inspection.

The npz layout is the JAX package's: ``leaf_{i}`` in the pytree-flatten
order of its MapState, ``n_leaves``, and ``extra_{name}`` session arrays.
The port writes that order down in ``MAP_LEAVES`` (the machine with the
card has no JAX to flatten with), so either package reads the other's
files.
"""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.map.state import MapState, clone_tree

# the JAX MapState's leaves in tree_flatten order: fields in declaration
# order, depth first (SE3 is R then t)
_POINT_FIELDS = ("pos_w", "valid", "bad", "fixed", "optimized", "src_mkf",
                 "src_cam", "src_level", "center_xy", "src_window",
                 "src_window_ok", "center_nc", "right_nc", "down_nc",
                 "pixel_right_w", "pixel_down_w", "in_count", "out_count")
_MKF_FIELDS = ("base_from_world.R", "base_from_world.t", "valid", "fixed",
               "kf_valid", "scene_depth_mean", "scene_depth_sigma", "atlas",
               "corner_atlas", "sbi", "sbi_gx", "sbi_gy", "seq")
_MEAS_FIELDS = ("mkf", "cam", "point", "level", "uv_l0", "valid", "source",
                "subpix")
MAP_LEAVES = (
    tuple(f"points.{f}" for f in _POINT_FIELDS)
    + tuple(f"mkfs.{f}" for f in _MKF_FIELDS)
    + tuple(f"meas.{f}" for f in _MEAS_FIELDS)
    + ("cam_from_base.R", "cam_from_base.t", "next_seq", "no_retry",
       "retry_queue")
)


def _owner(obj, path: str):
    *parents, name = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    return obj, name


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_map(path: str, ms: MapState, extras: dict | None = None):
    """Write the complete MapState to an npz; ``extras`` adds named session
    arrays (tracker pose, scheduler state) beside the map."""
    leaves = {}
    for i, name in enumerate(MAP_LEAVES):
        obj, field = _owner(ms, name)
        leaves[f"leaf_{i}"] = _numpy(getattr(obj, field))
    np.savez_compressed(
        path, n_leaves=len(MAP_LEAVES), **leaves,
        **{f"extra_{k}": _numpy(v) for k, v in (extras or {}).items()})


def load_map(path: str, template: MapState, with_extras: bool = False):
    """Restore a MapState saved by either package's ``save_map``.
    ``template`` gives the capacities, dtypes and device, and must match
    the file's shapes.  With ``with_extras`` returns (ms, extras dict)."""
    with np.load(path) as data:
        n = int(data["n_leaves"])
        if n != len(MAP_LEAVES):
            raise ValueError(f"leaf count mismatch: file {n} vs template {len(MAP_LEAVES)}")
        ms = clone_tree(template)
        for i, name in enumerate(MAP_LEAVES):
            obj, field = _owner(ms, name)
            ref = getattr(obj, field)
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} ({name}) shape mismatch: {a.shape} vs "
                                 f"{tuple(ref.shape)}")
            setattr(obj, field, torch.as_tensor(a).to(device=ref.device, dtype=ref.dtype))
        extras = {k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")}
    return (ms, extras) if with_extras else ms


def dump_cameras_ascii(path: str, cams, cam_from_base, H: int, W: int,
                       names=None):
    """cameras.dat in the reference's CSV layout (SystemBase::
    DumpCamerasToFile): a 3-line comment header, the camera count, then per
    camera one row of name, image size (2), projection centre (2),
    polynomial coefficients a0, a1 = 0, a2, a3, a4 (5), affine c/d/e (3) and
    the inverse-polynomial coefficients on normalised theta."""
    C = int(cam_from_base.t.shape[0])
    poly, center = _numpy(cams.poly), _numpy(cams.center)
    affine, inv_poly = _numpy(cams.affine), _numpy(cams.inv_poly)
    with open(path, "w") as f:
        f.write("% Camera calibration parameters, format:\n")
        f.write("% Total number of cameras\n")
        f.write(
            "% Camera Name, image size (2 vector), projection center "
            "(2 vector), polynomial coefficients (5 vector), affine matrix "
            "components (3 vector), inverse polynomial coefficents "
            "(variable size)\n"
        )
        f.write(f"{C}\n")
        for c in range(C):
            name = names[c] if names is not None else f"camera{c + 1}"
            inv = inv_poly[c]
            nz = np.nonzero(inv)[0]
            inv = inv[: int(nz[-1]) + 1] if nz.size else inv[:1]
            row = [W, H, center[c, 0], center[c, 1],
                   poly[c, 0], 0, poly[c, 2], poly[c, 3], poly[c, 4],
                   affine[c, 0, 0], affine[c, 0, 1], affine[c, 1, 0], *inv]
            f.write(name + ", " + ", ".join(f"{v:.9g}" for v in row) + "\n")
        f.write("% The end")


def dump_map_ascii(path: str, ms: MapState):
    """Human-readable dump: rig extrinsics, MKF poses, points with their
    source patch, measurements."""
    pts, mkfs, meas = ms.points, ms.mkfs, ms.meas
    cfb_R, cfb_t = _numpy(ms.cam_from_base.R), _numpy(ms.cam_from_base.t)
    mR, mt = _numpy(mkfs.base_from_world.R), _numpy(mkfs.base_from_world.t)
    seq, fixed = _numpy(mkfs.seq), _numpy(mkfs.fixed)
    pos = _numpy(pts.pos_w)
    src_mkf, src_cam, src_level = (_numpy(pts.src_mkf), _numpy(pts.src_cam),
                                   _numpy(pts.src_level))
    uv = _numpy(meas.uv_l0)
    k_mkf, k_cam, k_pt, k_lvl, k_src = (_numpy(meas.mkf), _numpy(meas.cam),
                                        _numpy(meas.point), _numpy(meas.level),
                                        _numpy(meas.source))
    with open(path, "w") as f:
        C = cfb_t.shape[0]
        f.write(f"% mcptam_tpu map dump\n% cameras {C}\n")
        for c in range(C):
            f.write("cam " + " ".join(f"{v:.9g}" for v in
                                      list(cfb_R[c].reshape(-1)) + list(cfb_t[c])) + "\n")
        for m in np.nonzero(_numpy(mkfs.valid))[0]:
            f.write(f"mkf {m} seq {int(seq[m])} fixed {int(fixed[m])} "
                    + " ".join(f"{v:.9g}" for v in list(mR[m].reshape(-1)) + list(mt[m]))
                    + "\n")
        for n in np.nonzero(_numpy(pts.valid))[0]:
            f.write(f"point {n} {pos[n, 0]:.9g} {pos[n, 1]:.9g} {pos[n, 2]:.9g} "
                    f"src {int(src_mkf[n])} {int(src_cam[n])} {int(src_level[n])}\n")
        for k in np.nonzero(_numpy(meas.valid))[0]:
            f.write(f"meas mkf {int(k_mkf[k])} cam {int(k_cam[k])} pt "
                    f"{int(k_pt[k])} lvl {int(k_lvl[k])} uv {uv[k, 0]:.4f} "
                    f"{uv[k, 1]:.4f} src {int(k_src[k])}\n")
