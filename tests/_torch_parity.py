"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed; the JAX
package runs on the CPU (tests/conftest.py forces it) and the port on the
CPU too, where every kernel wrapper takes its plain PyTorch version.  Data
crosses between them as numpy arrays only.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mcptam_tpu_torch  # noqa: F401  (precision flags)
from mcptam_tpu_torch import convert

# one xdist worker per process: keep torch from oversubscribing the cores
torch.set_num_threads(1)

# the small scene the parity tests share (tests/test_system.py's sizes)
H, W, C = 240, 320, 2
SEED = 3.0
MAX_POINTS, MAX_MKFS, MAX_MEAS = 384, 4, 2048
N_PER_LEVEL = 40


def np_get(tree):
    """JAX pytree -> the same pytree with numpy leaves."""
    return jax.device_get(tree)


def t(a, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (copy)."""
    x = torch.as_tensor(np.array(a, copy=True))
    return x if dtype is None else x.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def traj_tangent(i: int) -> np.ndarray:
    """Small smooth rig motion for the parity frames."""
    return np.array([0.006 * i, -0.002 * i, 0.005 * i,
                     0.0015 * i, -0.001 * i, 0.0005 * i], np.float32)


def jax_tree_from_numpy(template, src):
    """Fill a JAX package pytree (a flax struct) with numpy leaves taken by
    field name from ``src`` (nested dicts, as convert.to_numpy gives);
    fields absent from ``src`` keep the template's values."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(template):
        if f.name not in src:
            continue
        val = getattr(template, f.name)
        if dataclasses.is_dataclass(val):
            kw[f.name] = jax_tree_from_numpy(val, src[f.name])
        else:
            kw[f.name] = jnp.asarray(src[f.name], dtype=val.dtype)
    return template.replace(**kw)


@functools.lru_cache(maxsize=None)
def jax_scene():
    """The shared scene: the JAX package's rig and SBI cameras, a
    ground-truth map, and three uint8 frames rendered by the JAX package
    along a short trajectory (built once per process).

    The map is built by the port and carried into the JAX package's
    MapState: the JAX builder scatters unplaced point requests onto the
    first placed slot (map/builder.py add_points), which reverts that slot
    in its op-by-op form and garbles points under jit, while its op-by-op
    form costs ~45 s on the CPU.  tests/test_torch_slice.py holds the
    port's builder against the JAX one on requests that are all placed."""
    from mcptam_tpu.core.se3 import SE3
    from mcptam_tpu.io.synthetic import make_rig, make_sbi_cams, render_rig
    from mcptam_tpu.map.state import create_map_state
    from mcptam_tpu_torch.io.synthetic import (
        build_groundtruth_map, make_rig as p_make_rig,
    )

    cams, cfb = make_rig(C, H, W, spread_deg=25.0)
    cams_sbi = make_sbi_cams(cams, H, W)
    p_cams, p_cfb = p_make_rig(C, H, W, spread_deg=25.0, device="cpu")
    p_ms, _ = build_groundtruth_map(
        p_cams, p_cfb, H, W, n_per_level=N_PER_LEVEL, max_points=MAX_POINTS,
        max_mkfs=MAX_MKFS, max_meas=MAX_MEAS,
    )
    ms = jax_tree_from_numpy(
        create_map_state(H, W, C, cfb, MAX_POINTS, MAX_MKFS, MAX_MEAS),
        convert.to_numpy(p_ms),
    )
    frames = np.stack([
        np.asarray(jnp.clip(render_rig(
            cams, cfb, SE3.exp(jnp.asarray(traj_tangent(i))), SEED, H, W,
        ), 0, 255)).astype(np.uint8)
        for i in range(3)
    ])
    return cams, cfb, cams_sbi, ms, frames


def port_scene():
    """The JAX scene converted into the port's dataclasses (fresh copies)."""
    cams, cfb, cams_sbi, ms, frames = jax_scene()
    return (convert.camera_from_numpy(np_get(cams), device="cpu"),
            convert.se3_from_numpy(np_get(cfb), device="cpu"),
            convert.camera_from_numpy(np_get(cams_sbi), device="cpu"),
            convert.map_state_from_numpy(np_get(ms), device="cpu"),
            frames)


# the map-maker tests' scene: a sparser ground-truth map (12 candidates a
# level, so coarse corners stay free for point creation) and keyframes
# rendered at sideways offsets large enough to pass the large-point test
MAP_N_PER_LEVEL = 12
MKF_TANGENTS = [
    np.array([0.12 * k, 0.0, 0.02 * k, 0.0, 0.01 * k, 0.0], np.float32)
    for k in (1, 2, 3)
]


@functools.lru_cache(maxsize=None)
def mapping_scene():
    """(JAX cams, JAX cam_from_base, the ground-truth map as numpy, and
    for each MKF_TANGENTS pose its JAX FrameFeatures as numpy), built once
    per process; the map is built by the port, as in jax_scene."""
    from mcptam_tpu.core.se3 import SE3
    from mcptam_tpu.io.synthetic import render_rig
    from mcptam_tpu.map.keyframe import make_frame_features
    from mcptam_tpu_torch.io.synthetic import (
        build_groundtruth_map, make_rig as p_make_rig,
    )

    cams, cfb, _, _, _ = jax_scene()
    p_cams, p_cfb = p_make_rig(C, H, W, spread_deg=25.0, device="cpu")
    p_ms, _ = build_groundtruth_map(
        p_cams, p_cfb, H, W, n_per_level=MAP_N_PER_LEVEL,
        max_points=MAX_POINTS, max_mkfs=MAX_MKFS, max_meas=MAX_MEAS)
    feats_fn = jax.jit(make_frame_features)
    feats = []
    for v in MKF_TANGENTS:
        img = jnp.clip(render_rig(cams, cfb, SE3.exp(jnp.asarray(v)), SEED, H, W),
                       0, 255).astype(jnp.uint8)
        feats.append(np_get(feats_fn(img.astype(jnp.float32))))
    return cams, cfb, convert.to_numpy(p_ms), tuple(feats)


def jax_map(ms_np):
    """A numpy MapState tree (convert.to_numpy) as the JAX MapState."""
    from mcptam_tpu.map.state import create_map_state

    cams, cfb, _, _, _ = jax_scene()
    return jax_tree_from_numpy(
        create_map_state(H, W, C, cfb, MAX_POINTS, MAX_MKFS, MAX_MEAS), ms_np)


def synthetic_track_result(ms_np, cams_port, tangent, K=64, seed=0):
    """The sel_* fields a tracker result hands the map-maker, made up from
    the map: K (camera, point) pairs that project into the frame at
    ``tangent``, found at the projection plus 0.3 px noise, a few not
    found and a few Tukey outliers.  numpy dict."""
    from mcptam_tpu_torch.core.camera import project
    from mcptam_tpu_torch.core.se3 import SE3

    rng = np.random.default_rng(seed)
    pose = SE3.exp(t(tangent))
    cfb = SE3(R=t(ms_np["cam_from_base"]["R"]), t=t(ms_np["cam_from_base"]["t"]))
    pos = t(ms_np["points"]["pos_w"])
    cands = []
    for c in range(C):
        uv, ok = project(cams_port[c], (cfb[c] @ pose).apply(pos))
        ok = n(ok) & ms_np["points"]["valid"]
        cands += [(c, int(p), n(uv)[p]) for p in np.flatnonzero(ok)]
    pick = rng.choice(len(cands), K, replace=False)
    sel = [cands[i] for i in pick]
    return {
        "sel_cam": np.array([s[0] for s in sel], np.int32),
        "sel_point": np.array([s[1] for s in sel], np.int32),
        "sel_level": ms_np["points"]["src_level"][[s[1] for s in sel]].astype(np.int32),
        "sel_pos_l0": (np.stack([s[2] for s in sel])
                       + rng.normal(size=(K, 2)) * 0.3).astype(np.float32),
        "sel_found": rng.random(K) > 0.1,
        "sel_outlier": rng.random(K) < 0.1,
        "sel_subpix": np.ones(K, bool),
    }


@contextlib.contextmanager
def jax_builder_drops_unplaced():
    """Repair, in this process only, the JAX builder's scatter fault
    (ROADMAP section C): alloc_slots gives an unplaced request the slot of
    the first placed one, and under jit the unplaced write reverts it.
    Inside this context unplaced requests get an out-of-range slot, whose
    writes JAX drops — what the port's builder does.  The package's files
    are not touched."""
    import mcptam_tpu.map.builder as jbuilder

    orig = jbuilder.alloc_slots

    def alloc_slots(free, want):
        slot, ok = orig(free, want)
        return jnp.where(ok, slot, free.shape[0]), ok

    jbuilder.alloc_slots = alloc_slots
    try:
        yield
    finally:
        jbuilder.alloc_slots = orig
