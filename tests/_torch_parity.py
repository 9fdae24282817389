"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed; the JAX
package runs on the CPU (tests/conftest.py forces it) and the port on the
CPU too, where every kernel wrapper takes its plain PyTorch version.  Data
crosses between them as numpy arrays only.
"""

from __future__ import annotations

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
    p_cams, p_cfb = p_make_rig(C, H, W, spread_deg=25.0)
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
    return (convert.camera_from_numpy(np_get(cams)),
            convert.se3_from_numpy(np_get(cfb)),
            convert.camera_from_numpy(np_get(cams_sbi)),
            convert.map_state_from_numpy(np_get(ms)),
            frames)
