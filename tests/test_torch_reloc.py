"""Port parity of relocalisation (tracker/reloc.py::attempt_recovery, its
SBI scoring and the K3 ESM at C = 1, 12 iterations) and the pipeline's
relocalisation policy (tests/test_system.py:397-445 mirrored on the port).

attempt_recovery runs on the scene's ground-truth map in both packages,
each on its own features of the same uint8 frame.  Tolerances: the best
(keyframe, camera), the accept flag exact; the recovered pose 1e-4 (ESM
and the SO3 lift are f32 Gauss-Newton chains on templates blurred in
another summation order); the aligned score 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import C, H, W, jax_scene, n, np_get, port_scene, t

from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.ops.sbi import sbi_zmssd as j_zmssd
from mcptam_tpu.tracker.reloc import attempt_recovery as j_recover
from mcptam_tpu_torch import config as pconfig
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.keyframe import make_frame_features as p_features
from mcptam_tpu_torch.ops.sbi import sbi_zmssd
from mcptam_tpu_torch.system.system import System, _Frame
from mcptam_tpu_torch.tracker.reloc import attempt_recovery


def _panel_frame():
    """Quadrant black/white panels: imagery the map never saw, whose
    structure survives the SBI blur (tests/test_system.py:152-169)."""
    yy, xx = np.mgrid[0:H, 0:W]
    panel = (((yy < H // 2) ^ (xx < W // 2)) * 255).astype(np.uint8)
    return np.broadcast_to(panel, (C, H, W)).copy()


def _best_pair(sbi, ms_sbi, valid):
    scores = np.where(valid, ((sbi[None] - ms_sbi) ** 2).sum((-2, -1)), np.inf)
    flat = int(np.argmin(scores))
    return divmod(flat, C)


@pytest.mark.parametrize("frame", ["near", "panel", "dropout"])
def test_attempt_recovery_matches(frame):
    cams, cfb, cams_sbi, jms, frames = jax_scene()
    _, _, pcams_sbi, pms, _ = port_scene()
    img = _panel_frame() if frame == "panel" else frames[1]
    active = np.array([False, True]) if frame == "dropout" else np.ones(C, bool)
    jfeats = jax.jit(j_features)(jnp.asarray(img, jnp.float32))
    jpose, jok, jscore = jax.jit(
        lambda ms, f, ca: j_recover(ms, cams_sbi, f, cam_active=ca))(jms, jfeats, jnp.asarray(active))
    pfeats = p_features(t(img))
    ppose, pok, pscore = attempt_recovery(pms, pcams_sbi, pfeats, cam_active=t(active))

    valid = n(pms.mkfs.valid)[:, None] & n(pms.mkfs.kf_valid) & active[None]
    assert _best_pair(n(pfeats.sbi), n(pms.mkfs.sbi), valid) == \
        _best_pair(np.asarray(jfeats.sbi), np.asarray(jms.mkfs.sbi), valid)
    assert bool(pok) == bool(jok) == (frame != "panel")
    np.testing.assert_allclose(float(pscore), float(jscore), rtol=1e-3)
    if frame == "panel":
        assert float(pscore) >= 1e5
    else:
        np.testing.assert_allclose(n(ppose.R), np.asarray(jpose.R), rtol=0, atol=1e-4)
        np.testing.assert_allclose(n(ppose.t), np.asarray(jpose.t), rtol=0, atol=1e-4)


def test_sbi_zmssd_matches(rng):
    a = rng.standard_normal((4, 1, 30, 40)).astype(np.float32) * 50
    b = rng.standard_normal((1, 2, 30, 40)).astype(np.float32) * 50
    np.testing.assert_allclose(n(sbi_zmssd(t(a), t(b))), np.asarray(j_zmssd(a, b)), rtol=1e-5)


# ---------------------------------------------------------------------------
# the relocalisation policy of a deep pipeline, over fabricated in-flight
# frames: a draining frame's lost flag is pipeline_depth frames stale
# ---------------------------------------------------------------------------

def _scalars(lost: bool) -> torch.Tensor:
    """A fabricated packed scalar row, as _device_step emits it (54,)."""
    v = np.zeros(54, np.float32)
    v[0] = 1.0 if lost else 0.0
    v[1] = 2.0 if lost else 0.0          # quality BAD / GOOD
    v[6:15] = np.eye(3, dtype=np.float32).reshape(-1)
    return torch.as_tensor(v)


def _reloc_stub(calls, ok=True):
    def fn(ms, feats, cam_active):
        calls.append(1)
        return SE3.identity(device="cpu"), torch.tensor(ok), torch.tensor(0.0)
    return fn


def _pipeline_system():
    cams, cfb, cams_sbi, _, _ = port_scene()
    sys_ = System(cams, cfb, cams_sbi, H, W, pconfig.TrackerConfig(),
                  pconfig.MapMakerConfig(), 384, 4, 2048, pipeline_depth=8)
    sys_.initialized = True
    return sys_


def _push(sys_, fid, lost):
    sys_._inflight.append(_Frame(fid, _scalars(lost), None, None, None,
                                 torch.ones(C, dtype=torch.bool)))


def _drain_one(sys_):
    return sys_._drain_frame(sys_._inflight.popleft(), do_actions=True)


def test_pipeline_reloc_skipped_when_newer_frame_recovered():
    """A stale lost flag must not relocalise when a newer in-flight frame
    has already landed not-lost: the tracker recovered on its own."""
    sys_ = _pipeline_system()
    calls = []
    sys_._reloc_fn = _reloc_stub(calls)
    _push(sys_, 0, True)
    for fid in range(1, 9):
        _push(sys_, fid, fid < 5)
    sys_.frame_count = 9
    info = _drain_one(sys_)
    assert info.lost and not info.relocalized
    assert calls == [], "reloc fired despite a newer recovered frame"


def test_pipeline_reloc_fires_exactly_once_while_lost():
    """Lost across the whole pipeline: draining the stale lost frames
    relocalises once; a success marks every frame dispatched before it."""
    sys_ = _pipeline_system()
    calls = []
    sys_._reloc_fn = _reloc_stub(calls, ok=True)
    for fid in range(8):
        _push(sys_, fid, True)
    sys_.frame_count = 8
    infos = [_drain_one(sys_) for _ in range(8)]
    assert len(calls) == 1, f"reloc fired {len(calls)} times"
    assert infos[0].relocalized and not any(i.relocalized for i in infos[1:])
    assert int(sys_.ts.lost_count) == 0


def test_pipeline_reloc_retries_after_failed_attempt():
    """A failed relocalisation does not suppress later attempts
    (src/Tracker.cc:493-502)."""
    sys_ = _pipeline_system()
    calls = []
    sys_._reloc_fn = _reloc_stub(calls, ok=False)
    for fid in range(3):
        _push(sys_, fid, True)
    sys_.frame_count = 3
    for _ in range(3):
        _drain_one(sys_)
    assert len(calls) == 3, f"failed reloc suppressed retries ({len(calls)})"
