"""Static sizing + tunable parameters, the PyTorch port's copy of
``mcptam_tpu/config.py``.

Every constant and every dataclass default equals the JAX package's
(tests/test_torch_config.py holds them equal).  Capacities stay static:
the port keeps the reference's fixed-capacity masked arrays, so tensor
shapes never depend on data and a batch step needs no host sync.

Two fields are carried for config equality but not read by the port:
``TrackerConfig.use_pallas_esm`` (the port's ESM wrapper picks its path
from the tensor's device alone) and the map-maker knobs of
``MapMakerConfig`` beyond those the tracking slice uses.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Hard static sizes (shape-determining; changing these retriggers compilation)
# ---------------------------------------------------------------------------

LEVELS = 4  # pyramid levels, reference include/mcptam/KeyFrame.h:85

# Max cameras in a rig (reference caps synchronized groups at 8:
# include/mcptam/CameraGroupSubscriber.h:144-146).
MAX_CAMERAS = 8

# Map capacities (reference is unbounded; sized generously vs. typical PTAM
# maps of a few thousand points / tens of keyframes).
MAX_POINTS = 4096
MAX_MKFS = 48

# Per-level FAST corner capacity (fixed lists replace the reference's
# row-LUT + std::vector<ImageRef> per level, src/KeyFrame.cc:348-355).
MAX_CORNERS_PER_LEVEL = (2048, 1024, 512, 256)

# Candidate (corner good enough to become a map point) capacity per level
# (reference keeps top 80% by score, src/KeyFrame.cc:417-452).
MAX_CANDIDATES_PER_LEVEL = (512, 256, 128, 64)

# Measurement capacity for bundle adjustment flat arrays.
MAX_MEAS = 32768

# Patch size used by PatchFinder templates (reference src/PatchFinder.h: 8x8
# zero-mean SSD patches).
PATCH_SIZE = 8

# SmallBlurryImage size (reference src/SmallBlurryImage.cc:50).
SBI_SIZE = (30, 40)  # rows, cols

# Side of the per-point source patch window stored in the map
# (= 2 * template source half-size + 2; see ops/batch_patch._SRC_HALF).
SRC_WINDOW = 26

# Degree cap for the inverse Taylor polynomial fit
# (reference include/mcptam/TaylorCamera.h:74 MAX_INV_DEGREE=30).
MAX_INV_DEGREE = 30


# ---------------------------------------------------------------------------
# Tunables (runtime parameters; mirror LoadStaticParams* defaults)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracking front-end tunables (reference src/Tracker.cc:69-84)."""

    max_patches_per_frame: int = 1000
    min_patches_per_frame: int = 10
    coarse_min: int = 15
    coarse_max: int = 60
    coarse_range: int = 30         # search radius (px) in coarse stage
    coarse_sub_pix_its: int = 8
    fine_sub_pix_its: int = 10
    fine_range_first: int = 10     # fine search radius for L0 when no coarse
    fine_range: int = 5            # fine search radius otherwise
    coarse_iterations: int = 10
    fine_iterations: int = 10
    quality_good: float = 0.3      # found/attempted ratio thresholds
    quality_bad: float = 0.13      # (reference src/Tracker.cc:1576-1658)
    lost_frame_thresh: int = 3
    # DODGY demotes to BAD when the depth-scaled distance to the nearest
    # MKF exceeds this (= 3 x sdMaxScaledMKFDist, ref
    # src/MapMakerClientBase.cc:209-210)
    excessive_mkf_dist: float = 0.3
    collect_all_points: bool = True
    # ZMSSD acceptance budget per template pixel (snMaxSSDPerPixel,
    # src/PatchFinder.cc:44: 250 default, 500 in calibrator mode)
    max_ssd_per_pixel: float = 250.0
    tracking_prior: float = 100.0  # WLS prior (reference src/Tracker.cc:1391)
    mest_sigma_min: float = 0.4    # min sigma-squared floor
    use_sbi_rotation: bool = True  # SBI-ESM rotation in the motion model
    # the JAX package's switch for its Pallas ESM kernel.  Kept so the two
    # configs compare equal; the port does not read it: a CUDA tensor
    # always takes the hand-written ESM kernel, a CPU tensor its plain
    # version (ops/sbi_kernel.py).
    use_pallas_esm: bool = True


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Pyramid/FAST tunables (reference src/KeyFrame.cc:64-71,247-342)."""

    min_fast_thresh: int = 5
    max_fast_thresh: int = 60
    fixed_thresholds: tuple = (10, 15, 15, 10)
    adaptive_thresh: bool = True
    # target corner-count derivative: -W*H/dAdaptTarget (reference
    # src/KeyFrame.cc:288, sdAdaptThreshTarget default)
    adapt_target_divisor: float = 500.0
    candidate_top_fraction: float = 0.8
    shi_tomasi_radius: int = 1     # 3x3 window


@dataclasses.dataclass(frozen=True)
class MapMakerConfig:
    """Map-maker tunables (reference src/MapMakerServerBase.cc:56-64,
    src/MapMakerClientBase.cc (queue heuristics), src/MapMaker.cc)."""

    init_depth: float = 3.0
    min_map_points: int = 20
    # sdMaxScaledMKFDist (ref src/MapMakerClientBase.cc:49); the effective
    # threshold shrinks further by the map-size factor in need_new_mkf
    max_scaled_mkf_dist: float = 0.1
    min_outliers: int = 20
    outlier_multiplier: float = 1.0
    init_cov_thresh: float = 1.0
    max_consecutive_failed_ba: int = 5
    # on the BA-failure reset chain, dump the full map in the reference's
    # ASCII format first (ref fail_map.dat, src/MapMakerBase.cc:143-148);
    # empty = disabled
    fail_dump_path: str = ""
    # epipolar search: arc samples per candidate (the reference instead
    # steps the arc at ~3 px via OnePixelAngle; static here for XLA)
    # static epipolar-arc hypothesis budget: arcs up to (NH-1) x 3 source
    # px sample at >= the reference's stepping density
    # (src/MapMakerServerBase.cc:700-702).  0 = AUTO: bucket (32/64/128)
    # from the rig's actual worst-case arc length at map-maker setup
    # (map/epipolar.py::auto_hypothesis_budget) — use this for
    # wide-baseline rigs, whose long arcs a fixed 32 under-samples.  The
    # DEFAULT stays 32: a blanket 64 was measured to ADD marginal
    # triangulations on the synthetic close-rig scene (tracking err
    # 0.03 -> 0.05), so denser is not blindly better.
    epi_max_hypotheses: int = 32
    # ambiguity-rule formulation for the epipolar arc: False = the
    # reference's index-adjacency test (proven on the close-rig scenes,
    # the right rule at <= 32 samples); True = the density-invariant
    # corner-space rule dense auto-bucketed budgets need (the index
    # proxy self-sabotages when sampling is denser than ~3 px — see
    # map/epipolar.py).  _resolve_epi_budget sets this automatically
    # when an AUTO budget buckets above 32.
    epi_corner_ambiguity: bool = False
    max_new_points_per_level: tuple = (100, 100, 100, 100)
    # reject a new MKF if no level>=2 point could be triangulated against
    # the map (sbLargePointTest, src/MapMakerServerBase.cc:63,374,397-401)
    large_point_test: bool = True
    # candidate thinning radius in level px near existing measurements
    # (ThinCandidates, src/MapMakerServerBase.cc:411-447)
    thin_radius: float = 10.0
    # wall-clock budget (ms) for map-maker ticks per tracked frame; 0 =
    # exactly one tick.  A positive budget approximates the reference's
    # free-running map-maker thread (<=500 Hz, src/MapMaker.cc:133)
    # inside the single-chip interleaved schedule.
    duty_budget_ms: float = 0.0
    # runtime-mutable GUI variables in the reference (GVars3,
    # src/System.cc:114-131): epipolar partner = other camera vs temporal
    # same-camera; whether level-0 candidates become map points
    cross_camera: bool = True
    level_zero_points: bool = True


@dataclasses.dataclass(frozen=True)
class BundleConfig:
    """LM bundle-adjustment tunables (reference src/ChainBundle.cc:1132-1136)."""

    max_iterations: int = 100
    update_rms_conv: float = 1e-10
    residual_delta_conv: float = 1e-10
    min_sigma_px: float = 0.5
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    tukey_outlier_sigmas: float = 4.6851  # tukey hard cutoff c
    recent_num: int = 3                    # local BA window, BundleAdjusterBase.cc:48
    recent_min_size: int = 8
    # static per-point observation capacity of the grouped normal-equation
    # layout (ba/bundle.attach_obs_table); a point observed in more
    # (MKF,cam) pairs keeps obs_cap of them in the Hessian
    obs_cap: int = 24


DEFAULT_TRACKER = TrackerConfig()
DEFAULT_FEATURES = FeatureConfig()
DEFAULT_MAPMAKER = MapMakerConfig()
DEFAULT_BUNDLE = BundleConfig()
