"""Sharding over devices for rig-scale and map-scale parallelism (port of
mcptam_tpu/parallel/mesh.py).

The JAX package runs one controller over a device mesh and lets XLA insert
the collectives its sharding annotations imply.  The port runs one process
a device, as ``torchrun`` starts them, over one ``torch.distributed``
process group (the mesh axis "d"), with the collectives written out
(parallel/collectives.py): NCCL between GPUs, gloo between CPU processes.

Every rank is handed the whole inputs, as ``jax.device_put`` from the host
hands over whole arrays, keeps its shard, and gets the whole result, so
that the result can be held against the unsharded function's.  Sharding
spreads the work and never changes what is computed:

  * BA on the observation-table layout (the map-maker's): the point axis,
    with the table rows; pose blocks, the Schur correction, the median's
    counts and the costs are summed over the ranks, and every rank solves
    the same reduced system (``sharded_lm_run_soa``);
  * BA without a table: the measurement axis; the normal equations, the
    median's counts and the costs are summed (``sharded_lm_run``);
  * the map-maker's epipolar search: the candidate axis, the keyframes
    replicated; the outputs are gathered (``sharded_epipolar_match``);
  * tracking: the map's point axis; the PVS runs on each rank's points,
    each selected pair is searched on its point's rank, the pose solve is
    replicated on the gathered pairs (``sharded_track_frame``);
  * the frame front-end: the image rows, with halos; the histograms are
    summed and the bands and candidates gathered
    (``sharded_frame_features``).

Sums taken over the ranks round differently from the unsharded sums, so
BA's floats agree within a tolerance at more than one rank; the tracker,
the epipolar search and the front-end gather and never add across ranks.
At one rank every path computes exactly what the unsharded function does.

Run it on GPUs with ``torchrun --nproc-per-node N script.py`` (NCCL, a
rank a GPU); on the CPU with ``make_mesh(device="cpu")`` in processes that
joined one gloo group (or in one process, a single-rank group).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from mcptam_tpu_torch.ba.bundle import create_lm_state, lm_run
from mcptam_tpu_torch.config import DEFAULT_BUNDLE, DEFAULT_FEATURES
from mcptam_tpu_torch.map.epipolar import epipolar_match
from mcptam_tpu_torch.map.keyframe import make_frame_features
from mcptam_tpu_torch.parallel.collectives import gather_cat, shard_range
from mcptam_tpu_torch.tracker.tracker import track_frame

AXIS = "d"


@dataclass
class Mesh:
    """One process group of ranks, one device each, on the axis ``AXIS``."""
    group: object            # the torch.distributed process group
    rank: int
    world: int
    device: torch.device
    axis: str = AXIS
    owns_group: bool = False  # make_mesh created the group: close() ends it
    store_dir: str | None = None  # and the single-rank group's file store

    def close(self):
        """End the process group if ``make_mesh`` created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None


def make_mesh(n_devices: int | None = None, device: str = "cuda",
              backend: str | None = None) -> Mesh:
    """The mesh of this process's group: the default process group if one
    is initialised (``torchrun`` or the caller set it up), else one made
    from ``torchrun``'s environment (``WORLD_SIZE`` set), else a
    single-rank group over a file store in a temporary directory.

    device "cuda" (the default) takes ``cuda:<LOCAL_RANK>`` and NCCL and
    raises when CUDA is missing; "cpu" takes gloo.  ``backend`` names
    another backend only on explicit request (gloo between ranks that
    share one GPU).  n_devices, if given, must be the group's size."""
    dev_type = torch.device(device).type
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass device='cpu' "
                           "for a gloo mesh on the CPU")
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: device {device!r} is neither cuda nor cpu")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    owns, store_dir = False, None
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            store_dir = tempfile.mkdtemp(prefix="mcptam_mesh_")
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        owns = True
    elif backend not in dist.get_backend():   # e.g. "cpu:gloo,cuda:nccl"
        raise ValueError(f"make_mesh: the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices = {n_devices}, but the process group "
                         f"has {world} ranks; start one process a device")
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh(group=dist.group.WORLD, rank=rank, world=world, device=dev,
                owns_group=owns, store_dir=store_dir)


def _rows(x, lo: int, hi: int):
    return None if x is None else x[lo:hi].clone()


def shard_bundle_problem(mesh: Mesh, prob):
    """This rank's block of a bundle problem's measurements: every ``m_*``
    array cut to [k0, k1) of its K, the parameters whole (the normal
    equations are summed over the ranks).  K must divide by the ranks.
    Returns (local problem, (k0, k1))."""
    k0, k1 = shard_range(prob.m_valid.shape[0], mesh.group, "measurements K")
    kw = {f.name: _rows(getattr(prob, f.name), k0, k1)
          for f in dataclasses.fields(prob) if f.name.startswith("m_")}
    return prob.replace(**kw), (k0, k1)


def sharded_lm_run(mesh: Mesh, prob, cams, n_steps: int, bcfg=None):
    """An LM run of a problem without an observation table, its
    measurements sharded over the mesh.  Returns (final LMState, the same
    on every rank; this rank's problem)."""
    bcfg = bcfg or DEFAULT_BUNDLE
    local, _ = shard_bundle_problem(mesh, prob)
    st = create_lm_state(local, bcfg)
    return lm_run(local, st, cams, n_steps, bcfg, group=mesh.group), local


_PT_FIELDS = ("points", "movable_pt", "obs_idx", "obs_valid",
              "pt_src_a", "pt_src_b", "pt_index", "pt_index_ok")


def shard_bundle_problem_soa(mesh: Mesh, prob):
    """This rank's block of the production (observation-table) layout: the
    point rows [l0, l1) of the points, their movable mask, the table and
    the source-chain indices; the K-sized measurement arrays stay whole,
    with ``m_valid`` kept to the measurements of this rank's points and
    ``m_point`` in local rows, so every table index reads them as it
    reads the whole problem's.  L must divide by the ranks.  Returns
    (local problem, (l0, l1))."""
    if prob.obs_idx is None:
        raise ValueError("shard_bundle_problem_soa needs an attached observation "
                         "table (ba.bundle.attach_obs_table)")
    l0, l1 = shard_range(prob.points.shape[0], mesh.group, "points L")
    kw = {name: _rows(getattr(prob, name), l0, l1) for name in _PT_FIELDS}
    mine = (prob.m_point >= l0) & (prob.m_point < l1)
    kw["m_valid"] = prob.m_valid & mine
    kw["m_point"] = torch.where(mine, prob.m_point - l0, torch.zeros_like(prob.m_point))
    return prob.replace(**kw), (l0, l1)


def sharded_lm_run_soa(mesh: Mesh, prob_t, cams, n_steps: int, bcfg=None):
    """An LM run over the production layout (observation table attached,
    extrinsics fixed) with the point axis sharded over the mesh.  L must
    divide by the ranks.  Returns (final LMState with every point, the
    same on every rank; this rank's problem)."""
    bcfg = bcfg or DEFAULT_BUNDLE
    local, _ = shard_bundle_problem_soa(mesh, prob_t)
    st = lm_run(local, create_lm_state(local, bcfg), cams, n_steps, bcfg,
                fixed_b=True, group=mesh.group)
    return dataclasses.replace(st, points=gather_cat(st.points, mesh.group)), local


def shard_map_points(mesh: Mesh, ms):
    """This rank's block of a MapState's points: every point array cut to
    the rows [n0, n1) (copies); keyframes, measurements and the rest
    whole.  The point capacity must divide by the ranks.  Returns
    (local MapState, (n0, n1))."""
    pts = ms.points
    n0, n1 = shard_range(pts.capacity, mesh.group, "point capacity N")
    local = dataclasses.replace(pts, **{f.name: getattr(pts, f.name)[n0:n1].clone()
                                        for f in dataclasses.fields(pts)})
    return dataclasses.replace(ms, points=local), (n0, n1)


def sharded_frame_features(mesh: Mesh, images):
    """make_frame_features with the image ROW axis sharded over the mesh:
    each rank builds and scores its rows with a halo, the histograms are
    summed and the bands and candidates gathered (map/keyframe.py).  The
    rows must divide by 8 x the ranks.  Returns (fn, images on the mesh's
    device); fn(images, fcfg=...) gives the whole FrameFeatures on every
    rank."""
    def fn(imgs, fcfg=DEFAULT_FEATURES):
        return make_frame_features(imgs, fcfg=fcfg, group=mesh.group)

    return fn, images.to(mesh.device)


def sharded_epipolar_match(mesh: Mesh):
    """epipolar_match with the CANDIDATE axis sharded over the mesh: each
    rank matches its block of the Q candidates against the whole keyframe
    store, and the four outputs are gathered in candidate order; no
    candidate reads another.  Returns fn(ms, cams, src_mkf, src_cam,
    tgt_mkf, tgt_cam, level, xy_level, want, **options of
    epipolar_match), whose (Q,)-shaped arguments are whole on every rank;
    Q must divide by the ranks."""
    def fn(ms, cams, src_mkf, src_cam, tgt_mkf, tgt_cam, level, xy_level, want,
           *options, **kw):
        cand = (src_mkf, src_cam, tgt_mkf, tgt_cam, level, xy_level, want)
        q0, q1 = shard_range(want.shape[0], mesh.group, "candidates Q")
        out = epipolar_match(ms, cams, *(x[q0:q1] for x in cand), *options, **kw)
        return tuple(gather_cat(x, mesh.group) for x in out)

    return fn


def sharded_track_frame(mesh: Mesh, ms, cams, cams_sbi, tcfg):
    """track_frame with the map's points sharded over the mesh: the PVS
    runs on each rank's points, the pair selection on the gathered masks,
    each pair's search on its point's rank, and the pose solves on the
    gathered pairs (tracker/tracker.py).  Returns (fn, this rank's map);
    fn(ts, local map, feats) gives (TrackerState, TrackResult), the same
    on every rank."""
    local, _ = shard_map_points(mesh, ms)

    def fn(ts, m, feats):
        return track_frame(ts, m, cams, cams_sbi, feats, tcfg, group=mesh.group)

    return fn, local
