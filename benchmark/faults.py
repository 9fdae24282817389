"""Faults planted under the timed path, to see the comparison that decides
``correct`` fail: the CPU tests plant each in a small run, and
``control.py`` reads the BA cell's numbers under them on the card, at the
cell's own size, where they set the upper readings of its limits.

``plant(driver, fault)`` patches the program and returns the function that
takes the fault out again.  The faults of a driver are the keys of
``FAULTS[driver]``."""

from __future__ import annotations

import dataclasses

import torch


def _patch(obj, name: str, new) -> callable:
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def track_state_unchanged():
    """The tracking step returns its input state and pose."""
    from mcptam_tpu_torch.system import system

    orig = system.track_frame

    def tracked(ts, ms, *a, **k):
        _, res = orig(ts, ms, *a, **k)
        return ts, dataclasses.replace(res, pose=ts.pose)

    return _patch(system, "track_frame", tracked)


def track_answer_altered():
    """The pose moved a millimetre where the tracking step makes it."""
    from mcptam_tpu_torch.system import system

    orig = system.track_frame

    def tracked(ts, ms, *a, **k):
        ts2, res = orig(ts, ms, *a, **k)
        pose = dataclasses.replace(res.pose, t=res.pose.t + 1e-3)
        return ts2, dataclasses.replace(res, pose=pose)

    return _patch(system, "track_frame", tracked)


def track_half_batch():
    """Every other frame of a batch tracked, its result standing for the
    one left out."""
    from mcptam_tpu_torch.system import system

    orig = system.System._batch_step

    def half(self, ts, ms, images_b, cam_active, queue_poses=None):
        ts, ms, rows, results = orig(self, ts, ms, images_b[::2], cam_active, queue_poses)
        return (ts, ms, rows.repeat_interleave(2, 0)[: images_b.shape[0]],
                [r for r in results for _ in range(2)][: images_b.shape[0]])

    return _patch(system.System, "_batch_step", half)


def track_map_moved():
    """One point of the start map moved a millimetre as it is built."""
    from mcptam_tpu_torch.io import synthetic

    orig = synthetic.build_groundtruth_map

    def moved(*a, **k):
        ms, feats = orig(*a, **k)
        ms.points.pos_w[0] += 1e-3
        return ms, feats

    return _patch(synthetic, "build_groundtruth_map", moved)


def ba_state_unchanged():
    """The LM step solves (``spd_solve`` is called), then keeps its input
    state: every trial rejected."""
    from mcptam_tpu_torch.ba import bundle

    orig = bundle._lm_update

    def rejected(prob, st, bcfg, deltas, trial, cost0, cost1, *a, **k):
        return orig(prob, st, bcfg, deltas, trial, cost0, torch.full_like(cost1, float("inf")),
                    *a, **k)

    return _patch(bundle, "_lm_update", rejected)


def ba_half_batch():
    """Half the measurements left out of every chunk."""
    from mcptam_tpu_torch.ba import bundle

    orig = bundle.lm_run

    def lm_run(prob, st, *a, **k):
        keep = torch.arange(prob.m_valid.shape[0], device=prob.m_valid.device) % 2 == 0
        return orig(prob.replace(m_valid=prob.m_valid & keep), st, *a, **k)

    return _patch(bundle, "lm_run", lm_run)


def ba_answer_altered():
    """The step's first coordinate moved by a hundredth of its largest
    where K4's solve makes it."""
    from mcptam_tpu_torch.ba import bundle

    orig = bundle.spd_solve

    def solve(A, b):
        x = orig(A, b)
        return x + 1e-2 * x.abs().max() * (torch.arange(x.shape[0], device=x.device) == 0)

    return _patch(bundle, "spd_solve", solve)


FAULTS = {
    "track": {"state_unchanged": track_state_unchanged, "half_batch": track_half_batch,
              "answer_altered": track_answer_altered, "map_moved": track_map_moved},
    "ba": {"state_unchanged": ba_state_unchanged, "half_batch": ba_half_batch,
           "answer_altered": ba_answer_altered},
}


def plant(driver: str, fault: str) -> callable:
    return FAULTS[driver][fault]()
