"""The ranks of tests/test_torch_parallel.py.

``spawn(world, inputs, root)`` starts ``world`` processes with the spawn
method; they join one gloo process group over a file store under
``root`` (so concurrent test workers never share a port), each runs every
sharded function of the port's mesh on the same inputs (numpy arrays,
pickled by the test), and each saves what it got.  This module imports
no JAX, so a rank starts in a couple of seconds.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback

import torch
import torch.distributed as dist

TIMEOUT_S = 180


def spawn(world: int, inputs: dict, root: str) -> list:
    """Run ``run`` on ``world`` gloo ranks; returns each rank's results."""
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, root)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    outs = []
    for r, p in enumerate(procs):
        path = os.path.join(root, f"rank{r}.pkl")
        if p.exitcode != 0 or not os.path.exists(path):
            err = os.path.join(root, f"rank{r}.err")
            msg = "no traceback"
            if os.path.exists(err):
                with open(err) as f:
                    msg = f.read()
            raise RuntimeError(f"rank {r} of {world} exited with {p.exitcode}:\n{msg}")
        with open(path, "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _rank(rank: int, world: int, root: str):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            with open(os.path.join(root, "inputs.pkl"), "rb") as f:
                out = run(pickle.load(f))
        finally:
            dist.destroy_process_group()
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def port_inputs(inp: dict) -> dict:
    """The pickled numpy inputs as the port's objects on the CPU."""
    from mcptam_tpu_torch import convert

    return dict(
        cams=convert.camera_from_numpy(inp["cams"], device="cpu"),
        cams_sbi=convert.camera_from_numpy(inp["cams_sbi"], device="cpu"),
        ms=convert.map_state_from_numpy(inp["ms"], device="cpu"),
        images=torch.as_tensor(inp["images"].copy()),
        masks=torch.as_tensor(inp["masks"].copy()),
        prob=convert.bundle_problem_from_numpy(inp["prob"], device="cpu"),
        prob_t=convert.bundle_problem_from_numpy(inp["prob_t"], device="cpu"),
        noisy=convert.bundle_problem_from_numpy(inp["noisy"], device="cpu"),
        noisy_nt=convert.bundle_problem_from_numpy(inp["noisy_nt"], device="cpu"),
        noisy_cams=convert.camera_from_numpy(inp["noisy_cams"], device="cpu"),
        epi=tuple(torch.as_tensor(a) for a in inp["epi"]),
        ts=convert.tracker_state_from_numpy(inp["ts"], device="cpu"),
    )


def run(inp: dict) -> dict:
    """Every sharded function on this rank, with the steps and sizes the
    test's ``STEPS`` gives: results as nested numpy dicts, and the message
    of the ValueError each size that does not divide raises."""
    from mcptam_tpu_torch import convert
    from mcptam_tpu_torch.ba import bundle
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.parallel import mesh as M
    from mcptam_tpu_torch.parallel.collectives import gather_cat
    from mcptam_tpu_torch.tracker.tracker import apply_tracker_point_stats

    p = port_inputs(inp)
    steps = inp["steps"]
    mesh = M.make_mesh(device="cpu")
    out = {"rank": mesh.rank, "world": mesh.world}

    fn, images = M.sharded_frame_features(mesh, p["images"])
    feats = fn(images)
    out["feats"] = convert.to_numpy(feats)
    out["feats_masked"] = convert.to_numpy(make_frame_features(
        p["images"], p["masks"], group=mesh.group))

    for key, prob, cams in (("lm", p["prob"], p["cams"]),
                            ("noisy_lm", p["noisy_nt"], p["noisy_cams"])):
        st, _ = M.sharded_lm_run(mesh, prob, cams, steps[key])
        out[key] = convert.to_numpy(st)

    # the Schur matrix every rank solves, kept at each LM step
    schur, solve = [], bundle.spd_solve

    def kept(A, b):
        schur.append(A.numpy().copy())
        return solve(A, b)

    bundle.spd_solve = kept
    try:
        st, _ = M.sharded_lm_run_soa(mesh, p["prob_t"], p["cams"], steps["lm_soa"])
        out["lm_soa"] = convert.to_numpy(st)
        st, _ = M.sharded_lm_run_soa(mesh, p["noisy"], p["noisy_cams"], steps["noisy"])
        out["noisy"] = convert.to_numpy(st)
    finally:
        bundle.spd_solve = solve
    out["schur"] = schur

    fn, ms_local = M.sharded_track_frame(mesh, p["ms"], p["cams"], p["cams_sbi"],
                                         inp["tcfg"])
    ts, res = fn(p["ts"], ms_local, feats)
    out["track"] = (convert.to_numpy(ts), convert.to_numpy(res))
    apply_tracker_point_stats(ms_local, res, min_outliers=0, group=mesh.group)
    out["stats"] = {k: gather_cat(getattr(ms_local.points, k), mesh.group).numpy()
                    for k in ("in_count", "out_count", "bad")}

    out["epi"] = convert.to_numpy(M.sharded_epipolar_match(mesh)(
        p["ms"], p["cams"], *p["epi"]))

    # sizes that do not divide by the ranks
    bad = {}
    cut = p["prob_t"].replace(points=p["prob_t"].points[:-1],
                              obs_idx=p["prob_t"].obs_idx[:-1])
    for what, call in (
            ("points L", lambda: M.shard_bundle_problem_soa(mesh, cut)),
            ("measurements K", lambda: M.shard_bundle_problem(
                mesh, p["prob"].replace(m_valid=p["prob"].m_valid[:-1]))),
            ("candidates Q", lambda: M.sharded_epipolar_match(mesh)(
                p["ms"], p["cams"], *(a[:-1] for a in p["epi"]))),
            ("image rows H", lambda: M.sharded_frame_features(
                mesh, p["images"][:, :-8])[0](p["images"][:, :-8]))):
        try:
            call()
            bad[what] = None
        except ValueError as e:
            bad[what] = str(e)
    out["bad"] = bad
    return out
