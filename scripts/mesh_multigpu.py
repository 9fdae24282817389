#!/usr/bin/env python3
"""parallel/mesh.py across the cards of one host: one process a card on
NCCL, every sharded function of chip_smoke.py phase 11 on that phase's
inputs, held by phase 11's world-2 gates against the unsharded port that
rank 0 runs, and timed beside it.

    torchrun --nproc-per-node 4 scripts/mesh_multigpu.py
    torchrun --nproc-per-node 4 scripts/mesh_multigpu.py --rehearse   # CPU, gloo, 256x320

Rank 0 builds the kernels (the others load them after), makes the inputs
(phase 4's rig, phase 11's problems, map and frames) and hands them to
every rank through a file.  Every rank prints nothing but errors; rank 0
prints the card, each function's ms sharded (its second run) beside the
unsharded run's, what phase 11's gates print, and last a line
{"ok": true, "world": N}.  Exits non-zero if a gate fails.
"""

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU under gloo at 2 x 256 x 320 (no card)")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    if args.rehearse:
        cs.H, cs.W, cs.C = 256, 320, 2     # rows divisible by 8 x 4 ranks
        cs.MAX_POINTS, cs.MAX_MKFS, cs.MAX_MEAS = 1024, 8, 4096
        cs.N_PER_LEVEL = 12
        torch.set_num_threads(2)
        torch.cuda.synchronize = lambda *a, **k: None
    elif not torch.cuda.is_available():
        print("mesh_multigpu: no CUDA device; pass --rehearse for a CPU run",
              file=sys.stderr)
        return 1
    import mcptam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import make_rig, make_sbi_cams, render_rig
    from mcptam_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(device="cpu" if args.rehearse else "cuda")
    dev, rank, world = mesh.device, mesh.rank, mesh.world
    try:
        if dev.type == "cuda":
            from mcptam_tpu_torch.csrc._build import build, load
            if rank == 0:
                build()
            dist.barrier()
            load()
        box = [None]
        if rank == 0:
            card = "cpu rehearsal" if args.rehearse else cs.card_line()
            print(f"mesh_multigpu: world {world} on {dist.get_backend()}, {card}", flush=True)
            cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
            frames = [torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
                cs.traj_tangent(i), dtype=torch.float32, device=dev)), cs.SEED, cs.H, cs.W),
                0, 255).to(torch.uint8) for i in range(cs.PAR_TRACK_FRAMES)]
            inp = cs.parallel_inputs(cams, cfb, make_sbi_cams(cams, cs.H, cs.W), frames, dev)
            ref, _, ref_schur = cs.parallel_drive(inp)
            ref_secs = cs.parallel_drive(inp)[1]
            root = tempfile.mkdtemp(prefix="mesh_multigpu_")
            box = [os.path.join(root, "inputs.pkl")]
            with open(box[0], "wb") as f:
                pickle.dump(cs._to(inp, "cpu"), f)
        dist.broadcast_object_list(box, src=0)
        with open(box[0], "rb") as f:
            inp = cs._to(pickle.load(f), dev)
        dist.barrier()
        if rank == 0:
            shutil.rmtree(os.path.dirname(box[0]), ignore_errors=True)
        t0 = time.perf_counter()
        got, _, schur = cs.parallel_drive(inp, mesh)
        secs = cs.parallel_drive(inp, mesh)[1]
        schur_ranks, results = [None] * world, [None] * world
        dist.all_gather_object(schur_ranks, schur)
        dist.all_gather_object(results, got)
        if rank != 0:
            return 0
        print(f"mesh_multigpu: two sharded drives in {time.perf_counter() - t0:.2f} s")
        for r, other in enumerate(results[1:], 1):
            diff = cs._differences(other, got)
            if diff:
                raise AssertionError(f"rank {r}'s results differ from rank 0's: {diff[:8]}")
        for name in ref_secs:
            print(f"mesh_multigpu world {world}: {name} {secs[name] * 1e3:.3f} ms sharded "
                  f"(rank 0, second run), {ref_secs[name] * 1e3:.3f} ms unsharded (second "
                  f"run) on {card}")
        cs.hold_epipolar_parts(inp, got["epipolar_match"], ref["epipolar_match"], world)
        cs.hold_parallel_world(ref, got, schur_ranks, ref_schur, world)
        print(json.dumps({"ok": True, "world": world}))
        return 0
    finally:
        mesh.close()


if __name__ == "__main__":
    sys.exit(main())
