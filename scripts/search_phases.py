#!/usr/bin/env python3
"""Where a block of the tracker's search kernel spends its time, on one GPU.

    python3 scripts/search_phases.py

Builds a copy of ``mcptam_tpu_torch/csrc/search.cu`` whose thread 0 stamps
``clock64()`` at the start of the kernel and before each of its numbered
phases (the ``// (n)`` comments: (1) region load and decode, (2) row sums,
(3) column sums, (4) scores, (5) argmin, (6) window), and ``%globaltimer``
at the start and the end, into the ``box`` buffer in place of the box
sums.  Runs it on the coarse (K=60, R=8) and fine (K=1000, R=10) calls of
a tracked batch of chip_smoke.py's scene and prints, beside the
uninstrumented kernel's time (chip_smoke.time_ms), the mean SM cycles of
each phase over the blocks, and the kernel's span and the blocks' mean
duration on the global timer.  The stamps cost a few instructions a
phase; the phases' shares, not their sum, are what it measures.
"""

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402  (scene constants, time_ms, record_searches)
import compare_parent_kernels as cpk  # noqa: E402  (build_libs, Swapped)

SLOTS = 16   # int64 stamps a block: clock64 at 0..n, globaltimer at SLOTS-2, SLOTS-1
PHASES = {1: "load and decode", 2: "row sums", 3: "column sums", 4: "scores", 5: "argmin",
          6: "window"}


def instrument(src: str):
    """search.cu with the stamps; returns (source, phase names)."""
    def stamp(i, clock=True):
        slot = f"reinterpret_cast<long long*>(box)[(size_t)k * {SLOTS} + {i}]"
        if clock:
            return f"  if (tid == 0) {slot} = clock64();\n"
        return ("  if (tid == 0) {\n    unsigned long long g;\n"
                "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
                f"    {slot} = (long long)g;\n  }}\n")

    src, n = re.subn(r"\bif \(box\) \{", "if (false) {", src)
    if n != 1:
        raise RuntimeError("the box sums' write was not found once")
    start = "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
    if src.count(start) != 1:
        raise RuntimeError("the kernel's thread indices were not found once")
    src = src.replace(start, start + stamp(SLOTS - 2, clock=False) + stamp(0))
    names = ["prologue"]
    for m in reversed(list(re.finditer(r"^  // \((\d)\) ([^\n]*)\n", src, re.M))):
        src = src[:m.start()] + stamp(int(m.group(1))) + src[m.start():]
    names += [PHASES[int(m.group(1))] for m in re.finditer(r"^  // \((\d)\) ", src, re.M)]
    end = "\n}\n\n}  // namespace"
    if src.count(end) != 1:
        raise RuntimeError("the kernel's end was not found once")
    src = src.replace(end, "\n" + stamp(len(names)) + stamp(SLOTS - 1, clock=False)
                      + "}\n\n}  // namespace")
    return src, names


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("search_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import mcptam_tpu_torch  # noqa: F401  (precision flags)
    from mcptam_tpu_torch.config import TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.csrc._build import CSRC, build, load
    from mcptam_tpu_torch.io.synthetic import (
        build_groundtruth_map, make_rig, make_sbi_cams, render_rig,
    )
    from mcptam_tpu_torch.ops.search_kernel import search_patches
    from mcptam_tpu_torch.system.system import System

    card = cs.card_line()
    print(f"card: {card}")
    build()
    load()
    src, names = instrument(open(os.path.join(CSRC, "search.cu")).read())
    lib = cpk.build_libs({"stamped": {"common.cu": open(os.path.join(CSRC, "common.cu")).read(),
                                      "search.cu": src}},
                         os.path.join(ROOT, "mcptam_tpu_torch", "_build", "phases"))["stamped"]
    dev = torch.device("cuda:0")
    cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
    ms, _ = build_groundtruth_map(cams, cfb, cs.H, cs.W, n_per_level=cs.N_PER_LEVEL,
                                  max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS,
                                  max_meas=cs.MAX_MEAS)
    frames = torch.stack([torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        cs.traj_tangent(i), dtype=torch.float32, device=dev)), cs.SEED, cs.H, cs.W),
        0, 255).to(torch.uint8) for i in range(cs.B)])
    rec = System(cams, cfb, make_sbi_cams(cams, cs.H, cs.W), cs.H, cs.W,
                 tcfg=TrackerConfig(), max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS,
                 max_meas=cs.MAX_MEAS, pipeline_depth=2 * cs.B)
    rec.ms, rec.initialized = ms, True
    rec.vars["AddingMKFs"] = False
    calls = cs.record_searches(rec, frames)
    tcfg = TrackerConfig()
    for R in (-(-tcfg.coarse_range // 4), tcfg.fine_range_first):
        a, kw = next(c for c in calls if c[0][6] == R)
        K, S = a[2].shape[0], 2 * R + 1
        ms_k = cs.time_ms(lambda: search_patches(*a, **kw))
        box = torch.zeros((2, K, S, S), device=dev)
        if box.numel() < 2 * K * SLOTS:
            raise RuntimeError("the box buffer is too small for the stamps")
        with cpk.Swapped(lib, "mcptam_search_patches"):
            for _ in range(3):
                search_patches(*a, **kw, box=box)
            torch.cuda.synchronize()
        d = box.view(-1).view(torch.int64)[:K * SLOTS].reshape(K, SLOTS).cpu().double()
        n = len(names)
        cycles = (d[:, 1:n + 1] - d[:, :n]).mean(0)
        span = (d[:, SLOTS - 1].max() - d[:, SLOTS - 2].min()).item() / 1e3
        dur = ((d[:, SLOTS - 1] - d[:, SLOTS - 2]) / 1e3).mean().item()
        print(f"search K={K} R={R}: kernel {ms_k:.4f} ms ({card}); mean SM cycles a phase: "
              + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(names, cycles.tolist()))
              + f"; kernel span {span:.2f} us, block duration mean {dur:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
