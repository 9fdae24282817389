#!/usr/bin/env python3
"""Where a warp of MiniPatch's round-trip kernel spends its time, on one GPU.

    python3 scripts/minipatch_phases.py

Builds a copy of ``mcptam_tpu_torch/csrc/minipatch.cu`` whose lane 0 of
each warp stamps ``clock64()`` before each of the kernel's numbered phases
(the ``// (n)`` comments: (1) the first template and region load, (2) the
search into the previous frame, (3) the return template and region load,
(4) the return search, (5) the results) and at its end, ``%globaltimer``
at its start and end, and the SM it ran on, into a buffer of its own.
Runs it on chip_smoke.py's consecutive frame pair (3840 candidates, some
moved onto the level borders) and prints, beside the uninstrumented
kernel's time (chip_smoke.time_ms): the SM clock the warps saw (cycles
over global time), the mean cycles of each phase over the warps that ran
it, the kernel's span, the spread of the warps' starts, and the warps,
searches and busy time (first start to last end) of each SM.  The stamps
cost a few instructions a phase; the phases' shares, not their sum, are
what it measures.
"""

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402  (scene constants, time_ms, the round trip's inputs)
import compare_parent_kernels as cpk  # noqa: E402  (build_libs, Swapped)

SLOTS = 10   # int64 a candidate: clock64 at 0..5, globaltimer start, end, SM id
GT0, GT1, SM = 6, 7, 8
PHASES = {1: "first load", 2: "first search", 3: "return load", 4: "return search",
          5: "results"}


def instrument(src: str) -> str:
    """minipatch.cu with the stamps and a C entry point that sets their
    buffer, ``mcptam_phase_stamps``."""
    def slot(i):
        return f"g_stamps[(size_t)k * {SLOTS} + {i}]"

    def gtime(i):
        return ("    unsigned long long g;\n"
                "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
                f"    {slot(i)} = (long long)g;\n")

    head = "struct Best {"
    if src.count(head) != 1:
        raise RuntimeError("struct Best was not found once")
    src = src.replace(head, "__device__ long long* g_stamps = nullptr;\n\n" + head)
    start = "  if (k >= K) return;\n"
    if src.count(start) != 1:
        raise RuntimeError("the kernel's candidate index was not found once")
    src = src.replace(start, start + "  if (g_stamps && lane == 0) {\n" + gtime(GT0)
                      + "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
                      + f"    {slot(SM)} = sm;\n  }}\n")
    marks = list(re.finditer(r"^( *)// \((\d)\) ", src, re.M))
    if [int(m.group(2)) for m in marks] != sorted(PHASES):
        raise RuntimeError("the phases (1)-(5) were not found in order")
    for m in reversed(marks):
        stamp = f"{m.group(1)}if (g_stamps && lane == 0) {slot(int(m.group(2)) - 1)} = clock64();\n"
        src = src[:m.start()] + stamp + src[m.start():]
    end = "    ssd[K + k] = ssd2;\n  }\n"
    if src.count(end) != 1:
        raise RuntimeError("the kernel's end was not found once")
    src = src.replace(end, end + f"  if (g_stamps && lane == 0) {{\n    {slot(5)} = clock64();\n"
                      + gtime(GT1) + "  }\n")
    return src + ("\nextern \"C\" int mcptam_phase_stamps(long long* p) {\n"
                  "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("minipatch_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import mcptam_tpu_torch  # noqa: F401  (precision flags)
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.csrc._build import CSRC, build, load
    from mcptam_tpu_torch.io.synthetic import make_rig, render_rig
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.ops.minipatch_kernel import stability_reference, stability_search

    card = cs.card_line()
    print(f"card: {card}")
    build()
    load()
    src = instrument(open(os.path.join(CSRC, "minipatch.cu")).read())
    lib = cpk.build_libs({"stamped": {"common.cu": open(os.path.join(CSRC, "common.cu")).read(),
                                      "minipatch.cu": src}},
                         os.path.join(ROOT, "mcptam_tpu_torch", "_build", "phases"))["stamped"]
    lib.mcptam_phase_stamps.argtypes = [ctypes.c_void_p]
    lib.mcptam_phase_stamps.restype = ctypes.c_int
    dev = torch.device("cuda:0")
    cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
    f0, f1 = (make_frame_features(torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        cs.traj_tangent(i), dtype=torch.float32, device=dev)), cs.SEED, cs.H, cs.W),
        0, 255).to(torch.uint8)) for i in (0, 1))
    args = cs.stability_args(f0, cs.at_borders(f1))
    K = args[4].shape[0]
    ms_k = cs.time_ms(lambda: stability_search(*args))
    stamps = torch.zeros((K, SLOTS), dtype=torch.int64, device=dev)
    with cpk.Swapped(lib, "mcptam_stability_search"):
        cpk.stability_agrees(stability_search(*args), stability_reference(*args))
        if lib.mcptam_phase_stamps(stamps.data_ptr()) != 0:
            raise RuntimeError("mcptam_phase_stamps failed")
        for _ in range(3):
            stamps.zero_()
            rt = stability_search(*args)
        torch.cuda.synchronize()
        lib.mcptam_phase_stamps(None)
    d = stamps.cpu().double()
    ran = rt.ran.cpu()
    first, back = ran[0], ran[1]
    life = d[:, GT1] - d[:, GT0]
    ghz = ((d[first, 5] - d[first, 0]) / life[first]).median().item()
    # a warp that skips the return search stamps (3) and (4) not at all:
    # its first search ends at (5)
    end1 = torch.where(back, d[:, 2], d[:, 4])
    cycles = [(d[first, 1] - d[first, 0]).mean().item(),
              (end1 - d[:, 1])[first].mean().item(),
              (d[back, 3] - d[back, 2]).mean().item(),
              (d[back, 4] - d[back, 3]).mean().item(),
              (d[first, 5] - d[first, 4]).mean().item()]
    starts = d[:, GT0]
    span = (d[first, GT1].max() - starts.min()).item() / 1e3
    sm = d[:, SM].long()
    n_sm = int(sm.max()) + 1
    warps = torch.bincount(sm, minlength=n_sm).double()
    searches = torch.bincount(sm, weights=(first.double() + back.double()), minlength=n_sm)
    busy = torch.zeros(n_sm, dtype=torch.float64)
    for s in range(n_sm):
        on = (sm == s) & first
        if bool(on.any()):
            busy[s] = (d[on, GT1].max() - d[sm == s, GT0].min()).item() / 1e3

    def mmm(x):
        return f"{x.min().item():.2f} / {x.mean().item():.2f} / {x.max().item():.2f}"

    print(f"stability_filter K={K}, {int(first.sum())} first and {int(back.sum())} return "
          f"searches: kernel {ms_k:.4f} ms ({card}); SM clock {ghz:.3f} GHz; mean cycles a "
          "phase: " + ", ".join(f"{PHASES[i + 1]} {c:.0f}" for i, c in enumerate(cycles))
          + f"; kernel span {span:.2f} us, warp starts spread over "
          f"{(starts.max() - starts.min()).item() / 1e3:.2f} us; per SM min / mean / max: "
          f"warps {mmm(warps)}, searches {mmm(searches)}, busy us {mmm(busy)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
