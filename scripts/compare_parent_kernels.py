#!/usr/bin/env python3
"""Time the FAST front-end (K1) and the unblocked SPD solve (K5) against
an earlier version of their CUDA sources, in one process on one GPU.

    git archive <commit> mcptam_tpu_torch/csrc | tar -x -C _parent
    python3 scripts/compare_parent_kernels.py --parent-csrc _parent/mcptam_tpu_torch/csrc

The earlier ``fast.cu``, ``spd.cu`` and ``common.cu`` are built with the
same nvcc flags into a library of their own and called through their own
C entry points: ``mcptam_fast_frontend`` (one level a call, a memset, the
kernel and a finalize) and ``mcptam_spd_solve``.  On a rendered 4-camera
480x640 frame's four pyramid levels both FAST versions must equal the
plain version exactly; on random SPD matrices (condition number 1e4) at
n = 96 and 288 both K5 versions must agree with the plain solve within
chip_smoke.SPD_TOL.  Times are CUDA-event device times (chip_smoke.time_ms)
taken in turns (earlier, current, current, earlier), beside the K4 kernel,
torch.linalg.solve and torch.linalg.cholesky + torch.cholesky_solve.
Prints the card and its power limit, and one JSON line of the times.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (time_ms, random_spd, card_line, scene)

SOURCES = ("common.cu", "fast.cu", "spd.cu")


def build_parent(csrc: str, out_dir: str) -> ctypes.CDLL:
    """The earlier sources, one nvcc each (all at once), then one link."""
    from mcptam_tpu_torch.csrc._build import NVCC_FLAGS, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    objs = [os.path.join(out_dir, f"{os.path.splitext(s)[0]}.o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(csrc, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(SOURCES, objs)]
    for s, p in zip(SOURCES, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {s} failed:\n{err}")
    lib_path = os.path.join(out_dir, "libparent_kernels.so")
    subprocess.run([nvcc, "-shared", "-o", lib_path, *objs], check=True)
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mcptam_fast_frontend.argtypes = [P] * 6 + [I] * 3 + [P]
    lib.mcptam_spd_solve.argtypes = [P] * 3 + [I] * 3 + [P]
    lib.mcptam_fast_frontend.restype = lib.mcptam_spd_solve.restype = ctypes.c_int
    return lib


def parent_fast(lib, img):
    """The earlier wrapper: one level, its outputs and zeroed-by-memset bins."""
    import torch
    C, H, W = img.shape
    score, nm = torch.empty_like(img), torch.empty_like(img)
    freq = torch.empty((C, 64), dtype=torch.float32, device=img.device)
    freq_nm = torch.empty_like(freq)
    hist = torch.empty((2, C, 65), dtype=torch.int32, device=img.device)
    err = lib.mcptam_fast_frontend(img.data_ptr(), score.data_ptr(), nm.data_ptr(),
                                   freq.data_ptr(), freq_nm.data_ptr(), hist.data_ptr(),
                                   C, H, W, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier fast_frontend: CUDA error {err}")
    return score, nm, freq, freq_nm


def parent_spd(lib, A, b):
    import torch
    X = torch.empty_like(b)
    err = lib.mcptam_spd_solve(A.data_ptr(), b.data_ptr(), X.data_ptr(), A.shape[0],
                               b.shape[1], 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier spd_solve: CUDA error {err}")
    return X


def in_turns(old, new, reps: int = 20):
    """(earlier ms, current ms): each timed twice, earlier-current-current-earlier."""
    o1 = cs.time_ms(old, reps)
    n1 = cs.time_ms(new, reps)
    n2 = cs.time_ms(new, reps)
    o2 = cs.time_ms(old, reps)
    return [o1, o2], [n1, n2]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", required=True,
                    help="directory holding the earlier fast.cu, spd.cu, common.cu")
    ap.add_argument("--build-dir", default=os.path.join(ROOT, "mcptam_tpu_torch", "_build",
                                                        "parent"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_parent_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    import mcptam_tpu_torch  # noqa: F401  (precision flags)
    from mcptam_tpu_torch.core.spd import spd_solve_kernel, spd_solve_reference
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.csrc._build import build, load
    from mcptam_tpu_torch.io.synthetic import make_rig, render_rig
    from mcptam_tpu_torch.ops.fast_kernel import fast_frontend_levels, fast_frontend_reference
    from mcptam_tpu_torch.ops.pyramid import build_pyramid

    card = cs.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _, log = build()
    load()
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    old = build_parent(args.parent_csrc, args.build_dir)
    print(f"build: current and earlier libraries in {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda:0")
    cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
    pose = SE3.exp(torch.tensor(cs.traj_tangent(0), dtype=torch.float32, device=dev))
    frame = torch.clamp(render_rig(cams, cfb, pose, cs.SEED, cs.H, cs.W), 0, 255)
    pyr = [p.contiguous() for p in build_pyramid(frame.to(torch.uint8).to(torch.float32))]
    new_out = fast_frontend_levels(pyr)
    for lvl, p in enumerate(pyr):
        ref = fast_frontend_reference(p)
        for name, a, b, c in zip(("score", "nm", "freq", "freq_nm"), new_out[lvl], ref,
                                 parent_fast(old, p)):
            if not (torch.equal(a, b) and torch.equal(c, b)):
                raise AssertionError(f"FAST level {lvl} {name}: current or earlier "
                                     f"kernel differs from the plain version")
    fast_old, fast_new = in_turns(lambda: [parent_fast(old, p) for p in pyr],
                                  lambda: fast_frontend_levels(pyr))
    print(f"K1 fast_frontend, 4 levels of {tuple(pyr[0].shape)}: earlier {fast_old} ms, "
          f"current {fast_new} ms ({card})")

    gen = torch.Generator().manual_seed(0)
    spd = {}
    for n in (96, 288):
        A = cs.random_spd(n, gen, dev)
        b = torch.randn(n, 1, generator=gen).to(dev)
        x_ref = spd_solve_reference(A, b)
        for label, x in (("current", spd_solve_kernel(A, b, blocked=False)),
                         ("earlier", parent_spd(old, A, b))):
            rel = ((x - x_ref).abs().max() / x_ref.abs().max()).item()
            if not rel <= cs.SPD_TOL:
                raise AssertionError(f"K5 {label} n={n}: relative error {rel}")
        k5_old, k5_new = in_turns(lambda: parent_spd(old, A, b),
                                  lambda: spd_solve_kernel(A, b, blocked=False))
        spd[n] = {
            "k5_earlier_ms": k5_old, "k5_ms": k5_new,
            "k4_ms": cs.time_ms(lambda: spd_solve_kernel(A, b, blocked=True)),
            "linalg_solve_ms": cs.time_ms(lambda: torch.linalg.solve(A, b)),
            "cholesky_solve_ms": cs.time_ms(
                lambda: torch.cholesky_solve(b, torch.linalg.cholesky(A))),
        }
        print(f"K5 spd_solve_simple n={n} m=1: {spd[n]} ({card})")
    print(json.dumps({"card": card, "fast_frontend": {"earlier_ms": fast_old,
                                                      "ms": fast_new},
                      "spd": spd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
