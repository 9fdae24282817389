#!/usr/bin/env python3
"""Time the blocked SPD solve (K4) and the ESM alignment (K3) against an
earlier version of their CUDA sources, in one process on one GPU.

    git archive <commit> mcptam_tpu_torch/csrc | tar -x -C _parent
    python3 scripts/compare_parent_kernels.py --parent-csrc _parent/mcptam_tpu_torch/csrc [--variants]

The earlier ``spd.cu``, ``esm.cu`` and ``common.cu`` are built with the
same nvcc flags into a library of their own and called through their own
C entry points (``mcptam_spd_solve``, ``mcptam_esm_align_all``).  On
random SPD matrices (condition number 1e4) at n = 96 and 288 both K4
versions must agree with the plain solve within chip_smoke.SPD_TOL; on
the SBI pair of two rendered 4-camera 480x640 frames, at the tracker's
shape (4 cameras, 9 iterations) and the relocaliser's (1 camera, 12
iterations), both K3 versions must agree with the plain version within
chip_smoke.ESM_TOL.  Times are CUDA-event device times (chip_smoke.time_ms)
taken in turns (earlier, current, current, earlier), K4's beside K5,
torch.linalg.solve and torch.linalg.cholesky + torch.cholesky_solve.

``--variants`` also builds the current sources with K4's panel width
``PB`` set to 8 (with ``RT`` 8), 16 and 32, its trailing-update row tile
``RT`` to 8 and 16, and K3's block size ``THREADS`` to 256 and 512 (its named barriers
allow at most 16 warps), checks each the same way and times each, so that
the choice in the sources is a measured one.  Prints the card and its
power limit, and one JSON line of the times.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (time_ms, random_spd, card_line, scene)

PANEL_WIDTHS = (8, 16, 32)
ROW_TILES = (8, 16)
ESM_BLOCKS = (256, 512)


def build_libs(libs: dict, out_dir: str) -> dict:
    """{name: {source file: text}} -> {name: ctypes.CDLL}: every source in
    its own nvcc process, all at once, then one link a library."""
    from mcptam_tpu_torch.csrc._build import NVCC_FLAGS, _nvcc

    nvcc = _nvcc()
    jobs = []
    for name, sources in libs.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for src, text in sources.items():
            path = os.path.join(d, src)
            with open(path, "w") as f:
                f.write(text)
            obj = path[:-3] + ".o"
            jobs.append((name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, path],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs = {name: [] for name in libs}
    for name, obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {obj} failed:\n{err}")
        objs[name].append(obj)
    out = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, o in objs.items():
        lib_path = os.path.join(out_dir, name, f"lib{name}.so")
        subprocess.run([nvcc, "-shared", "-o", lib_path, *o], check=True)
        lib = ctypes.CDLL(lib_path)
        if "spd.cu" in libs[name]:
            lib.mcptam_spd_solve.argtypes = [P] * 3 + [I] * 3 + [P]
            lib.mcptam_spd_solve.restype = ctypes.c_int
        if "esm.cu" in libs[name]:
            lib.mcptam_esm_align_all.argtypes = [P] * 6 + [I] * 2 + [P]
            lib.mcptam_esm_align_all.restype = ctypes.c_int
        out[name] = lib
    return out


def read_sources(csrc: str, names) -> dict:
    return {s: open(os.path.join(csrc, s)).read() for s in names}


def with_constant(text: str, name: str, value: int) -> str:
    """The source with ``constexpr int <name> = ...;`` set to value."""
    new, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         text)
    if count != 1:
        raise RuntimeError(f"constexpr int {name} found {count} times")
    return new


def lib_spd(lib, A, b, blocked=True):
    import torch
    X = torch.empty_like(b)
    err = lib.mcptam_spd_solve(A.data_ptr(), b.data_ptr(), X.data_ptr(), A.shape[0],
                               b.shape[1], int(blocked), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spd_solve: CUDA error {err}")
    return X


def lib_esm(lib, args, iters):
    import torch
    C = args[0].shape[0]
    se2 = torch.empty((C, 4), dtype=torch.float32, device=args[0].device)
    score = torch.empty((C,), dtype=torch.float32, device=args[0].device)
    err = lib.mcptam_esm_align_all(*(a.data_ptr() for a in args), se2.data_ptr(),
                                   score.data_ptr(), C, iters,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"esm_align_all: CUDA error {err}")
    return se2, score


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
                    help="directory holding the earlier spd.cu, esm.cu, common.cu")
    ap.add_argument("--build-dir", default=os.path.join(ROOT, "mcptam_tpu_torch", "_build",
                                                        "compare"))
    ap.add_argument("--variants", action="store_true",
                    help="also time K4 at each panel width and K3 at each block size")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_parent_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    import mcptam_tpu_torch  # noqa: F401  (precision flags)
    from mcptam_tpu_torch.core.spd import spd_solve_kernel, spd_solve_reference
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.csrc._build import CSRC, build, load
    from mcptam_tpu_torch.io.synthetic import make_rig, render_rig
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.ops.sbi_kernel import esm_align, esm_align_all

    card = cs.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _, log = build()
    load()
    for line in log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill")):
            print(f"  ptxas: {line.strip()}")
    libs = {"earlier": read_sources(args.parent_csrc, ("common.cu", "spd.cu", "esm.cu"))}
    if args.variants:
        cur = read_sources(str(CSRC), ("common.cu", "spd.cu", "esm.cu"))
        for pb in PANEL_WIDTHS:
            text = with_constant(cur["spd.cu"], "PB", pb)
            if pb < 16:          # the look-ahead takes whole row tiles: RT <= PB
                text = with_constant(text, "RT", pb)
            libs[f"pb{pb}"] = {"common.cu": cur["common.cu"], "spd.cu": text}
        for rt in ROW_TILES:
            libs[f"rt{rt}"] = {"common.cu": cur["common.cu"],
                               "spd.cu": with_constant(cur["spd.cu"], "RT", rt)}
        for nt in ESM_BLOCKS:
            libs[f"esm{nt}"] = {"common.cu": cur["common.cu"],
                                "esm.cu": with_constant(cur["esm.cu"], "THREADS", nt)}
    built = build_libs(libs, args.build_dir)
    old = built["earlier"]
    print(f"build: current and {len(built)} other libraries in {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "spd": {}, "esm": {}, "variants": {}}
    for n in (96, 288):
        A = cs.random_spd(n, gen, dev)
        b = torch.randn(n, 1, generator=gen).to(dev)
        x_ref = spd_solve_reference(A, b)
        solvers = {"current": lambda: spd_solve_kernel(A, b, blocked=True),
                   "earlier": lambda: lib_spd(old, A, b)}
        if args.variants:
            solvers.update({v: (lambda lib: lambda: lib_spd(lib, A, b))(built[v])
                            for v in built if v.startswith(("pb", "rt"))})
        for label, fn in solvers.items():
            x = fn()
            rel = ((x - x_ref).abs().max() / x_ref.abs().max()).item()
            if not rel <= cs.SPD_TOL:
                raise AssertionError(f"K4 {label} n={n}: relative error {rel}")
        k4_old, k4_new = in_turns(solvers["earlier"], solvers["current"])
        out["spd"][n] = {
            "k4_earlier_ms": k4_old, "k4_ms": k4_new,
            "k5_ms": cs.time_ms(lambda: spd_solve_kernel(A, b, blocked=False)),
            "linalg_solve_ms": cs.time_ms(lambda: torch.linalg.solve(A, b)),
            "cholesky_solve_ms": cs.time_ms(
                lambda: torch.cholesky_solve(b, torch.linalg.cholesky(A))),
        }
        print(f"K4 spd_solve_blocked n={n} m=1: {out['spd'][n]} ({card})")
        if args.variants:
            out["variants"][f"spd n={n}"] = {
                label: cs.time_ms(solvers[label]) for label in solvers
                if label.startswith(("pb", "rt"))}
            print(f"K4 panel widths and row tiles n={n}: {out['variants'][f'spd n={n}']} "
                  f"({card})")

    cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
    feats = []
    for i in (0, 1):
        pose = SE3.exp(torch.tensor(cs.traj_tangent(i), dtype=torch.float32, device=dev))
        feats.append(make_frame_features(torch.clamp(
            render_rig(cams, cfb, pose, cs.SEED, cs.H, cs.W), 0, 255).to(torch.uint8)))
    pair = (feats[0].sbi, feats[1].sbi, feats[1].sbi_gx, feats[1].sbi_gy)
    for C, iters in ((cs.C, 9), (1, cs.RELOC_ITERATIONS)):
        a = tuple(t[:C].contiguous() for t in pair)
        se2_ref, _ = esm_align(*a, n_iterations=iters)
        runs = {"current": lambda: esm_align_all(*a, n_iterations=iters),
                "earlier": lambda: lib_esm(old, a, iters)}
        if args.variants:
            runs.update({f"esm{nt}": (lambda lib: lambda: lib_esm(lib, a, iters))(
                built[f"esm{nt}"]) for nt in ESM_BLOCKS})
        for label, fn in runs.items():
            err = (fn()[0] - se2_ref).abs().max().item()
            if not err <= cs.ESM_TOL:
                raise AssertionError(f"K3 {label} C={C} {iters} iterations: se2 err {err}")
        k3_old, k3_new = in_turns(runs["earlier"], runs["current"])
        key = f"C={C} iterations={iters}"
        out["esm"][key] = {"k3_earlier_ms": k3_old, "k3_ms": k3_new}
        print(f"K3 esm_align_all {key}: {out['esm'][key]} ({card})")
        if args.variants:
            out["variants"][f"esm {key}"] = {
                label: cs.time_ms(runs[label]) for label in runs if label.startswith("esm")}
            print(f"K3 block sizes {key}: {out['variants'][f'esm {key}']} ({card})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
