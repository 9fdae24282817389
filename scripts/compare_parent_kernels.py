#!/usr/bin/env python3
"""Time the window gather (K2's plain gather), the blocked SPD solve (K4,
shared and global path) and the tracker's search against an earlier
version of their CUDA sources, in one process on one GPU.

    git archive <commit> mcptam_tpu_torch/csrc | tar -x -C _parent
    python3 scripts/compare_parent_kernels.py --parent-csrc _parent/mcptam_tpu_torch/csrc [--variants]

The earlier ``gather.cu``, ``spd.cu`` and ``common.cu`` are built with the
same nvcc flags into a library of their own and called through their own
C entry points.  Both gathers must be bit-exact against the plain version
at the tracker's former shape (K = 1000 windows of 35x35 f32) and the
map-maker's largest call (4096 windows of 26x26 uint8); on random SPD
matrices (condition number 1e4) at n = 96 and 288 both K4 versions must
agree with the plain solve within chip_smoke.SPD_TOL, and so must both
versions of K4's global path at chip_smoke.SPD_GLOBAL_SIZES, timed beside
torch.linalg.cholesky + torch.cholesky_solve (the earlier one may take
another workspace and arguments: one without ``mcptam_spd_global_plan``
is called as the earlier one-block kernel was).  The tracker's
search is timed on the coarse and fine calls of a tracked batch: the
fused kernel (csrc/search.cu) against the earlier path, the window
gather followed by the eager search (``search_patches_reference``).
Times are CUDA-event device times (chip_smoke.time_ms) taken in turns
(earlier, current, current, earlier); chip_smoke.py itself times
MiniPatch's round trip against the path it replaced.

``--variants`` also builds the current sources with the search kernel's
block size ``THREADS``, offset tile ``YW`` x ``XW`` and ``MIN_BLOCKS``
(the blocks an SM must hold, which caps its registers) set to other
values, K4's global path with its panel width ``NB`` (16, 32, 64) and
update tile ``TILE`` (32, 64) at chip_smoke.SPD_GLOBAL_SIZES, and the
round trip (csrc/minipatch.cu, on chip_smoke's consecutive frame pair)
with ``WARPS`` (candidates a block) and ``SEG`` (offsets of a row a lane
takes at once) set to other values, checks each the same way as
chip_smoke.py and times each, so that the choice in the sources is a
measured one.  Prints the card and its power limit, and one JSON line
of the times.
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

# (THREADS, YW, XW, MIN_BLOCKS) of the search kernel; (NB, TILE) of K4's global path
SEARCH_VARIANTS = ((128, 3, 2, 8), (128, 3, 3, 8), (128, 2, 2, 8), (64, 3, 3, 16),
                   (256, 2, 2, 4), (128, 3, 2, 4))
GLOBAL_VARIANTS = tuple((nb, t) for nb in (16, 32, 64) for t in (32, 64))
# (WARPS, SEG) of the round-trip kernel
MINIPATCH_VARIANTS = ((8, 7), (4, 7), (1, 7), (8, 3))


def build_libs(libs: dict, out_dir: str) -> dict:
    """{name: {source file: text}} -> {name: ctypes.CDLL}: every source in
    its own nvcc process, all at once, then one link a library."""
    from mcptam_tpu_torch.csrc._build import ENTRY_POINTS, NVCC_FLAGS, _nvcc

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
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {obj} failed:\n{err}")
        if name != "earlier":
            for line in (out + err).splitlines():
                if any(k in line for k in ("registers", "spill")):
                    print(f"  ptxas {name}: {line.strip()}")
        objs[name].append(obj)
    built = {}
    for name, o in objs.items():
        lib_path = os.path.join(out_dir, name, f"lib{name}.so")
        subprocess.run([nvcc, "-shared", "-o", lib_path, *o], check=True)
        lib = ctypes.CDLL(lib_path)
        for entry, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.mcptam_error_string.argtypes = [ctypes.c_int]
        lib.mcptam_error_string.restype = ctypes.c_char_p
        if getattr(lib, "mcptam_spd_global_plan", None) is None and hasattr(
                lib, "mcptam_spd_solve_global"):  # one-block kernel: packed workspace
            lib.mcptam_spd_solve_global.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
        built[name] = lib
    return built


def read_sources(csrc: str, names) -> dict:
    return {s: open(os.path.join(csrc, s)).read() for s in names}


def with_constant(text: str, name: str, value: int) -> str:
    """The source with ``constexpr int <name> = ...;`` set to value."""
    new, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         text)
    if count != 1:
        raise RuntimeError(f"constexpr int {name} found {count} times")
    return new


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def lib_spd(lib, A, b):
    import torch
    X = torch.empty_like(b)
    err = lib.mcptam_spd_solve(A.data_ptr(), b.data_ptr(), X.data_ptr(), A.shape[0],
                               b.shape[1], 1, stream())
    if err:
        raise RuntimeError(f"spd_solve: CUDA error {err}")
    return X


def lib_spd_global(lib, A, b):
    """K4's global path of a built library: the launch sequence with its
    plan's workspace, or, for a library without mcptam_spd_global_plan,
    the earlier one-block kernel with its packed n(n+1)/2 workspace."""
    import torch
    n, m = A.shape[0], b.shape[1]
    X = torch.empty_like(b)
    if getattr(lib, "mcptam_spd_global_plan", None) is None:
        work = torch.empty(n * (n + 1) // 2, dtype=torch.float32, device=A.device)
        err = lib.mcptam_spd_solve_global(A.data_ptr(), b.data_ptr(), X.data_ptr(),
                                          work.data_ptr(), n, m, stream())
    else:
        plan = (ctypes.c_longlong * 5)()
        lib.mcptam_spd_global_plan(n, m, ctypes.addressof(plan))
        work = torch.empty(plan[3], dtype=torch.float32, device=A.device)
        err = lib.mcptam_spd_solve_global(A.data_ptr(), b.data_ptr(), X.data_ptr(),
                                          work.data_ptr(), n, m, plan[3], stream())
    if err:
        raise RuntimeError(f"spd_solve_global: CUDA error {err}")
    return X


def lib_gather(lib, plane, rows, cols, G):
    import torch
    entry = {torch.float32: lib.mcptam_gather_windows_f32,
             torch.uint8: lib.mcptam_gather_windows_u8}[plane.dtype]
    r32, c32 = rows.to(torch.int32), cols.to(torch.int32)
    out = torch.empty((rows.shape[0], G, G), dtype=torch.float32, device=plane.device)
    err = entry(plane.data_ptr(), r32.data_ptr(), c32.data_ptr(), out.data_ptr(),
                rows.shape[0], plane.shape[0], plane.shape[1], G, stream())
    if err:
        raise RuntimeError(f"gather_windows: CUDA error {err}")
    return out


class Swapped:
    """The kernel library with one entry point taken from another build,
    for ``with``: mcptam_tpu_torch.csrc._build.load returns it meanwhile."""

    def __init__(self, lib, entry: str):
        from mcptam_tpu_torch.csrc import _build
        self.build, self.lib, self.entry = _build, lib, entry

    def __getattr__(self, name):
        return getattr(self.lib if name == self.entry else self.main, name)

    def __enter__(self):
        self.orig = self.build.load
        self.main = self.orig()
        self.build.load = lambda: self
        return self

    def __exit__(self, *exc):
        self.build.load = self.orig


def in_turns(old, new, reps: int = 20):
    """(earlier ms, current ms): each timed twice, earlier-current-current-earlier."""
    o1 = cs.time_ms(old, reps)
    n1 = cs.time_ms(new, reps)
    n2 = cs.time_ms(new, reps)
    o2 = cs.time_ms(old, reps)
    return [o1, o2], [n1, n2]


def search_agrees(got, want) -> float:
    """Share of pairs whose found flag and best offset agree; raises on a
    disagreement that is not a near-tie (chip_smoke.SEARCH_TIE)."""
    import torch
    fk, pk, sk, ak = got
    fp, pp, sp, ap = want
    agree = (fk == fp) & (pk == pp).all(-1)
    tie = torch.isclose(sk, sp, rtol=cs.SEARCH_TIE, atol=cs.SEARCH_TIE)
    if not bool(tie[~agree].all()) or not torch.equal(ak["region_ok"], ap["region_ok"]):
        raise AssertionError("search disagrees beyond near-ties")
    return agree.float().mean().item()


def stability_agrees(got, want) -> None:
    """Raises unless the round trip is bit-exact where the kernel ran."""
    import torch
    ran = got.ran
    if not (torch.equal(got.kept, want.kept) and torch.equal(ran, want.ran)
            and all(torch.equal(getattr(got, f)[ran], getattr(want, f)[ran])
                    for f in ("found", "xy", "ssd"))):
        raise AssertionError("stability_filter differs from its plain version")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", required=True,
                    help="directory holding the earlier gather.cu, spd.cu, common.cu")
    ap.add_argument("--build-dir", default=os.path.join(ROOT, "mcptam_tpu_torch", "_build",
                                                        "compare"))
    ap.add_argument("--variants", action="store_true",
                    help="also time the search kernel's and K4's global path's variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_parent_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    import mcptam_tpu_torch  # noqa: F401  (precision flags)
    from mcptam_tpu_torch.config import TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.core.spd import spd_solve_kernel, spd_solve_reference
    from mcptam_tpu_torch.csrc._build import CSRC, build, load
    from mcptam_tpu_torch.io.synthetic import (
        build_groundtruth_map, make_rig, make_sbi_cams, render_rig,
    )
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.ops.gather_kernel import gather_windows, gather_windows_reference
    from mcptam_tpu_torch.ops.minipatch_kernel import stability_reference, stability_search
    from mcptam_tpu_torch.ops.patch import pack_corner_atlas
    from mcptam_tpu_torch.ops.search_kernel import search_patches, search_patches_reference
    from mcptam_tpu_torch.system.system import System

    card = cs.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    build()
    load()
    libs = {"earlier": read_sources(args.parent_csrc, ("common.cu", "gather.cu", "spd.cu"))}
    if args.variants:
        cur = read_sources(str(CSRC), ("common.cu", "search.cu", "spd.cu"))
        for nb, t in GLOBAL_VARIANTS:
            text = with_constant(with_constant(cur["spd.cu"], "NB", nb), "TILE", t)
            libs[f"global_nb{nb}_t{t}"] = {"common.cu": cur["common.cu"], "spd.cu": text}
        for nt, yw, xw, mb in SEARCH_VARIANTS:
            text = with_constant(cur["search.cu"], "THREADS", nt)
            text = with_constant(with_constant(text, "YW", yw), "XW", xw)
            text = with_constant(text, "MIN_BLOCKS", mb)
            libs[f"search_t{nt}_{yw}x{xw}_b{mb}"] = {"common.cu": cur["common.cu"],
                                                     "search.cu": text}
        mp = read_sources(str(CSRC), ("minipatch.cu",))["minipatch.cu"]
        for warps, seg in MINIPATCH_VARIANTS:
            libs[f"minipatch_w{warps}_s{seg}"] = {"common.cu": cur["common.cu"], "minipatch.cu":
                                                  with_constant(with_constant(mp, "WARPS", warps),
                                                                "SEG", seg)}
    built = build_libs(libs, args.build_dir)
    old = built["earlier"]
    print(f"build: current and {len(built)} other libraries in {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "gather": {}, "spd": {}, "spd_global": {}, "search": {},
           "variants": {}}

    for n in (96, 288):
        A = cs.random_spd(n, gen, dev)
        b = torch.randn(n, 1, generator=gen).to(dev)
        x_ref = spd_solve_reference(A, b)
        solvers = {"current": lambda: spd_solve_kernel(A, b, blocked=True),
                   "earlier": lambda: lib_spd(old, A, b)}
        for label, fn in solvers.items():
            x = fn()
            rel = ((x - x_ref).abs().max() / x_ref.abs().max()).item()
            if not rel <= cs.SPD_TOL:
                raise AssertionError(f"K4 {label} n={n}: relative error {rel}")
        k4_old, k4_new = in_turns(solvers["earlier"], solvers["current"])
        out["spd"][n] = {"k4_earlier_ms": k4_old, "k4_ms": k4_new}
        print(f"K4 spd_solve_blocked n={n} m=1: {out['spd'][n]} ({card})")

    # K4's global path: the earlier version against the current, in turns,
    # beside cholesky + cholesky_solve; then the current sources' variants
    for n in cs.SPD_GLOBAL_SIZES:
        A = cs.random_spd(n, gen, dev)
        b = torch.randn(n, 1, generator=gen).to(dev)
        x_ref = spd_solve_reference(A, b)
        solvers = {"current": lambda: spd_solve_kernel(A, b),
                   "earlier": lambda: lib_spd_global(old, A, b)}
        for label, fn in solvers.items():
            x = fn()
            rel = ((x - x_ref).abs().max() / x_ref.abs().max()).item()
            if not rel <= cs.SPD_TOL:
                raise AssertionError(f"K4 global {label} n={n}: relative error {rel}")
        g_old, g_new = in_turns(solvers["earlier"], solvers["current"])
        chol = cs.time_ms(lambda: torch.cholesky_solve(b, torch.linalg.cholesky(A)))
        out["spd_global"][n] = {"earlier_ms": g_old, "ms": g_new, "cholesky_solve_ms": chol}
        print(f"K4 spd_solve_blocked_global n={n} m=1: {out['spd_global'][n]} ({card})")
        if args.variants:
            times = {}
            for v in (v for v in built if v.startswith("global")):
                x = lib_spd_global(built[v], A, b)
                rel = ((x - x_ref).abs().max() / x_ref.abs().max()).item()
                if not rel <= cs.SPD_TOL:
                    raise AssertionError(f"K4 global {v} n={n}: relative error {rel}")
                times[v] = cs.time_ms(lambda: lib_spd_global(built[v], A, b))
            out["variants"][f"spd_global n={n}"] = times
            print(f"K4 global path NB x TILE n={n}: {times} ({card})")

    # the scene: the benchmark rig, its ground-truth map and a batch of frames
    cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
    ms, feats = build_groundtruth_map(cams, cfb, cs.H, cs.W, n_per_level=cs.N_PER_LEVEL,
                                      max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS,
                                      max_meas=cs.MAX_MEAS)
    frames = torch.stack([torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        cs.traj_tangent(i), dtype=torch.float32, device=dev)), cs.SEED, cs.H, cs.W),
        0, 255).to(torch.uint8) for i in range(cs.B)])

    packed = pack_corner_atlas(feats.atlas, feats.corner_atlas)
    planes = {"float32": packed.reshape(-1, packed.shape[-1]),
              "uint8": ms.mkfs.atlas.reshape(-1, ms.mkfs.atlas.shape[-1])}
    for dtype, K, G in (("float32", 1000, 35), ("uint8", 4096, 26)):
        pl = planes[dtype]
        rows = torch.randint(0, pl.shape[0] - G + 1, (K,), generator=gen).to(dev)
        cols = torch.randint(0, pl.shape[1] - G + 1, (K,), generator=gen).to(dev)
        ref = gather_windows_reference(pl, rows, cols, G)
        runs = {"current": lambda: gather_windows(pl, rows, cols, G),
                "earlier": lambda: lib_gather(old, pl, rows, cols, G)}
        for label, fn in runs.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"gather {label} K={K} G={G} {dtype} differs")
        g_old, g_new = in_turns(runs["earlier"], runs["current"])
        key = f"K={K} G={G} {dtype}"
        out["gather"][key] = {"earlier_ms": g_old, "ms": g_new,
                              "plain_ms": cs.time_ms(lambda: gather_windows_reference(
                                  pl, rows, cols, G))}
        print(f"K2 gather_windows {key}: {out['gather'][key]} ({card})")

    rec = System(cams, cfb, make_sbi_cams(cams, cs.H, cs.W), cs.H, cs.W,
                 tcfg=TrackerConfig(), max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS,
                 max_meas=cs.MAX_MEAS, pipeline_depth=2 * cs.B)
    rec.ms, rec.initialized = ms, True
    rec.vars["AddingMKFs"] = False
    calls = cs.record_searches(rec, frames)
    for R in (TrackerConfig().fine_range_first, -(-TrackerConfig().coarse_range // 4)):
        a, kw = next(c for c in calls if c[0][6] == R)
        want = search_patches_reference(*a, **kw)
        search_agrees(search_patches(*a, **kw), want)
        s_old, s_new = in_turns(lambda: search_patches_reference(*a, **kw),
                                lambda: search_patches(*a, **kw))
        key = f"K={a[2].shape[0]} R={R}"
        out["search"][key] = {"gather_and_eager_ms": s_old, "fused_ms": s_new}
        print(f"K2 search {key}: {out['search'][key]} ({card})")
        if args.variants:
            times = {}
            for v in (v for v in built if v.startswith("search")):
                with Swapped(built[v], "mcptam_search_patches"):
                    frac = search_agrees(search_patches(*a, **kw), want)
                    times[v] = (cs.time_ms(lambda: search_patches(*a, **kw)), frac)
            out["variants"][f"search {key}"] = times
            print(f"K2 search variants {key} (ms, agreement): {times} ({card})")

    if args.variants:
        # MiniPatch's round trip on chip_smoke's consecutive pair
        st = cs.stability_args(make_frame_features(frames[0]),
                               cs.at_borders(make_frame_features(frames[1])))
        want = stability_reference(*st)
        times = {}
        for v in (v for v in built if v.startswith("minipatch")):
            with Swapped(built[v], "mcptam_stability_search"):
                stability_agrees(stability_search(*st), want)
                times[v] = cs.time_ms(lambda: stability_search(*st))
        out["variants"]["stability_filter"] = times
        print(f"K8 stability_filter variants (ms): {times} ({card})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
