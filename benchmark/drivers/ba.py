"""The global bundle-adjustment mix: ``lm_run`` in the map-maker's chunks.

Set-up makes the mix's problems from the seed with the benchmark's frozen
copy of the synthetic generator (``ba/problems.py::build``), hands each to
the program, which attaches its observation table with the mix's D
(``obs_table_d``, the map-maker's D for this data, stated as data), and
runs one chunk of each.  The window solves the problems in turn: chunks of
``chunk`` LM steps, each chunk's convergence flag read ``convergence_lag``
chunks later as the map-maker reads it, a problem done once converged or
at the configuration's iteration cap.  An LM iteration (a step of ``lm_run``,
those after convergence that the lag lets run included: each is a whole
step's work) counts once the chunk that made it has its result on the
host.

Correct: for a sample of the problems finished in the window, drawn from
the seed, the plain reference solves the same problem from the same start
in the same chunks.  Held against the reference's: the first LM step's
reduced camera system, its right-hand side and its solution (K4's input
and output), recorded from the program's first run of each problem; the
first chunk's change of the poses and points (the LM update: the delta
applied, the points back-substituted, accept or reject, the damping), by
the gap of its norm, leaf by leaf; and the finished problem's cost and
poses.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

from faults import patch
from harness.convert import to_program

UNIT = "iters"
# window chunks of a reading for the limits (control.py): every problem finishes
CONTROL_CALLS = lambda mix: mix["n_problems"] * (100 // mix["chunk"])  # noqa: E731


class FirstSolve:
    """Records the arguments and the result of the next ``spd_solve`` call
    of a bundle module once armed (the LM step's reduced system and its
    solution)."""

    def __init__(self, module: str):
        import importlib
        self.mod = importlib.import_module(module)
        self.orig = self.mod.spd_solve
        self.armed, self.got = False, None
        self.mod.spd_solve = self._call

    def _call(self, A, b):
        x = self.orig(A, b)
        if self.armed:
            self.got, self.armed = (A.clone(), b.clone(), x.clone()), False
        return x

    def close(self):
        self.mod.spd_solve = self.orig


@dataclasses.dataclass
class Session:
    cfg: dict
    mix: dict
    seed: int
    dev: torch.device
    sync: object
    probs_r: list                 # the reference's problems (inputs of both sides)
    cams_r: object
    probs: list = None            # the program's, with their tables
    cams: object = None
    bcfg: object = None
    finished: list = dataclasses.field(default_factory=list)  # (p, first chunk, final)
    first_solves: dict = dataclasses.field(default_factory=dict)  # p -> (A, b, x)
    run_fn: object = None
    bundle_module: str = "mcptam_tpu_torch.ba.bundle"


def bundle_config(pkg: str, cfg: dict):
    import importlib
    c = importlib.import_module(f"{pkg}.config")
    return c.BundleConfig(**cfg["bundle"])


def make_inputs(cfg: dict, mix: dict, seed: int, dev):
    from plainref.ba.problems import build

    pm = mix["problem"]
    rig = cfg["rig"]
    probs, cams = [], None
    for p in range(mix["n_problems"]):
        prob, cams = build(pm["n_poses"], pm["n_points"], pm["n_cams"], H=rig["height"],
                           W=rig["width"], seed=[abs(int(seed)), p], sparse_k=pm["sparse_k"],
                           noise=pm["noise"], device=dev)
        probs.append(prob)
    return probs, cams


def with_table(pkg: str, prob, D: int):
    import importlib
    return importlib.import_module(f"{pkg}.ba.bundle").attach_obs_table(prob, D)


def setup(cfg: dict, mix: dict, seed: int, dev, sync) -> Session:
    from mcptam_tpu_torch.ba.bundle import create_lm_state, lm_run

    probs_r, cams_r = make_inputs(cfg, mix, seed, dev)
    sess = Session(cfg, mix, seed, dev, sync, probs_r, cams_r)
    sess.bcfg = bundle_config("mcptam_tpu_torch", cfg)
    sess.cams = to_program(cams_r)
    sess.probs = [with_table("mcptam_tpu_torch", to_program(p), mix["obs_table_d"])
                  for p in probs_r]
    sess.run_fn = lambda prob, st: lm_run(prob, st, sess.cams, mix["chunk"], sess.bcfg,
                                          fixed_b=True)
    sess.create = lambda prob: create_lm_state(prob, sess.bcfg)
    for prob in sess.probs:
        sess.run_fn(prob, sess.create(prob))
    sync()
    return sess


def _to_host(x: torch.Tensor):
    if not x.is_cuda:
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _landed(item) -> bool:
    """The convergence flag of a chunk, once its copy has landed."""
    host, ev = item
    if ev is not None:
        ev.synchronize()
    return bool(host)


def window(sess: Session, seconds: float, rec, hooks, trace: bool, max_chunks: int = 0):
    """The measured window.  With ``trace`` the spans are on for ``seconds``.
    Then, in every run of the benchmark, ``profile_chunks`` more chunks run
    under the profiler (the device time per iteration, the cell's
    end-to-end metric, reads them; with ``trace`` the per-layer metrics
    too); the window ends with them.  A reading for the limits
    (``max_chunks``, control.py) reads no metric and profiles nothing."""
    from harness.trace import profile_slice, summarize

    mix, cap = sess.mix, sess.bcfg.max_iterations
    state = {"p": 0, "st": None, "first": None, "steps": 0, "pending": [], "chunks": 0,
             "k": 0}

    def start():
        p = state["k"] % len(sess.probs)
        state.update(p=p, st=sess.create(sess.probs[p]), first=None, steps=0, pending=[])

    rec1 = FirstSolve(sess.bundle_module)

    def chunk():
        """One chunk; returns the LM iterations whose results landed."""
        prob = sess.probs[state["p"]]
        new = state["first"] is None and state["p"] not in sess.first_solves
        rec1.armed = new
        st = sess.run_fn(prob, state["st"])
        if new and rec1.got is not None:
            sess.first_solves[state["p"]], rec1.got = rec1.got, None
        state["st"] = st
        if state["first"] is None:
            state["first"] = st
        state["chunks"] += 1
        state["steps"] += mix["chunk"]
        state["pending"].append(_to_host(st.converged))
        landed, conv = 0, False
        if len(state["pending"]) > mix["convergence_lag"]:
            conv = _landed(state["pending"].pop(0))
            landed = mix["chunk"]
        if conv or state["steps"] >= cap:
            for item in state["pending"]:
                _landed(item)
                landed += mix["chunk"]
            sess.finished.append((state["p"], state["first"], st))
            state["k"] += 1
            start()
        return landed

    start()
    iters = 0
    t0 = time.perf_counter()
    hooks.spans_on = trace
    while time.perf_counter() - t0 < seconds and not (max_chunks and state["chunks"] >= max_chunks):
        iters += chunk()
    hooks.spans_on = False
    if trace or not max_chunks:
        hooks.launches_on = trace
        n0 = state["chunks"]
        got, events, wall, read_s = profile_slice(
            lambda: sum(chunk() for _ in range(mix["profile_chunks"])), sess.sync)
        iters += got
        hooks.launches_on = False
        rec.slice = summarize(events, wall, (state["chunks"] - n0) * mix["chunk"], UNIT, read_s)
    for item in state["pending"]:          # results on the host by the close
        host, ev = item
        if ev is None or ev.query():
            iters += mix["chunk"]
    rec.window_s = time.perf_counter() - t0 - (rec.slice or {}).get("read_s", 0.0)
    rec1.close()
    rec.units = iters
    rec.attempted = state["chunks"] * mix["chunk"]
    sess.sync()
    rec.failed = sum(int(fin.accepted) == 0 for _, _, fin in sess.finished)


def release(sess: Session):
    sess.probs = None


def reference_solve(sess: Session, p: int, tf32: bool = False):
    """The plain reference on problem p from its start, in the same chunks
    until converged or the cap: (state after the first chunk, final state,
    the first step's (A, b, x))."""
    from plainref.ba.bundle import create_lm_state, lm_run

    from drivers.track import precision

    bcfg = bundle_config("plainref", sess.cfg)
    rec1 = FirstSolve("plainref.ba.bundle")
    try:
        with precision(tf32):
            prob = with_table("plainref", sess.probs_r[p], sess.mix["obs_table_d"])
            st = create_lm_state(prob, bcfg)
            first, steps = None, 0
            while True:
                rec1.armed = first is None
                st = lm_run(prob, st, sess.cams_r, sess.mix["chunk"], bcfg, fixed_b=True)
                first = st if first is None else first
                steps += sess.mix["chunk"]
                if bool(st.converged) or steps >= bcfg.max_iterations:
                    return first, st, rec1.got
    finally:
        rec1.close()


def _pose_gap(a, b) -> float:
    return max(float((a.pose_a.R - b.pose_a.R).abs().max()),
               float((a.pose_a.t - b.pose_a.t).abs().max()))


def _rel_gap(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def change_gap(prob, got, ref) -> tuple:
    """The largest gap, over the leaves, between the norm of the program's
    change from the problem's start and the reference's, over the larger of
    the reference's norm of that leaf and of the median leaf; a leaf the
    reference moves by under a thousandth of the median leaf's change is
    left out.  The leaves: the rotations, the translations, and the median
    point (the median over the points of each point's change; the points'
    whole norm is set by a few weakly observed points that move far and
    swing from seed to seed, and is printed, not compared).  A state left
    unchanged, or moved double, reads 1.  Returns (gap, the look: each
    leaf's (program, reference) norms, the whole points' and the point the
    two sides move most differently)."""
    def d(a, b):
        return (a - b).double()

    def nr(x):
        return float(torch.linalg.vector_norm(x))

    pt_g = torch.linalg.vector_norm(d(got.points, prob.points), dim=-1)
    pt_r = torch.linalg.vector_norm(d(ref.points, prob.points), dim=-1)
    norms = {"rotation": (nr(d(got.pose_a.R, prob.pose_a.R)), nr(d(ref.pose_a.R, prob.pose_a.R))),
             "translation": (nr(d(got.pose_a.t, prob.pose_a.t)),
                             nr(d(ref.pose_a.t, prob.pose_a.t))),
             "median_point": (float(pt_g.median()), float(pt_r.median()))}
    med = sorted(q for _, q in norms.values())[len(norms) // 2]
    gap = max((abs(p - q) / max(q, med, 1e-30) for p, q in norms.values() if q >= 1e-3 * med),
              default=0.0)
    worst = int(torch.argmax((pt_g - pt_r).abs()))
    n_obs = int(torch.sum(prob.m_valid & (prob.m_point == worst)))
    look = {**norms, "points_whole": (nr(pt_g), nr(pt_r)),
            "worst_point": (worst, n_obs, float(pt_g[worst]), float(pt_r[worst]))}
    return gap, look


def judge(sess: Session, limits: dict) -> dict:
    """Every number compared, with its limit: {name: (value, limit, passes)};
    the readings not compared go to standard error."""
    rng = random.Random(sess.seed ^ 0xBA)
    runs = {}
    for p, first, fin in sess.finished:
        if p in sess.first_solves:
            runs.setdefault(p, (first, fin))
    want = sess.mix["judge"]["problems"]
    picked = sorted(rng.sample(sorted(runs), min(want, len(runs))))
    vals = dict.fromkeys(("schur_gap", "rhs_gap", "step_gap", "first_chunk_change_gap",
                          "final_cost_gap", "final_pose_gap"), 0.0)

    def worst(k, v):
        vals[k] = max(vals[k], v)

    for p in picked:
        first, fin = runs[p]
        r_first, r_fin, (Ar, br, xr) = reference_solve(sess, p)
        A, b, x = sess.first_solves[p]
        worst("schur_gap", _rel_gap(A, Ar))
        worst("rhs_gap", _rel_gap(b, br))
        worst("step_gap", _rel_gap(x, xr))
        gap, look = change_gap(sess.probs_r[p], first, r_first)
        worst("first_chunk_change_gap", gap)
        worst("final_cost_gap", abs(float(fin.cost) - float(r_fin.cost)) / abs(float(r_fin.cost)))
        worst("final_pose_gap", _pose_gap(fin, r_fin))
        print(f"ba: problem {p}: first chunk's change (program, reference) {look}; "
              f"cost {float(fin.cost)} / {float(r_fin.cost)}; accepted, iterations "
              f"{int(fin.accepted)}, {int(fin.iterations)} / {int(r_fin.accepted)}, "
              f"{int(r_fin.iterations)}", file=sys.stderr)
    out = {k: (v, limits[k], v <= limits[k]) for k, v in vals.items() if k in limits}
    for k, v in vals.items():
        if k not in out:
            print(f"reading {k}: {v} (not compared)", file=sys.stderr)
    out["judged_problems"] = (len(picked), want, len(picked) >= want)
    return out


def control_setup(cfg: dict, mix: dict, seed: int, dev, sync) -> Session:
    """The control's session: the same problems, the reference in TF32 in
    the program's place."""
    from plainref.ba.bundle import create_lm_state, lm_run

    from drivers.track import precision

    probs_r, cams_r = make_inputs(cfg, mix, seed, dev)
    sess = Session(cfg, mix, seed, dev, sync, probs_r, cams_r)
    sess.bcfg = bundle_config("plainref", cfg)
    sess.cams = cams_r
    with precision(True):
        sess.probs = [with_table("plainref", p, mix["obs_table_d"]) for p in probs_r]

    def run(prob, st):
        with precision(True):
            return lm_run(prob, st, cams_r, mix["chunk"], sess.bcfg, fixed_b=True)

    sess.run_fn = run
    sess.create = lambda prob: create_lm_state(prob, sess.bcfg)
    sess.bundle_module = "plainref.ba.bundle"
    return sess


# -- faults planted under the timed path (faults.py) --------------------------

def state_unchanged():
    """The LM step solves (``spd_solve`` is called), then keeps its input
    state: every trial rejected."""
    from mcptam_tpu_torch.ba import bundle

    orig = bundle._lm_update

    def rejected(prob, st, bcfg, deltas, trial, cost0, cost1, *a, **k):
        return orig(prob, st, bcfg, deltas, trial, cost0, torch.full_like(cost1, float("inf")),
                    *a, **k)

    return patch(bundle, "_lm_update", rejected)


def half_batch():
    """Half the measurements left out of every chunk."""
    from mcptam_tpu_torch.ba import bundle

    orig = bundle.lm_run

    def lm_run(prob, st, *a, **k):
        keep = torch.arange(prob.m_valid.shape[0], device=prob.m_valid.device) % 2 == 0
        return orig(prob.replace(m_valid=prob.m_valid & keep), st, *a, **k)

    return patch(bundle, "lm_run", lm_run)


def answer_altered():
    """The step's first coordinate moved by a hundredth of its largest
    where K4's solve makes it."""
    from mcptam_tpu_torch.ba import bundle

    orig = bundle.spd_solve

    def solve(A, b):
        x = orig(A, b)
        return x + 1e-2 * x.abs().max() * (torch.arange(x.shape[0], device=x.device) == 0)

    return patch(bundle, "spd_solve", solve)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
