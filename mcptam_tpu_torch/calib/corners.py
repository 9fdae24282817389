"""Checkerboard X-corner detection and sub-pixel refinement (port of
mcptam_tpu/calib/corners.py; ref CalibCornerPatch and the detection half
of CalibImageTaylor, src/CalibCornerPatch.cc, src/CalibImageTaylor.cc).

  * a dense X-corner response over the whole image;
  * nonmax and top-k candidate extraction;
  * batched sub-pixel refinement: a saddle-point fit of a quadratic to the
    blurred intensity around every corner at once, one window read an
    iteration for all corners;
  * host-side grid assembly in numpy (greedy flood expansion from the most
    central corner, like MakeFromImage's angle-guided expansion) and the
    canonical labelings the pose calibrator needs: grid topology is
    sequential and tiny.

No kernel of the port is involved: the device part is plain PyTorch, on the
image's device.
"""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.ops.fast import nonmax_3x3, topk_corners
from mcptam_tpu_torch.ops.pyramid import gaussian_blur_3


def xcorner_response(img: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Dense checkerboard-corner response of (...,H,W).

    An X-corner has two strong, opposed intensity alternations around a
    ring: the response is the ring intensity's second circular harmonic
    magnitude less 1.5 times its first (edges score on the first harmonic,
    X-corners on the second).  The ring's 16 shifts wrap around; the
    border is zeroed afterwards."""
    n_ring = 16
    angles = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    samples = []
    for a in angles:
        dy = int(round(radius * np.sin(a)))
        dx = int(round(radius * np.cos(a)))
        samples.append(torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)))
    ring = torch.stack(samples, -1)                          # (...,H,W,16)
    ring = ring - torch.mean(ring, -1, keepdim=True)

    def basis(v):
        return torch.as_tensor(v, dtype=torch.float32, device=img.device)

    a2 = torch.einsum("...r,r->...", ring, basis(np.cos(2 * angles)))
    b2 = torch.einsum("...r,r->...", ring, basis(np.sin(2 * angles)))
    a1 = torch.einsum("...r,r->...", ring, basis(np.cos(angles)))
    b1 = torch.einsum("...r,r->...", ring, basis(np.sin(angles)))
    resp = torch.sqrt(a2 * a2 + b2 * b2) - 1.5 * torch.sqrt(a1 * a1 + b1 * b1)
    H, W = img.shape[-2:]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    b = radius + 1
    inb = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)
    return torch.where(inb, torch.clamp(resp, min=0.0), torch.zeros_like(resp))


def detect_xcorners(img: torch.Tensor, max_corners: int = 256,
                    rel_thresh: float = 0.25):
    """(xy (K,2) f32, valid (K,)): nonmax-suppressed X-corners."""
    resp = xcorner_response(gaussian_blur_3(img, sigma=1.0, radius=2))
    xy, vals, valid = topk_corners(nonmax_3x3(resp), max_corners, 0.0)
    valid = valid & (vals > rel_thresh * vals[0])
    return xy.to(torch.float32), valid


def refine_xcorners(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                    half: int = 5, iters: int = 12):
    """Batched sub-pixel refinement: the X-corner is the saddle of the
    checker pattern, so fit I ~ c0 + c1 x + c2 y + c3 x^2 + c4 xy + c5 y^2
    to the (2 half + 1)^2 window of the blurred image around each corner
    and move to the quadratic's stationary point, ``iters`` times.  Every
    iteration reads all K windows at once, their centres rounded half to
    even and clipped to [half, W - half - 1] x [half, H - half - 1].
    Returns (xy (K,2), good (K,))."""
    sm = gaussian_blur_3(img, sigma=1.5, radius=3)
    dev = img.device
    n = 2 * half + 1
    o = torch.arange(-half, half + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    A = torch.stack([torch.ones_like(ox), ox, oy, ox * ox, ox * oy, oy * oy],
                    -1).reshape(-1, 6)
    AtA_inv = torch.linalg.inv(A.T @ A + 1e-6 * torch.eye(6, device=dev))
    H, W = img.shape[-2:]
    eye2 = torch.eye(2, device=dev)
    steps = torch.arange(n, device=dev)

    pos = xy
    for _ in range(iters):
        xi = torch.clamp(torch.round(pos[:, 0]).to(torch.int64), half, W - half - 1)
        yi = torch.clamp(torch.round(pos[:, 1]).to(torch.int64), half, H - half - 1)
        rows = (yi - half)[:, None] + steps                   # (K,n)
        cols = (xi - half)[:, None] + steps
        win = sm[rows[:, :, None], cols[:, None, :]].reshape(-1, n * n)
        c = (win @ A) @ AtA_inv.T                             # (K,6)
        Hm = torch.stack([torch.stack([2 * c[:, 3], c[:, 4]], -1),
                          torch.stack([c[:, 4], 2 * c[:, 5]], -1)], -2)
        g = c[:, 1:3]
        det = Hm[:, 0, 0] * Hm[:, 1, 1] - Hm[:, 0, 1] * Hm[:, 1, 0]
        # solve_ex: a singular window gives non-finite values, masked here,
        # where torch.linalg.solve would raise
        sol = torch.linalg.solve_ex(Hm + 1e-9 * eye2, -g)[0]
        d = torch.where((torch.abs(det) > 1e-9)[:, None], sol, torch.zeros_like(sol))
        d = torch.clamp(d, -1.5, 1.5)
        pos = torch.stack([xi.to(torch.float32) + d[:, 0],
                           yi.to(torch.float32) + d[:, 1]], -1)
    moved = torch.linalg.vector_norm(pos - xy, dim=-1)
    good = valid & (moved < half) & torch.isfinite(pos).all(-1)
    return torch.where(good[:, None], pos, xy), good


# ---------------------------------------------------------------------------
# Host-side grid assembly (numpy — sequential flood expansion)
# ---------------------------------------------------------------------------

def assemble_grid(xy: np.ndarray, valid: np.ndarray,
                  image_size, max_dim: int = 20):
    """Order detected corners into an (r, c) integer grid.

    Greedy expansion from the most central corner along its two dominant
    neighbor directions (the reference expands by angle then best-step
    flood, src/CalibImageTaylor.cc MakeFromImage).  Returns
    dict[(r,c)] -> corner index, or None if no consistent grid found."""
    pts = xy[valid]
    idxs = np.nonzero(valid)[0]
    if len(pts) < 9:
        return None
    center = np.asarray(image_size, np.float64) / 2.0
    d2c = np.linalg.norm(pts - center, axis=1)
    start = int(np.argmin(d2c))

    # nearest-neighbor distances -> grid pitch estimate
    from scipy.spatial import cKDTree
    tree = cKDTree(pts)
    dists, nbrs = tree.query(pts, k=min(5, len(pts)))
    pitch = np.median(dists[:, 1])

    # axes: the two most orthogonal neighbor directions of the start corner
    dirs = pts[nbrs[start, 1:]] - pts[start]
    dirs = dirs[np.argsort(np.linalg.norm(dirs, axis=1))]
    ax_u = dirs[0]
    best = None
    for d in dirs[1:]:
        # explicit 2D cross product (np.cross on 2-vectors is deprecated)
        c = abs(ax_u[0] * d[1] - ax_u[1] * d[0]) \
            / (np.linalg.norm(ax_u) * np.linalg.norm(d) + 1e-9)
        if c > 0.7:
            best = d
            break
    if best is None:
        return None
    ax_v = best

    grid = {(0, 0): start}
    pos = {start: (0, 0)}
    frontier = [start]
    used = {start}
    while frontier:
        i = frontier.pop()
        r, c = grid_rc = pos[i]
        for (dr, dc), step in (
            ((0, 1), ax_u), ((0, -1), -ax_u), ((1, 0), ax_v), ((-1, 0), -ax_v)
        ):
            key = (r + dr, c + dc)
            if key in grid:
                continue
            if abs(key[0]) > max_dim or abs(key[1]) > max_dim:
                continue
            target = pts[i] + step
            dist, j = tree.query(target)
            if dist < 0.35 * pitch and j not in used:
                grid[key] = int(j)
                pos[int(j)] = key
                used.add(int(j))
                frontier.append(int(j))
                # refine local axes from the actual step taken
    if len(grid) < 9:
        return None
    # normalize to non-negative coords and map to original indices
    rs = [k[0] for k in grid]
    cs = [k[1] for k in grid]
    r0, c0 = min(rs), min(cs)
    return {
        (k[0] - r0, k[1] - c0): int(idxs[v]) for k, v in grid.items()
    }


def detect_checkerboard(img_np: np.ndarray, max_corners: int = 256,
                        device="cuda"):
    """Full pipeline on one image: detect, refine on ``device``, then
    assemble the grid on the host.  Returns (grid dict[(r,c)] -> xy np
    (2,), xy_all, valid) or (None, xy_all, valid)."""
    img = torch.tensor(np.asarray(img_np), dtype=torch.float32, device=device)
    xy, valid = detect_xcorners(img, max_corners)
    xy_ref, good = refine_xcorners(img, xy, valid)
    xy_np = xy_ref.cpu().numpy()
    good_np = good.cpu().numpy()
    grid_idx = assemble_grid(xy_np, good_np, (img_np.shape[1], img_np.shape[0]))
    if grid_idx is None:
        return None, xy_np, good_np
    grid = {rc: xy_np[i] for rc, i in grid_idx.items()}
    return grid, xy_np, good_np


# ---------------------------------------------------------------------------
# Canonical grid labeling (pattern enforcement + consistent ordering)
# ---------------------------------------------------------------------------
# The reference optionally enforces the expected pattern size and a
# consistent corner ordering so multiple cameras agree on board-corner
# identity (CalibImageTaylor pattern-size/ordering options, used by the
# pose calibrator).  Here: dihedral relabelings that match the expected
# (n_rows, n_cols) span, filtered by the light-square-at-origin rule.

def dihedral_labelings(grid: dict, n_rows: int, n_cols: int,
                       min_fill: float = 0.85):
    """All relabelings of a detected (r,c)->uv grid that match the expected
    pattern.  The grid assembly can over-expand by a phantom row/column
    (spurious X-corners in scene texture adjacent to the board) — so in
    addition to exact-span grids, every (n_rows, n_cols) sub-window of a
    larger span filled to >= min_fill is offered as a candidate (callers
    filter by the light-square rule and PnP residuals).  Returns a list of
    dicts (r,c)->uv."""
    import itertools
    rc = np.array(list(grid.keys()))
    uv = np.array(list(grid.values()), np.float64)
    out = []
    min_count = int(np.ceil(min_fill * n_rows * n_cols))
    for swap in (False, True):
        a = rc[:, ::-1] if swap else rc
        r = a[:, 0] - a[:, 0].min()
        c = a[:, 1] - a[:, 1].min()
        if r.max() < n_rows - 1 or c.max() < n_cols - 1:
            continue
        for r0 in range(int(r.max()) - n_rows + 2):
            for c0 in range(int(c.max()) - n_cols + 2):
                inside = (
                    (r >= r0) & (r < r0 + n_rows)
                    & (c >= c0) & (c < c0 + n_cols)
                )
                if int(inside.sum()) < min_count:
                    continue
                rw = r[inside] - r0
                cw = c[inside] - c0
                uvw = uv[inside]
                for flip_r, flip_c in itertools.product(
                        (False, True), repeat=2):
                    rr = (n_rows - 1 - rw) if flip_r else rw
                    cc = (n_cols - 1 - cw) if flip_c else cw
                    out.append({(int(ri), int(ci)): uvw[i]
                                for i, (ri, ci) in enumerate(zip(rr, cc))})
    return out


def _square_center_intensity(img: np.ndarray, lab: dict, r: int, c: int):
    """Mean intensity at the center of the board square whose corners are
    inner corners (r,c),(r,c+1),(r+1,c),(r+1,c+1); None if corners absent."""
    need = [(r, c), (r, c + 1), (r + 1, c), (r + 1, c + 1)]
    if any(k not in lab for k in need):
        return None
    ctr = np.mean([lab[k] for k in need], axis=0)
    x, y = int(round(ctr[0])), int(round(ctr[1]))
    H, W = img.shape
    if not (1 <= x < W - 1 and 1 <= y < H - 1):
        return None
    return float(img[y - 1:y + 2, x - 1:x + 2].mean())


def canonical_labelings(img_np: np.ndarray, grid: dict,
                        n_rows: int, n_cols: int):
    """Labelings consistent with the convention that the square between
    inner corners (0,0) and (1,1) is *lighter* than its (0,1)-(1,2)
    neighbor.  Uniquely canonical when n_rows+n_cols is odd; for symmetric
    patterns the 180-degree twin survives too (callers disambiguate by
    cross-view consensus).  Returns list of dict (r,c)->uv (may be empty)."""
    img = np.asarray(img_np, np.float64)
    out = []
    for lab in dihedral_labelings(grid, n_rows, n_cols):
        i0 = _square_center_intensity(img, lab, 0, 0)
        i1 = _square_center_intensity(img, lab, 0, 1)
        if i0 is None or i1 is None:
            continue
        if i0 > i1:
            out.append(lab)
    # drop duplicates (mirror pairs can coincide on degenerate grids)
    uniq = []
    for lab in out:
        if not any(set(lab) == set(u) and
                   all(np.allclose(lab[k], u[k]) for k in lab) for u in uniq):
            uniq.append(lab)
    return uniq
