"""Dense SPD solves sized for the reduced (Schur) pose system (port of
mcptam_tpu/core/spd.py).

``spd_solve`` on a CUDA tensor launches the hand-written Cholesky kernel
``csrc/spd.cu``: the blocked variant (K4) by default, the unblocked one
(K5) under ``MCPTAM_SPD_KERNEL=simple``, as the reference picks its Pallas
kernel.  On a CPU tensor it takes ``spd_solve_reference``, the stock solver,
as the reference does off the TPU.  K4 keeps the packed factor, its
current panel (transposed, PB x (n - PB + 32)), the panel's diagonal block
and the right-hand sides in one block's shared memory up to n = 322 at
m = 1.  Larger systems (the mapping LM's n = 6 x max_mkfs from 54 MKFs on)
take its global path: a blocked right-looking Cholesky spread over the
SMs as 2 ceil(n / NB) + 1 launches on the current stream (a load, then a
panel and a trailing-update launch a panel of NB columns, then one
block's back-substitution), with a dense factor in a global workspace.
Only the back-substitution's right-hand sides and two 32 x 33 tiles live
in shared memory, so it takes n m <= 56000 (n = 56000 at m = 1).  K5
keeps everything in shared memory and raises beyond n = 339.
"""

from __future__ import annotations

import os

import torch

from mcptam_tpu_torch import backend

MAX_SHARED_BYTES = 232448  # 227 KB: the most shared memory one block may use
K4_PB = 16  # K4's panel width (csrc/spd.cu PB)
# its global path's panel width and trailing-update tile (csrc/spd.cu NB, TILE)
K4_GLOBAL_NB, K4_GLOBAL_TILE = 32, 32


def shared_bytes(n: int, m: int, blocked: bool = True) -> int:
    """Shared memory a kernel needs (csrc/spd.cu ``shared_floats``): the
    packed factor and the rhs, and for K4 the panel transposed (K4_PB x ld,
    ld the rows below the first panel rounded to 4, plus 32), the diagonal
    block transposed and its pivot scales."""
    floats = n * (n + 1) // 2 + n * m
    if blocked:
        ld = (max(n - K4_PB, 0) + 3) // 4 * 4 + 32
        floats += K4_PB * ld + K4_PB * K4_PB + K4_PB
    return 4 * floats


def shared_bytes_global(n: int, m: int) -> int:
    """Shared memory of K4's global path (csrc/spd.cu
    ``global_back_floats``): the back-substitution's two 32 x 33 diagonal
    tiles and the right-hand sides.  The factor lives in a global
    workspace."""
    return 4 * (2 * 32 * 33 + n * m)


def global_ld(n: int) -> int:
    """Leading dimension of the global path's dense factor W (csrc/spd.cu
    ``global_ld``): n rounded up to 4."""
    return (n + 3) // 4 * 4


def global_work_floats(n: int, m: int) -> int:
    """The global path's workspace in floats (csrc/spd.cu
    ``global_work_floats``): W (n x ld), the panel's factored diagonal block
    (NB x NB) and the right-hand sides (n x m)."""
    return n * global_ld(n) + K4_GLOBAL_NB ** 2 + n * m


def global_launches(n: int) -> int:
    """Kernel launches one global-path solve enqueues: the load, a panel
    launch a panel, an update launch a panel but the last, the
    back-substitution."""
    return 2 * -(-n // K4_GLOBAL_NB) + 1


def global_plan(n: int, m: int) -> dict:
    """The global path's plan as the built kernel library states it
    (``mcptam_spd_global_plan``): NB, TILE, the launches a solve enqueues,
    the workspace in floats and the back-substitution's shared bytes."""
    import ctypes

    from mcptam_tpu_torch.csrc._build import load

    plan = (ctypes.c_longlong * 5)()
    load().mcptam_spd_global_plan(n, m, ctypes.addressof(plan))
    return dict(zip(("nb", "tile", "launches", "work_floats", "back_shared_bytes"), plan))


def route(n: int, m: int, blocked: bool = True) -> str:
    """The kernel an (n, m) system takes: the launch-count key of K4
    (``spd_solve_blocked``), of its global path
    (``spd_solve_blocked_global``) or of K5 (``spd_solve_simple``).
    Raises for a system no kernel takes."""
    if n <= 0 or m <= 0:
        raise ValueError(f"spd_solve_kernel: empty system n={n}, m={m}")
    if not blocked:
        if shared_bytes(n, m, False) > MAX_SHARED_BYTES:
            raise ValueError(
                f"spd_solve_kernel: n={n}, m={m} is beyond the simple kernel's "
                f"range (its factor needs {shared_bytes(n, m, False)} B of shared "
                f"memory, above {MAX_SHARED_BYTES} B); the blocked default "
                "(MCPTAM_SPD_KERNEL unset) solves it")
        return "spd_solve_simple"
    if shared_bytes(n, m) <= MAX_SHARED_BYTES:
        return "spd_solve_blocked"
    if shared_bytes_global(n, m) <= MAX_SHARED_BYTES:
        return "spd_solve_blocked_global"
    raise ValueError(f"spd_solve_kernel: n={n}, m={m} needs "
                     f"{shared_bytes_global(n, m)} B of shared memory on the "
                     f"global path, above the {MAX_SHARED_BYTES} B a block may use")


def kernel_name() -> str:
    """The kernel ``MCPTAM_SPD_KERNEL`` selects: blocked (default) or simple."""
    kind = os.environ.get("MCPTAM_SPD_KERNEL", "blocked")
    return "spd_solve_blocked" if kind == "blocked" else "spd_solve_simple"


def spd_solve_reference(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: the stock dense solver."""
    return torch.linalg.solve(A, B)


def spd_solve_kernel(A: torch.Tensor, B: torch.Tensor,
                     blocked: bool = True) -> torch.Tensor:
    """(n,n) SPD A (its upper triangle is read) and (n,m) B, f32 CUDA
    tensors -> X (n,m) through csrc/spd.cu."""
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError(f"spd_solve_kernel: CUDA tensors on one device, got "
                         f"{A.device} and {B.device}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise ValueError(f"spd_solve_kernel takes float32, got {A.dtype}, {B.dtype}")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("spd_solve_kernel takes contiguous tensors")
    n = A.shape[0]
    if A.shape != (n, n) or B.ndim != 2 or B.shape[0] != n:
        raise ValueError(f"spd_solve_kernel: bad shapes {tuple(A.shape)}, "
                         f"{tuple(B.shape)}")
    m = B.shape[1]
    which = route(n, m, blocked)
    from mcptam_tpu_torch.csrc._build import check, load

    X = torch.empty((n, m), dtype=torch.float32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    if which == "spd_solve_blocked_global":
        floats = global_work_floats(n, m)
        work = torch.empty(floats, dtype=torch.float32, device=A.device)
        err = load().mcptam_spd_solve_global(A.data_ptr(), B.data_ptr(), X.data_ptr(),
                                             work.data_ptr(), n, m, floats, stream)
    else:
        err = load().mcptam_spd_solve(A.data_ptr(), B.data_ptr(), X.data_ptr(),
                                      n, m, int(blocked), stream)
    check(err, which)
    backend.count_launch(which)
    return X


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the dense SPD system ``A x = b`` (b may be (n,) or (n, m))."""
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    if A.device.type == "cpu":
        X = spd_solve_reference(A, B)
    else:
        X = spd_solve_kernel(A.contiguous(), B.contiguous(),
                             blocked=kernel_name() == "spd_solve_blocked")
    return X[:, 0] if vec else X
