"""K4, the blocked Cholesky solve in one block's shared memory
(csrc/spd.cu), a launch per spd_solve call up to n = 322 at m = 1.
Bytes: A (n x n f32) and B (n x m) read once, X (n x m) written once.
Operations: the Cholesky factorisation's n^3 / 3 and two triangular
solves' 2 n^2 m."""

KERNEL = "spd_blocked_kernel"
HOOK = ("mcptam_tpu_torch.ba.bundle", "spd_solve")
# a call as shape() notes it: the BA cell's reduced camera system
EXAMPLE = {"n": 288, "m": 1}


def shape(args, kwargs) -> dict:
    A, b = args[0], args[1]
    return {"n": int(A.shape[0]), "m": 1 if b.ndim == 1 else int(b.shape[1])}


def count(call: dict) -> tuple:
    n, m = call["n"], call["m"]
    return (n * n + 2 * n * m) * 4, n ** 3 / 3 + 2 * n * n * m
