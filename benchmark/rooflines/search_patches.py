"""K2, the tracker's fused patch search (csrc/search.cu), a launch per
find_patches call.  Bytes: each pair's search region (G2 x G2 f32, G2 =
2R + 15), template (8x8 f32), prediction, camera, level and flag read
once; its subpixel window (15x15 f32), found, region flag, position,
score and offset written once.  Operations: the cross term's 64 FMAs (2
operations each) and ~30 for the box sums, score and masks at each of
the S x S offsets (S = 2R + 1), and 22 a row of the G x S box sums."""

KERNEL = "search_kernel"
HOOK = ("mcptam_tpu_torch.ops.batch_patch", "find_patches")
WSZ = 15
# a call as shape() notes it: the fine stage's
EXAMPLE = {"K": 1000, "R": 10}


def shape(args, kwargs) -> dict:
    """find_patches(packed, level_hw, cam_idx, level, templates, pred, range_l0, ...)."""
    return {"K": int(args[2].shape[0]), "R": int(args[6])}


def count(call: dict) -> tuple:
    K, R = call["K"], call["R"]
    S = 2 * R + 1
    G, G2 = S + 8, S + 14
    n_bytes = K * (G2 * G2 * 4 + 64 * 4 + 8 + 16 + 1) + K * (WSZ * WSZ * 4 + 2 + 12 + 16)
    n_ops = K * (S * S * (2 * 64 + 30) + G * S * 22)
    return n_bytes, n_ops
