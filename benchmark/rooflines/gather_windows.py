"""The window gather (csrc/gather.cu), a launch per gather_windows call
with a window (the wrapper launches nothing for none), here the calls
``gather_windows4`` makes for the map-maker's keyframe store.  Bytes: each
window of the plane (G x G pixels of its element size) read once, its two
int32 starts read once, its G x G f32 output written once.  It computes
nothing but a conversion: bytes bound it."""

KERNEL = "gather_kernel"
HOOK = ("mcptam_tpu_torch.ops.batch_patch", "gather_windows")
# a call as shape() notes it: the map-maker's largest, 4096 uint8 windows
EXAMPLE = {"K": 4096, "G": 26, "elem": 1}


def shape(args, kwargs):
    """gather_windows(plane, rows, cols, G); None where K is 0."""
    plane, rows, G = args[0], args[1], int(args[3])
    K = int(rows.shape[0])
    return {"K": K, "G": G, "elem": plane.element_size()} if K else None


def count(call: dict) -> tuple:
    K, G, elem = call["K"], call["G"], call["elem"]
    return K * (G * G * (elem + 4) + 8), 0
