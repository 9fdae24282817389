// Window gather for Hopper: copy K (G,G) windows out of a 2-D image plane
// at per-window (row, col) starts, converting to f32.
//
// Replaces: mcptam_tpu/ops/pallas_gather.py::_gather_kernel (via
// gather_windows_pallas, reached from ops/batch_patch.py::_gather_plane).
// Plain version: mcptam_tpu_torch/ops/gather_kernel.py::gather_windows_reference.
//
// What bounds it on the H100: latency of scattered small reads.  A window
// is at most 35x35 floats (4.9 KB) and a frame's fine stage gathers 1000
// of them, ~5 MB per call, so the copy is too small to be bandwidth-bound;
// what costs is issuing many short, unaligned row reads.  The TPU kernel's
// aligned super-windows, DMA slots and rolls served TPU DMA alignment and
// have no purpose here.
//
// Design: one block per window; its threads walk the window in raster
// order, so neighbouring threads read neighbouring addresses of one row
// (coalesced within a row) and write the output contiguously.  Starts are
// clamped like lax.dynamic_slice clamps them, so every read is in bounds.
// Templated on the plane's element type: the f32 packed search atlas of
// the tracker and the uint8 keyframe atlas that point creation reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void gather_kernel(const T* __restrict__ plane,
                              const int* __restrict__ rows,
                              const int* __restrict__ cols,
                              float* __restrict__ out, int HH, int AW, int G) {
  const int k = blockIdx.x;
  const int r0 = min(max(rows[k], 0), HH - G);
  const int c0 = min(max(cols[k], 0), AW - G);
  const T* src = plane + (size_t)r0 * AW + c0;
  float* dst = out + (size_t)k * G * G;
  for (int e = threadIdx.x; e < G * G; e += THREADS) {
    const int r = e / G;
    const int c = e - r * G;
    dst[e] = (float)src[(size_t)r * AW + c];
  }
}

template <typename T>
int launch(const T* plane, const int* rows, const int* cols, float* out,
           int K, int HH, int AW, int G, cudaStream_t stream) {
  if (K == 0) return cudaSuccess;
  gather_kernel<T><<<K, THREADS, 0, stream>>>(plane, rows, cols, out, HH, AW, G);
  return cudaGetLastError();
}

}  // namespace

// plane: (HH,AW) f32 or uint8; rows, cols: (K,) int32; out: (K,G,G) f32.
// Returns a cudaError_t.
extern "C" int mcptam_gather_windows_f32(const float* plane, const int* rows,
                                         const int* cols, float* out, int K,
                                         int HH, int AW, int G,
                                         cudaStream_t stream) {
  return launch<float>(plane, rows, cols, out, K, HH, AW, G, stream);
}

extern "C" int mcptam_gather_windows_u8(const uint8_t* plane, const int* rows,
                                        const int* cols, float* out, int K,
                                        int HH, int AW, int G,
                                        cudaStream_t stream) {
  return launch<uint8_t>(plane, rows, cols, out, K, HH, AW, G, stream);
}
