// Window gather for Hopper: copy K (G,G) windows out of a 2-D image plane
// at per-window (row, col) starts, converting to f32.
//
// Replaces: mcptam_tpu/ops/pallas_gather.py::_gather_kernel (via
// gather_windows_pallas, reached from ops/batch_patch.py::_gather_plane).
// Plain version: mcptam_tpu_torch/ops/gather_kernel.py::gather_windows_reference.
//
// What bounds it on the H100: latency of scattered small reads.  A window
// is at most 35x35 floats (4.9 KB) and the map-maker's largest call
// gathers 4096 windows of 26x26 uint8 (2.8 MB in, 11 MB out as f32);
// what costs is issuing many short, unaligned row reads.  The TPU kernel's aligned
// super-windows, DMA slots and rolls served TPU DMA alignment and have no
// purpose here.  The tracker's searches no longer come here: their
// regions are gathered inside the fused search kernel (csrc/search.cu).
//
// Design: one warp a window, its lanes along the window's rows in raster
// order (neighbouring lanes read neighbouring addresses and write the
// output contiguously), unrolled so that eight reads a lane are in flight;
// no division an element.  Eight windows a 256-thread block.  Starts are
// clamped like lax.dynamic_slice clamps them, so every read is in bounds.
// Templated on the plane's element type: the f32 packed search atlas and the uint8
// keyframe atlas that point creation reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WINDOWS = THREADS / 32;   // windows a block

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ plane, const int* __restrict__ rows,
              const int* __restrict__ cols, float* __restrict__ out, int K, int HH,
              int AW, int G) {
  const int k = blockIdx.x * WINDOWS + (threadIdx.x >> 5);
  if (k >= K) return;
  const int lane = threadIdx.x & 31;
  const int r0 = min(max(rows[k], 0), HH - G);
  const int c0 = min(max(cols[k], 0), AW - G);
  const T* src = plane + (size_t)r0 * AW + c0;
  float* dst = out + (size_t)k * G * G;
  // element e = r G + c of the window, e = lane + 32 t: (r, c) carried from
  // step to step, so neighbouring lanes read one row's neighbouring pixels
  // (two rows' where a row ends) and write the output contiguously
  const int step_r = 32 / G, step_c = 32 - step_r * G;
  int r = lane / G, c = lane - r * G;
#pragma unroll 8
  for (int e = lane; e < G * G; e += 32) {
    dst[e] = (float)src[(size_t)r * AW + c];
    r += step_r;
    c += step_c;
    if (c >= G) {
      c -= G;
      ++r;
    }
  }
}

template <typename T>
int launch(const T* plane, const int* rows, const int* cols, float* out,
           int K, int HH, int AW, int G, cudaStream_t stream) {
  if (K == 0) return cudaSuccess;
  gather_kernel<T><<<(K + WINDOWS - 1) / WINDOWS, THREADS, 0, stream>>>(plane, rows, cols, out,
                                                                        K, HH, AW, G);
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
