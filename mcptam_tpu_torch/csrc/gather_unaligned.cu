// Unaligned window gather for Hopper: copy K (G,G) windows out of a 2-D f32
// plane at per-window (row, col) starts, zero where a window overruns the
// plane.
//
// Replaces: scripts/profile_gather.py::_unaligned_kernel (K8, via
// gather_unaligned), the unaligned-DMA variant of the TPU window gather.
// Plain version: mcptam_tpu_torch/ops/gather_unaligned_kernel.py::
// gather_unaligned_reference.  Contract: window k copies plane[r:r+G,
// c:c+G] with r = clip(rows[k], 0, HH) and c = clip(cols[k], 0, AW), the
// pixels past the last row or column read as zero (the TPU script pads the
// plane with G zero rows and columns and clips the starts to the padding).
//
// What bounds it on the H100: bytes, and the latency of many short,
// unaligned row reads.  MiniPatch's candidate filter gathers up to 3840
// windows of 29x29 and 9x9 a call (13 MB of 29x29 windows in and out,
// ~8 us at 3.35 TB/s); every window row starts at an arbitrary 4-byte
// address, so no row can be fetched as aligned 16-byte vectors.
//
// Design: the TPU kernel's ring of _SLOTS = 8 asynchronous DMA copies into
// VMEM, on the card.  A block owns 16 windows and a ring of 8 window-sized
// slots in shared memory.  Its threads issue one 4-byte cp.async per pixel
// of a window into a slot (neighbouring threads on neighbouring addresses
// of a row), one commit group per window; a pixel past the plane's edge
// is issued with a source size of 0, so the copy itself writes the zero.
// The block keeps 8 windows in flight: it waits for the oldest group,
// stores that slot to the output with coalesced writes, and refills the
// slot with the window 8 ahead.  Groups past the block's last window are
// committed empty, so every wait names the same constant depth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SLOTS = 8;               // the TPU kernel's _SLOTS
constexpr int WINDOWS_PER_BLOCK = 16;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue window (r, c) of the plane into one ring slot.
__device__ __forceinline__ void issue_window(float* slot,
                                             const float* __restrict__ plane,
                                             int r, int c, int HH, int AW,
                                             int G) {
  for (int e = threadIdx.x; e < G * G; e += THREADS) {
    const int i = e / G;
    const int rr = r + i, cc = c + (e - i * G);
    const bool inside = rr < HH && cc < AW;
    cp_async4(slot + e, inside ? plane + (size_t)rr * AW + cc : plane,
              inside ? 4 : 0);
  }
}

__global__ void gather_unaligned_kernel(const float* __restrict__ plane,
                                        const int* __restrict__ rows,
                                        const int* __restrict__ cols,
                                        float* __restrict__ out, int K,
                                        int HH, int AW, int G) {
  extern __shared__ float ring[];  // SLOTS x (G*G)
  const int GG = G * G;
  const int k0 = blockIdx.x * WINDOWS_PER_BLOCK;
  const int nk = min(WINDOWS_PER_BLOCK, K - k0);

  for (int s = 0; s < SLOTS; ++s) {
    if (s < nk) {
      const int k = k0 + s;
      issue_window(ring + s * GG, plane, min(max(rows[k], 0), HH),
                   min(max(cols[k], 0), AW), HH, AW, G);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int s = i % SLOTS;
    cp_async_wait<SLOTS - 1>();  // this thread's copies of window i landed
    __syncthreads();             // ... and every other thread's
    float* dst = out + (size_t)(k0 + i) * GG;
    for (int e = threadIdx.x; e < GG; e += THREADS) dst[e] = ring[s * GG + e];
    __syncthreads();             // the slot is free again
    if (i + SLOTS < nk) {
      const int k = k0 + i + SLOTS;
      issue_window(ring + s * GG, plane, min(max(rows[k], 0), HH),
                   min(max(cols[k], 0), AW), HH, AW, G);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
}

}  // namespace

// plane: (HH,AW) f32; rows, cols: (K,) int32; out: (K,G,G) f32.
// Returns a cudaError_t.
extern "C" int mcptam_gather_unaligned(const float* plane, const int* rows,
                                       const int* cols, float* out, int K,
                                       int HH, int AW, int G,
                                       cudaStream_t stream) {
  if (K == 0) return cudaSuccess;
  const size_t smem = (size_t)SLOTS * G * G * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_unaligned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (K + WINDOWS_PER_BLOCK - 1) / WINDOWS_PER_BLOCK;
  gather_unaligned_kernel<<<blocks, THREADS, smem, stream>>>(
      plane, rows, cols, out, K, HH, AW, G);
  return cudaGetLastError();
}
