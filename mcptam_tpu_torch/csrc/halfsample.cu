// 2x2 box half-sample for Hopper: (N,H,W) f32 -> (N,H/2,W/2) f32.
//
// Replaces: scripts/test_pallas_halfsample.py::_hs_kernel_strided and
// _hs_kernel_matmul (K6, via hs_pallas), and _hs_kernel_reshape and
// _hs_kernel_roll (K7): four TPU formulations of one function, the
// prototype of mcptam_tpu/ops/pyramid.py::half_sample.
// Plain version: mcptam_tpu_torch/ops/pyramid.py::half_sample_reference.
//
// What bounds it on the H100: bytes.  Each output reads four inputs and
// does four flops, so a 4x480x640 frame moves 4.92 MB in and 1.23 MB out,
// ~1.8 us at 3.35 TB/s; at the pyramid's smaller levels and the SBI
// chain's 60x80 tail the launch costs more than the copy.  The TPU
// variants differ only in how they compact lanes and sublanes (strided
// reads, a selection matmul, reshapes, rolls); none of that serves the
// card.
//
// Design: one thread per output pixel.  A thread reads its two input rows
// with one float2 load each (neighbouring threads read neighbouring 8-byte
// words, so a warp's loads are coalesced) and writes one float.  The sum
// is taken as ((a + b) + c) + d then scaled by 0.25, with the rounding
// intrinsics so that no contraction reorders it: the same operations in
// the same order as the plain version, hence bit-identical on any f32
// input.  An odd last row or column is cropped, as pyramid.py crops it; an
// odd width (or a base pointer off an 8-byte boundary) takes scalar
// loads, since its rows are not 8-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool EVEN_W>
__global__ void half_sample_kernel(const float* __restrict__ in,
                                   float* __restrict__ out, int64_t total,
                                   int H, int W, int Ho, int Wo) {
  const int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (o >= total) return;
  const int x = (int)(o % Wo);
  const int64_t t = o / Wo;
  const int y = (int)(t % Ho);
  const int64_t n = t / Ho;
  const float* r0 = in + (n * H + 2 * y) * (int64_t)W + 2 * x;
  const float* r1 = r0 + W;
  float a, b, c, d;
  if (EVEN_W) {
    const float2 top = *reinterpret_cast<const float2*>(r0);
    const float2 bot = *reinterpret_cast<const float2*>(r1);
    a = top.x; b = top.y; c = bot.x; d = bot.y;
  } else {
    a = r0[0]; b = r0[1]; c = r1[0]; d = r1[1];
  }
  out[o] = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d), 0.25f);
}

}  // namespace

// in: (N,H,W) f32 contiguous, H >= 2, W >= 2; out: (N,H/2,W/2) f32.
// Returns a cudaError_t.
extern "C" int mcptam_half_sample(const float* in, float* out, int N, int H,
                                  int W, cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int64_t total = (int64_t)N * Ho * Wo;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (W % 2 == 0 && ((uintptr_t)in & 7) == 0) {
    half_sample_kernel<true><<<blocks, THREADS, 0, stream>>>(in, out, total, H, W, Ho, Wo);
  } else {
    half_sample_kernel<false><<<blocks, THREADS, 0, stream>>>(in, out, total, H, W, Ho, Wo);
  }
  return cudaGetLastError();
}
