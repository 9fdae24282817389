// FAST-10 front-end for Hopper: score + strict 3x3 nonmax + threshold
// histograms of one pyramid level, all cameras, in one pass.
//
// Replaces: mcptam_tpu/ops/fast_pallas.py::_fast_kernel (via fast_frontend).
// Plain version: mcptam_tpu_torch/ops/fast_kernel.py::fast_frontend_reference.
//
// What bounds it on the H100: bytes.  Per pixel it reads one float and
// writes two (score, nm); the 16-tap ring test is ~350 min/max/sub
// instructions a pixel, far under the card's rate at 3.35 TB/s.  The plain
// PyTorch version materialises the 16 ring-shifted copies and a 64-way
// threshold compare in device memory, some fifty passes over the image.
//
// Design: a 32x8 thread block owns a 32x8 output tile.  It stages the
// tile with a 4-px halo (3 for the ring, 1 for the nonmax) in shared
// memory once, scores the tile plus a 1-px ring of neighbours into shared
// memory, and takes the nonmax from there, so device memory is read once.
// The cumulative histograms freq[t] = #(score > t - 1e-6) are built as
// per-block bin counts with shared-memory atomics (bin b = number of
// thresholds a pixel passes), added to global int32 counts, and turned
// into exact f32 cumulative counts by a one-block-per-camera pass.

#include <cuda_runtime.h>

namespace {

constexpr int NBINS = 64;
constexpr int TW = 32;
constexpr int TH = 8;
constexpr int HALO = 4;
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int BORDER = 3;

// Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py)
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

// max over the 16 arcs of (min over 10 contiguous ring differences), for
// the bright and the dark case, floored at 0.  min/max are exact, so any
// evaluation order gives the reference's value bit for bit.
__device__ float fast_score(const float (*tile)[SW], int ly, int lx) {
  const float c = tile[ly][lx];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = tile[ly + RING_DY[i]][lx + RING_DX[i]] - c;
  float best = 0.0f;
#pragma unroll
  for (int a = 0; a < 16; ++a) {
    float mn = d[a];
    float mx = d[a];
#pragma unroll
    for (int j = 1; j < 10; ++j) {
      mn = fminf(mn, d[(a + j) & 15]);
      mx = fmaxf(mx, d[(a + j) & 15]);
    }
    best = fmaxf(best, fmaxf(mn, -mx));
  }
  return best;
}

// number of thresholds t in [0, NBINS) with s > float(t) - 1e-6f; the
// thresholds rise with t, so the passed set is a prefix of that length
__device__ int bin_of(float s) {
  int b = 0;
  while (b < NBINS && s > (float)b - 1e-6f) ++b;
  return b;
}

__global__ void fast_kernel(const float* __restrict__ img,
                            float* __restrict__ score,
                            float* __restrict__ nm, int* __restrict__ hist,
                            int C, int H, int W) {
  __shared__ float tile[SH][SW];
  __shared__ float sc[TH + 2][TW + 2];
  __shared__ int h_s[NBINS + 1];
  __shared__ int h_nm[NBINS + 1];

  const int cam = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t plane = (size_t)H * W;
  const float* im = img + cam * plane;

  for (int i = tid; i <= NBINS; i += TW * TH) {
    h_s[i] = 0;
    h_nm[i] = 0;
  }
  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int ly = i / SW, lx = i % SW;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? im[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // scores of the tile and its 1-px ring; the 3-px image border and
  // everything outside the image score 0
  for (int i = tid; i < (TH + 2) * (TW + 2); i += TW * TH) {
    const int sy = i / (TW + 2), sx = i % (TW + 2);
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float s = 0.0f;
    if (gy >= BORDER && gy < H - BORDER && gx >= BORDER && gx < W - BORDER)
      s = fast_score(tile, sy + HALO - 1, sx + HALO - 1);
    sc[sy][sx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx < W && gy < H) {
    const int ty = threadIdx.y + 1, tx = threadIdx.x + 1;
    const float s = sc[ty][tx];
    // strict 3x3 maximum; the earlier raster pixel wins a tie
    bool keep = s > sc[ty - 1][tx - 1] && s > sc[ty - 1][tx] &&
                s > sc[ty - 1][tx + 1] && s > sc[ty][tx - 1] &&
                s >= sc[ty][tx + 1] && s >= sc[ty + 1][tx - 1] &&
                s >= sc[ty + 1][tx] && s >= sc[ty + 1][tx + 1];
    const float n = keep ? s : 0.0f;
    const size_t o = cam * plane + (size_t)gy * W + gx;
    score[o] = s;
    nm[o] = n;
    atomicAdd(&h_s[bin_of(s)], 1);
    atomicAdd(&h_nm[bin_of(n)], 1);
  }
  __syncthreads();

  for (int i = tid; i <= NBINS; i += TW * TH) {
    if (h_s[i]) atomicAdd(&hist[(0 * C + cam) * (NBINS + 1) + i], h_s[i]);
    if (h_nm[i]) atomicAdd(&hist[(1 * C + cam) * (NBINS + 1) + i], h_nm[i]);
  }
}

// freq[c, t] = sum of bins b > t; one block per (camera, histogram),
// one thread per threshold; exact in f32 below 2^24 pixels
__global__ void fast_hist_finalize(const int* __restrict__ hist,
                                   float* __restrict__ freq,
                                   float* __restrict__ freq_nm, int C) {
  const int cam = blockIdx.x, which = blockIdx.y, t = threadIdx.x;
  const int* h = hist + (which * C + cam) * (NBINS + 1);
  int acc = 0;
  for (int b = t + 1; b <= NBINS; ++b) acc += h[b];
  (which == 0 ? freq : freq_nm)[cam * NBINS + t] = (float)acc;
}

}  // namespace

// img, score, nm: (C,H,W) f32; freq, freq_nm: (C,64) f32; hist: (2,C,65)
// int32 scratch.  Returns a cudaError_t.
extern "C" int mcptam_fast_frontend(const float* img, float* score, float* nm,
                                    float* freq, float* freq_nm, int* hist,
                                    int C, int H, int W, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(
      hist, 0, sizeof(int) * 2 * C * (NBINS + 1), stream);
  if (e != cudaSuccess) return e;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  fast_kernel<<<grid, block, 0, stream>>>(img, score, nm, hist, C, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fast_hist_finalize<<<dim3(C, 2), NBINS, 0, stream>>>(hist, freq, freq_nm, C);
  return cudaGetLastError();
}
