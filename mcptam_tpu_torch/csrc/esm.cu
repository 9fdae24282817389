// ESM alignment of the 30x40 small blurry images for Hopper: all 9
// Gauss-Newton iterations of every camera in one launch.
//
// Replaces: mcptam_tpu/ops/sbi_pallas.py::_esm_kernel with _esm_one and
// _solve4 (via esm_align_all).
// Plain version: mcptam_tpu_torch/ops/sbi.py::esm_align.
//
// What bounds it on the H100: latency.  A camera's working set is four
// 1200-pixel images (19 KB) and an iteration is ~40 flops a pixel, so the
// whole problem is microseconds of arithmetic; the plain version spends
// its time in the ~25 dependent small launches an iteration takes.
//
// Design: one block per camera keeps the current image, the target and
// its gradients in shared memory for all iterations.  Each iteration
// warps the current image with a direct bilinear read (not the TPU
// kernel's hat-matrix product), builds the 4x4 normal equations with one
// block reduction of 15 partial sums, and one thread solves them by an
// unrolled Cholesky and composes the SE2 update.  The TPU layout tricks
// (flat (N,1) columns, pre-transposed template, f32 mask shifts) were
// Mosaic workarounds and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 30;
constexpr int COLS = 40;
constexpr int N = ROWS * COLS;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 15;  // 10 entries of H, 4 of b, the score
constexpr float CX = 20.0f;
constexpr float CY = 15.0f;

// unrolled 4x4 Cholesky solve with the TPU kernel's pivot floor
__device__ void solve4(const float H[4][4], const float b[4], float x[4]) {
  float L[4][4];
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-20f)) : s / L[j][j];
    }
  }
  float y[4];
  for (int i = 0; i < 4; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 3; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 4; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__global__ void esm_kernel(const float* __restrict__ cur,
                           const float* __restrict__ tgt,
                           const float* __restrict__ tgx,
                           const float* __restrict__ tgy,
                           float* __restrict__ se2_out,
                           float* __restrict__ score_out, int n_iterations) {
  __shared__ float s_cur[N], s_tgt[N], s_gx[N], s_gy[N], s_warp[N];
  __shared__ unsigned char s_valid[N];
  __shared__ float s_part[NSUM][WARPS];
  __shared__ float s_state[6];  // cos, sin, tx, ty, mean offset, score

  const int cam = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = (size_t)cam * N;
  for (int n = tid; n < N; n += THREADS) {
    s_cur[n] = cur[off + n];
    s_tgt[n] = tgt[off + n];
    s_gx[n] = tgx[off + n];
    s_gy[n] = tgy[off + n];
  }
  if (tid == 0) {
    s_state[0] = 1.0f;
    s_state[1] = 0.0f;
    s_state[2] = 0.0f;
    s_state[3] = 0.0f;
    s_state[4] = 0.0f;
    s_state[5] = INFINITY;
  }
  __syncthreads();

  for (int it = 0; it < n_iterations; ++it) {
    const float c = s_state[0], s = s_state[1];
    const float tx = s_state[2], ty = s_state[3], mo = s_state[4];

    // warp: warped[p] = cur[R (p - centre) + centre + t], bilinear,
    // coordinates clamped to the image as the reference's hat weights are
    for (int n = tid; n < N; n += THREADS) {
      const float xs = (float)(n % COLS), ys = (float)(n / COLS);
      const float xr = c * (xs - CX) - s * (ys - CY) + CX + tx;
      const float yr = s * (xs - CX) + c * (ys - CY) + CY + ty;
      const float xf = fminf(fmaxf(xr, 0.0f), COLS - 1.0f);
      const float yf = fminf(fmaxf(yr, 0.0f), ROWS - 1.0f);
      const int xi = min((int)floorf(xf), COLS - 2);
      const int yi = min((int)floorf(yf), ROWS - 2);
      const float wx = xf - xi, wy = yf - yi;
      const float* p = s_cur + yi * COLS + xi;
      s_warp[n] = (1.0f - wy) * ((1.0f - wx) * p[0] + wx * p[1]) +
                  wy * ((1.0f - wx) * p[COLS] + wx * p[COLS + 1]);
      s_valid[n] = xr >= 0.0f && xr <= COLS - 2.0f && yr >= 0.0f &&
                   yr <= ROWS - 2.0f;
    }
    __syncthreads();

    float acc[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) acc[i] = 0.0f;
    for (int n = tid; n < N; n += THREADS) {
      const int x = n % COLS, y = n / COLS;
      // inner pixels whose warp source and 4 neighbours' sources are valid
      if (x < 1 || x > COLS - 2 || y < 1 || y > ROWS - 2) continue;
      if (!(s_valid[n] && s_valid[n - 1] && s_valid[n + 1] &&
            s_valid[n - COLS] && s_valid[n + COLS]))
        continue;
      const float gx = 0.25f * ((s_warp[n + 1] - s_warp[n - 1]) + s_gx[n]);
      const float gy = 0.25f * ((s_warp[n + COLS] - s_warp[n - COLS]) + s_gy[n]);
      const float j3 = -((float)y - CY) * gx + ((float)x - CX) * gy;
      const float diff = s_warp[n] - s_tgt[n] + mo;
      const float J[4] = {gx, gy, j3, 1.0f};
      int q = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = i; j < 4; ++j) acc[q++] += J[i] * J[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[10 + i] += J[i] * diff;
      acc[14] += diff * diff;
    }
    // block reduction: warp shuffles, then one partial per warp
#pragma unroll
    for (int i = 0; i < NSUM; ++i) {
      float v = acc[i];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) s_part[i][tid >> 5] = v;
    }
    __syncthreads();

    if (tid == 0) {
      float sum[NSUM];
      for (int i = 0; i < NSUM; ++i) {
        sum[i] = 0.0f;
        for (int w = 0; w < WARPS; ++w) sum[i] += s_part[i][w];
      }
      float H[4][4], b[4], upd[4];
      int q = 0;
      for (int i = 0; i < 4; ++i)
        for (int j = i; j < 4; ++j) H[i][j] = H[j][i] = sum[q++];
      for (int i = 0; i < 4; ++i) {
        H[i][i] += 1e-6f;
        b[i] = sum[10 + i];
      }
      solve4(H, b, upd);
      // se2 := se2 o (cos dth, sin dth, -upd0, -upd1), dth = -upd2
      const float dth = -upd[2];
      const float cu = cosf(dth), su = sinf(dth);
      s_state[0] = c * cu - s * su;
      s_state[1] = s * cu + c * su;
      s_state[2] = c * (-upd[0]) - s * (-upd[1]) + tx;
      s_state[3] = s * (-upd[0]) + c * (-upd[1]) + ty;
      s_state[4] = mo - upd[3];
      s_state[5] = sum[14];
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) se2_out[cam * 4 + i] = s_state[i];
    score_out[cam] = s_state[5];
  }
}

}  // namespace

// cur, tgt, tgx, tgy: (C,30,40) f32; se2: (C,4) f32 (cos, sin, tx, ty);
// score: (C,) f32.  Returns a cudaError_t.
extern "C" int mcptam_esm_align_all(const float* cur, const float* tgt,
                                    const float* tgx, const float* tgy,
                                    float* se2, float* score, int C,
                                    int n_iterations, cudaStream_t stream) {
  if (C == 0) return cudaSuccess;
  esm_kernel<<<C, THREADS, 0, stream>>>(cur, tgt, tgx, tgy, se2, score,
                                        n_iterations);
  return cudaGetLastError();
}
