// ESM alignment of the 30x40 small blurry images for Hopper: all
// Gauss-Newton iterations of every camera in one launch.
//
// Replaces: mcptam_tpu/ops/sbi_pallas.py::_esm_kernel with _esm_one and
// _solve4 (via esm_align_all).
// Plain version: mcptam_tpu_torch/ops/sbi.py::esm_align.
//
// What bounds it on the H100: latency.  A camera's working set is four
// 1200-pixel images (19 KB) and an iteration is ~40 flops a pixel, so the
// whole problem is microseconds of arithmetic; the plain version spends
// its time in the ~25 dependent small launches an iteration takes.  In
// the kernel each iteration waits on the last one's 4x4 solve, so what
// costs is the chain: warp, accumulate, reduce, solve, with two warps a
// scheduler to hide its latencies.
//
// Design: one block per camera keeps the current image in shared memory
// for all iterations, ONE block barrier an iteration.
// * Each warp owns a band of 4 image rows.  It warps them (a direct
//   bilinear read of the current image, not the TPU kernel's hat-matrix
//   product) into the warped image in shared memory and accumulates the
//   inner pixels of its band.  The rows above and below its band come from
//   its two neighbours, so it meets each of them at a named barrier of two
//   warps, never the whole block: every row is warped once (a warp that
//   warped its two halo rows itself warped 2 rows more for every 3.5 and
//   measured slower).  Named barriers 1..15 allow at most 16 warps.
//   A lane's sample slots and inner pixels are fixed, with their
//   coordinates, target values and gradients in registers: no div/mod in
//   the loop.
// * The 15 normal-equation sums of a warp are reduced by a butterfly that
//   halves the values at each step (16 shuffles, not 15 x 5); lane 2q
//   writes the warp's sum q to a partial buffer chosen by the iteration's
//   parity, so the next iteration's writes need no second barrier.
// * After the barrier every warp runs the tail itself: lane q < 15 adds
//   partial q over the warps in order, shuffles broadcast the sums, and
//   every lane solves the 4x4 system (unrolled L D L^T: no square root,
//   one division a pivot) and composes the SE2 update on identical inputs
//   in identical order, so every thread holds the same state in registers
//   and none waits for a tail thread.
// The TPU layout tricks (flat (N,1) columns, pre-transposed template, f32
// mask shifts) were Mosaic workarounds and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 30;
constexpr int COLS = 40;
constexpr int N = ROWS * COLS;
constexpr int INNER_ROWS = ROWS - 2, INNER_COLS = COLS - 2;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BAND = (ROWS + WARPS - 1) / WARPS;              // image rows a warp warps
constexpr int SLOTS = (BAND * COLS + 31) / 32;                 // samples a lane
constexpr int PIX = (BAND * INNER_COLS + 31) / 32;             // inner pixels a lane
static_assert(WARPS <= 16, "a neighbour pair per named barrier 1..15");
constexpr int NSUM = 15;  // 10 entries of H, 4 of b, the score
constexpr float CX = 20.0f;
constexpr float CY = 15.0f;
constexpr float TWO23 = 8388608.0f;
constexpr unsigned FULL = 0xffffffffu;

// unrolled 4x4 solve by H = L D L^T (L unit lower): the same solution as
// the TPU kernel's Cholesky, its pivot floor as D_j = max(d_j, 1e-20)
// (its L_jj^2), with no square root and one division a pivot (its
// reciprocal) on the chain; W_ij = L_ij D_j
__device__ __forceinline__ void solve4(const float H[4][4], const float b[4], float x[4]) {
  float L[4][4], W[4][4], r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= W[i][k] * L[j][k];
      W[i][j] = s;
      L[i][j] = s * r[j];
    }
    float d = H[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k) d -= W[i][k] * L[i][k];
    r[i] = 1.0f / fmaxf(d, 1e-20f);
  }
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float s = y[i] * r[i];
#pragma unroll
    for (int k = i + 1; k < 4; ++k) s -= L[k][i] * x[k];
    x[i] = s;
  }
}

// warped[p] = cur[R (p - centre) + centre + t] at pixel (xs, ys), bilinear,
// coordinates clamped to the image as the reference's hat weights are;
// *valid: the unclamped source lies inside the image
__device__ __forceinline__ float warp_at(const float* s_cur, float c, float s, float tx,
                                         float ty, float xs, float ys, bool* valid) {
  const float xr = c * (xs - CX) - s * (ys - CY) + CX + tx;
  const float yr = s * (xs - CX) + c * (ys - CY) + CY + ty;
  const float xf = fminf(fmaxf(xr, 0.0f), COLS - 1.0f);
  const float yf = fminf(fmaxf(yr, 0.0f), ROWS - 1.0f);
  // floor(xf) as a sum rounded down (exact for 0 <= xf < 2^23) and the
  // pixel index from the bits of 2^23 + index: the same values as
  // min((int)floorf(xf), COLS - 2) and yi * COLS + xi, without the
  // quarter-rate conversion instructions
  const float fx = fminf(__fadd_rd(xf, TWO23) - TWO23, COLS - 2.0f);
  const float fy = fminf(__fadd_rd(yf, TWO23) - TWO23, ROWS - 2.0f);
  const float wx = xf - fx, wy = yf - fy;
  const float* p = s_cur + (__float_as_int(fy * COLS + fx + TWO23) - __float_as_int(TWO23));
  *valid = xr >= 0.0f && xr <= COLS - 2.0f && yr >= 0.0f && yr <= ROWS - 2.0f;
  return (1.0f - wy) * ((1.0f - wx) * p[0] + wx * p[1]) +
         wy * ((1.0f - wx) * p[COLS] + wx * p[COLS + 1]);
}

// one butterfly step over 2H values: lanes with bit 2H set keep the upper
// half, the others the lower, each adding its partner's copy of it
template <int H>
__device__ __forceinline__ void fold(float* acc, int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float keep = up ? acc[k + H] : acc[k];
    const float send = up ? acc[k] : acc[k + H];
    acc[k] = keep + __shfl_xor_sync(FULL, send, 2 * H);
  }
}

__global__ void __launch_bounds__(THREADS)
esm_kernel(const float* __restrict__ cur, const float* __restrict__ tgt,
           const float* __restrict__ tgx, const float* __restrict__ tgy,
           float* __restrict__ se2_out, float* __restrict__ score_out,
           int n_iterations) {
  __shared__ float s_cur[N];
  // the warped image by bands, each padded to whole slots so that every
  // slot stores unconditionally: row y at (y / BAND) 32 SLOTS + (y % BAND)
  // COLS.  A sample whose source lies outside the image is stored as
  // -inf: the current image is finite (a blurred template), so no valid
  // sample takes that value and no separate validity mask is kept.
  __shared__ float s_warp[WARPS * 32 * SLOTS];
  __shared__ float s_part[2][NSUM][WARPS];                     // by iteration parity

  const int cam = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)cam * N;
  for (int n = tid; n < N; n += THREADS) s_cur[n] = cur[off + n];

  // this warp's band: image rows r0..r0+BAND-1 (the last warp's may end
  // past the image), whose inner pixels it accumulates
  const int r0 = BAND * warp;
  const int pr0 = max(r0, 1), pr1 = min(r0 + BAND, ROWS - 1);
  const int n_pix = max(pr1 - pr0, 0) * INNER_COLS;
  float sx[SLOTS], sy[SLOTS];            // a lane's sample slots e = lane + 32 i
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e = lane + 32 * i;
    sx[i] = (float)(e % COLS);
    sy[i] = (float)(r0 + e / COLS);
  }
  float px[PIX], py[PIX], t_tgt[PIX], t_gx[PIX], t_gy[PIX];
  int pb[PIX], pu[PIX], pd[PIX];         // the pixel's, its upper and lower neighbour's slot
  const auto slot = [](int y, int x) { return (y / BAND) * 32 * SLOTS + (y % BAND) * COLS + x; };
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int p = lane + 32 * q;
    const bool in = p < n_pix;
    const int x = in ? 1 + p % INNER_COLS : 1, y = in ? pr0 + p / INNER_COLS : 1;
    px[q] = (float)x;
    py[q] = (float)y;
    pb[q] = slot(y, x);
    pu[q] = slot(y - 1, x);
    pd[q] = slot(y + 1, x);
    t_tgt[q] = tgt[off + y * COLS + x];
    t_gx[q] = tgx[off + y * COLS + x];
    t_gy[q] = tgy[off + y * COLS + x];
  }
  float* w_band = s_warp + 32 * SLOTS * warp;
  __syncthreads();

  // Both passes are straight-line code (no branch, no short-circuit, no
  // guarded store), so the compiler interleaves a lane's samples and
  // pixels: with two warps a scheduler, latency is hidden within a warp
  // or not at all.
  float c = 1.0f, s = 0.0f, tx = 0.0f, ty = 0.0f, mo = 0.0f, score = INFINITY;
  for (int it = 0; it < n_iterations; ++it) {
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {     // slots past the band read clamped pixels
      bool v;
      const float w = warp_at(s_cur, c, s, tx, ty, sx[i], sy[i], &v);
      w_band[lane + 32 * i] = v ? w : -INFINITY;
    }
    // the rows above and below come from the neighbouring warps: a
    // barrier with each (named, two warps), paired so that all pairs meet
    // in two rounds
    const bool odd = warp & 1;
    if (!odd && warp + 1 < WARPS) asm volatile("bar.sync %0, 64;" :: "r"(warp + 1));
    if (warp > 0) asm volatile("bar.sync %0, 64;" :: "r"(warp));
    if (odd && warp + 1 < WARPS) asm volatile("bar.sync %0, 64;" :: "r"(warp + 1));

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const float w0 = s_warp[pb[q]], wl = s_warp[pb[q] - 1], wr = s_warp[pb[q] + 1];
      const float wu = s_warp[pu[q]], wd = s_warp[pd[q]];
      // inner pixels whose warp source and 4 neighbours' sources are
      // valid; the others add exact zeros
      const bool ok = (lane + 32 * q < n_pix) & (w0 > -INFINITY) & (wl > -INFINITY) &
                      (wr > -INFINITY) & (wu > -INFINITY) & (wd > -INFINITY);
      const float gx = 0.25f * ((wr - wl) + t_gx[q]);
      const float gy = 0.25f * ((wd - wu) + t_gy[q]);
      const float j3 = -(py[q] - CY) * gx + (px[q] - CX) * gy;
      const float diff = ok ? w0 - t_tgt[q] + mo : 0.0f;
      const float J[4] = {ok ? gx : 0.0f, ok ? gy : 0.0f, ok ? j3 : 0.0f, ok ? 1.0f : 0.0f};
      int k = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = i; j < 4; ++j) acc[k++] += J[i] * J[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[10 + i] += J[i] * diff;
      acc[14] += diff * diff;
    }
    // butterfly over the warp: at each step a lane keeps half of its
    // values and adds its partner's copy; then lane l holds the warp's sum
    // of value l >> 1
    fold<8>(acc, lane);
    fold<4>(acc, lane);
    fold<2>(acc, lane);
    fold<1>(acc, lane);
    acc[0] += __shfl_xor_sync(FULL, acc[0], 1);
    float(*part)[WARPS] = s_part[it & 1];
    if ((lane & 1) == 0 && (lane >> 1) < NSUM) part[lane >> 1][warp] = acc[0];
    __syncthreads();

    // the tail, in every warp: lane q sums partial q over the warps
    float tot = 0.0f;
    if (lane < NSUM)
#pragma unroll
      for (int w = 0; w < WARPS; ++w) tot += part[lane][w];
    float sum[NSUM];
#pragma unroll
    for (int i = 0; i < NSUM; ++i) sum[i] = __shfl_sync(FULL, tot, i);
    float H[4][4], b[4], upd[4];
    int k = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = i; j < 4; ++j) H[i][j] = H[j][i] = sum[k++];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      H[i][i] += 1e-6f;
      b[i] = sum[10 + i];
    }
    solve4(H, b, upd);
    // se2 := se2 o (cos dth, sin dth, -upd0, -upd1), dth = -upd2
    const float dth = -upd[2];
    float cu, su;
    sincosf(dth, &su, &cu);
    const float c1 = c * cu - s * su;
    const float s1 = s * cu + c * su;
    tx = c * (-upd[0]) - s * (-upd[1]) + tx;
    ty = s * (-upd[0]) + c * (-upd[1]) + ty;
    c = c1;
    s = s1;
    mo = mo - upd[3];
    score = sum[14];
  }

  if (tid == 0) {
    se2_out[cam * 4 + 0] = c;
    se2_out[cam * 4 + 1] = s;
    se2_out[cam * 4 + 2] = tx;
    se2_out[cam * 4 + 3] = ty;
    score_out[cam] = score;
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
